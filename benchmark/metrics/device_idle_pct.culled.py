"""device_idle_pct.culled: share of the traced window in which no kernel,
copy or fill ran on the card, in the cells rated by
`mpaths_per_s.culled`."""

from harness import stats


def read(ctx):
    rec = ctx.trace
    return None if rec is None else stats.idle_pct(rec.busy_s(), rec.window_s)
