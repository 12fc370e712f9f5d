"""device_idle_pct.frames: share of the traced window in which no kernel,
copy or fill ran on the card (one minus the union of the profiler's
device intervals over the window), in the cells rated in frames a second."""

from harness import stats


def read(ctx):
    rec = ctx.trace
    return None if rec is None else stats.idle_pct(rec.busy_s(), rec.window_s)
