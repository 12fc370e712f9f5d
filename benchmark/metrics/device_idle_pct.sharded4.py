"""device_idle_pct.sharded4: share of the traced window in which no
kernel, copy or fill ran on card 0 (rank 0's card, the only one a traced
run profiles), in %. An NCCL kernel that waits for a slower rank counts
as busy. None without device events (a run on the CPU)."""

from harness import stats


def read(ctx):
    rec = ctx.trace
    if rec is None or not rec.device:
        return None
    return stats.idle_pct(rec.busy_s(), rec.window_s)
