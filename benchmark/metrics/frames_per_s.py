"""frames_per_s: frames completed per second over the whole window (host
clock)."""

from harness import stats


def read(ctx):
    return stats.rate(ctx.frames, ctx.window_s)
