"""mpaths_per_s: million paths completed per second, width x height x spp
of every frame the window completed over the window's seconds (host
clock)."""

from harness import stats


def read(ctx):
    return stats.rate(ctx.frames * ctx.work_per_frame, ctx.window_s) / 1e6
