"""frame_ms_p95: the 95th percentile (nearest rank) of every frame's wall
time in the window, host clock, from the request of the frame to its
host image."""

from harness import stats


def read(ctx):
    return stats.percentile(ctx.frame_ms, 95.0)
