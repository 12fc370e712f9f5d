"""frame_ms_p95.path: the 95th percentile (nearest rank) of every frame's
wall time in the traced run's window, host clock, from the request of the
frame to its host image, in the cells rated by `mpaths_per_s`. A host-bound
frame's tail swings with the shared host from run to run, so it is read
here, beside the rate, and not held to a bound."""

from harness import stats


def read(ctx):
    return stats.percentile(ctx.frame_ms, 95.0)
