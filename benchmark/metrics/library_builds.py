"""library_builds: libraries the run's process built
(`utils/cuda_build.BUILDS`: nvcc's CUDA libraries and g++'s host
library). 0 where the checkout's `_build/` already holds them; a changed
source or a cold checkout shows here."""

from harness import spans


def read(ctx):
    return spans.library_builds(ctx)
