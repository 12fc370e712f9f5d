"""setup_s.libraries: host seconds the run's process spent in the program's
`srt.load_library` span (`utils/cuda_build.load_library` for a library
not loaded yet: nvcc's build where the checkout has none, then the
load), from the program's `span_totals()`. Libraries load in set-up;
every later launch finds its library loaded."""

from harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, "srt.load_library")
