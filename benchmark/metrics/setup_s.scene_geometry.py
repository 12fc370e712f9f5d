"""setup_s.scene_geometry: host seconds the run's process spent in the
program's `srt.scene_geometry` span (`Scene.rt_geometry`: the BVH order
and the packed trace arrays, once a scene and pipeline), from the
program's `span_totals()`."""

from harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, "srt.scene_geometry")
