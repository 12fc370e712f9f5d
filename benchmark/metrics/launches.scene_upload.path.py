"""launches.scene_upload.path: host calls a frame that put work on the
card's queues (`cudaLaunch*`, `cuLaunch*`, `cudaMemcpy*`, `cudaMemset*`)
made inside the program's `srt.scene_upload` span
(`ops/intersect.prepare_rt_scene`), in the traced window of the cells
rated by `mpaths_per_s`. A count of work that the shared host's speed
does not move."""

from harness import spans


def read(ctx):
    return spans.enqueues_per_frame(ctx, "srt.scene_upload")
