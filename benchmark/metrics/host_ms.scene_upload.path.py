"""host_ms.scene_upload.path: host ms a frame inside the program's
`srt.scene_upload` span (`ops/intersect.prepare_rt_scene`), in the
traced window of the cells rated by `mpaths_per_s`."""

from harness import spans


def read(ctx):
    return spans.host_ms_per_frame(ctx, "srt.scene_upload")
