"""idle_ms.scene_upload.culled: ms a frame of the traced window in which
the card ran no kernel, copy or fill while the host was inside the
program's `srt.scene_upload` span (`ops/intersect.prepare_rt_scene`: the
scene's tables made on the card anew each draw), in the cells rated by
`mpaths_per_s.culled`. Each idle stretch is split exactly among the
frame's stages (`harness/spans.py`), so the five `idle_ms.*` of a cell
sum to the window's idle time a frame."""

from harness import spans


def read(ctx):
    return spans.idle_ms_per_frame(ctx, "scene_upload")
