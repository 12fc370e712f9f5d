"""idle_ms.path_tables.culled: ms a frame of the traced window in which the
card ran no kernel, copy or fill while the host was inside the program's
`srt.path_tables` or `srt.launch.path_camera` span
(`ops/path_kernel.path_camera_render`: the kernel's operand tables, the
sample seeds' upload, the operand checks and the launch), in the cells
rated by `mpaths_per_s.culled`. Each idle stretch is split exactly among
the frame's stages (`harness/spans.py`), so the five `idle_ms.*` of a
cell sum to the window's idle time a frame."""

from harness import spans


def read(ctx):
    return spans.idle_ms_per_frame(ctx, "path_tables")
