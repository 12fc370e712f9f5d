"""kernel_ms.path_camera_culled: device ms a frame of the path camera
kernel's culled walk (`csrc/path_camera.cu`, `path_camera_kernel<true>`,
#1b), by name from the trace."""

from harness.trace import named


def read(ctx):
    rec = ctx.trace
    return None if rec is None else rec.kernel_ms_per_frame(named("path_camera_kernel<true>"))
