"""kernel_ms.whitted_uber: device ms a frame of the Whitted kernel
(`csrc/whitted_uber.cu`, `whitted_uber_kernel`), by name from the trace."""

from harness.trace import named


def read(ctx):
    rec = ctx.trace
    return None if rec is None else rec.kernel_ms_per_frame(named("whitted_uber_kernel"))
