"""path_camera_roofline: the least time the card could take for a
frame's path tracing, over `kernel_ms.path_camera`, in %. The work is
what the frame's inputs need under a brute-force tracer, counted by the
benchmark's reference on its sample of the frame's pixels and scaled to
the frame: every needed segment (camera rays, next-event shadow rays that
can add light, bounce rays of paths that go on) tested against every
triangle, 28 float32 operations a test and 30 more where stage 1 passes,
150 a segment for sampling and shading; the bytes are each triangle's
rows read once and the image written once. Bound by operations. Never
from a kernel's own tally, so a kernel that culls better does not move
its own yardstick."""

from harness import stats
from harness.trace import named


def read(ctx):
    rec, c = ctx.trace, ctx.counts
    if rec is None or not {"tests", "stage1_passes", "segments"} <= set(c):
        return None
    kernel_ms = rec.kernel_ms_per_frame(named("path_camera_kernel<false>"))
    if kernel_ms is None:
        return None
    ops = stats.brute_force_ops(c["tests"], c["stage1_passes"], c["segments"])
    least, _ = stats.least_ms(ops, ctx.min_bytes)
    return 100.0 * least / kernel_ms
