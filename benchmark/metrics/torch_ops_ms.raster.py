"""torch_ops_ms.raster: device ms a frame of every kernel that is not one
of the raster path's hand-written kernels (`csrc/raster_tiles.cu`:
`coarse_bin_kernel`, `raster_tile_kernel`): PyTorch's own kernels, those
of the vertex stage and setup (`ops/raster.raster_tables`), the deferred
shading (`shade_deferred`) and the texel terms."""

from harness.trace import named

OWN = named("coarse_bin_kernel", "raster_tile_kernel")


def read(ctx):
    rec = ctx.trace
    return None if rec is None else rec.kernel_ms_per_frame(lambda n: not OWN(n))
