"""Multi-device / multi-process rendering on `torch.distributed`: the port
of the JAX package's parallel/. The renderer's parallel axes are
sample-parallelism (spp, the renderer's "data parallel") and screen-tile
parallelism (the renderer's "spatial/context parallel")."""

from software_rasterizer_tpu_torch.parallel.jobs import TileJobRunner
from software_rasterizer_tpu_torch.parallel.mesh import RenderMesh, make_render_mesh
from software_rasterizer_tpu_torch.parallel.multihost import (
    gather_image,
    initialize,
    process_info,
)
from software_rasterizer_tpu_torch.parallel.render import (
    sharded_path_render,
    sharded_raster_render,
    sharded_whitted_render,
    sharded_whitted_render_exact,
)

__all__ = [
    "RenderMesh",
    "TileJobRunner",
    "gather_image",
    "initialize",
    "make_render_mesh",
    "process_info",
    "sharded_path_render",
    "sharded_raster_render",
    "sharded_whitted_render",
    "sharded_whitted_render_exact",
]
