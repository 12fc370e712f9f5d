"""User-facing render pipelines (reference: include/base/Render.hpp,
include/render/PathTracing.hpp, include/render/RayTracing.hpp)."""

from software_rasterizer_tpu_torch.render.pipeline import (  # noqa: F401
    Buffers,
    Primitive,
    RenderingPipeline,
    pipeline_from_config,
)
from software_rasterizer_tpu_torch.render.pathtracer import PathTracing  # noqa: F401
from software_rasterizer_tpu_torch.render.raytracer import RayTracing  # noqa: F401
from software_rasterizer_tpu_torch.render.rasterizer import TraditionalRasterizer  # noqa: F401
