"""User-facing render pipelines (reference: include/base/Render.hpp,
include/render/PathTracing.hpp)."""

from software_rasterizer_tpu_torch.render.pipeline import (  # noqa: F401
    Buffers,
    Primitive,
    RenderingPipeline,
    pipeline_from_config,
)
from software_rasterizer_tpu_torch.render.pathtracer import PathTracing  # noqa: F401
