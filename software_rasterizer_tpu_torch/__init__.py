"""software_rasterizer_tpu_torch — the PyTorch / CUDA port of
`software_rasterizer_tpu`.

The JAX package stays the reference; every module here keeps its
counterpart's path and names and is tested against it on the CPU.
Ported so far: the host scene layer and all three pipelines, each on
hand-written CUDA kernels: Cornell-box path tracing (csrc/path_camera.cu),
one-emitter Whitted ray tracing (csrc/whitted_uber.cu) and the rasterizer
(csrc/raster_tiles.cu, two tile kernels). The pipelines run on the card
unless the caller asks for device="cpu".

Layout:
  models/    scene data model: meshes, spheres, materials, lights, Scene
  ops/       device scene, optics, shaders, the raster stages, and the
             path, Whitted and raster kernels' wrappers with their plain
             versions
  render/    user-facing pipelines (PathTracing, RayTracing,
             TraditionalRasterizer)
  scenes/    the Cornell box, mesh tessellation for scenes of real size
  utils/     host-side: transforms, OBJ/texture loaders, image IO, RNG
  csrc/      CUDA sources, built with nvcc at first use into _build/
"""

__version__ = "0.1.0"

from software_rasterizer_tpu_torch.config import RenderConfig  # noqa: F401
