"""software_rasterizer_tpu_torch — the PyTorch / CUDA port of
`software_rasterizer_tpu`.

The JAX package stays the reference; every module here keeps its
counterpart's path and names and is tested against it on the CPU.
Ported so far: the host scene layer, Cornell-box path tracing and
one-emitter Whitted ray tracing; each runs one hand-written CUDA kernel
(csrc/path_camera.cu, csrc/whitted_uber.cu).

Layout:
  models/    scene data model: meshes, spheres, materials, lights, Scene
  ops/       device scene, optics, the path and Whitted kernels' wrappers
             and their plain versions
  render/    user-facing pipelines (PathTracing, RayTracing)
  utils/     host-side: transforms, OBJ/texture loaders, image IO, RNG
  csrc/      CUDA sources, built with nvcc at first use into _build/
"""

__version__ = "0.1.0"

from software_rasterizer_tpu_torch.config import RenderConfig  # noqa: F401
