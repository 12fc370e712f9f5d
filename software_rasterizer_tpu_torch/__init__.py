"""software_rasterizer_tpu_torch — the PyTorch / CUDA port of
`software_rasterizer_tpu`.

The JAX package stays the reference; every module here keeps its
counterpart's path and names and is tested against it on the CPU.
Ported so far: the host scene layer and Cornell-box path tracing, whose
one kernel is a hand-written CUDA kernel (csrc/path_camera.cu).

Layout:
  models/    scene data model: meshes, spheres, materials, lights, Scene
  ops/       device scene, RNG-exact path kernel and its plain version
  render/    user-facing pipelines (PathTracing)
  utils/     host-side: transforms, OBJ/texture loaders, image IO, RNG
  csrc/      CUDA sources, built with nvcc at first use into _build/
"""

__version__ = "0.1.0"

from software_rasterizer_tpu_torch.config import RenderConfig  # noqa: F401
