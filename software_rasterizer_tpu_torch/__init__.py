"""software_rasterizer_tpu_torch — the PyTorch / CUDA port of
`software_rasterizer_tpu`.

The JAX package stays the reference; every module here keeps its
counterpart's path and names and is tested against it on the CPU. The
port does all that the JAX package does: the host scene layer, the three
pipelines on hand-written CUDA kernels (path tracing with the camera and
bounce kernels, Whitted ray tracing with any number of emitters, the
rasterizer's two tile kernels), the explicit-ray layer and its trace
tiers for large scenes, sharding over `torch.distributed`, and the host
utilities. Everything runs on the card unless the caller asks for
device="cpu".

Layout:
  models/    scene data model: meshes, spheres, materials, lights, Scene
  ops/       device scene, optics, shaders, BVH, the raster stages, the
             explicit-ray layer and trace tiers, and the kernels'
             wrappers with their plain versions
  render/    user-facing pipelines (PathTracing, RayTracing,
             TraditionalRasterizer)
  parallel/  sharded renders over a ("spp", "tile") mesh of ranks,
             multi-process setup, restartable tile jobs
  scenes/    the Cornell box, mesh tessellation for scenes of real size
  utils/     host-side: transforms, OBJ/texture loaders, image IO, RNG,
             the native host library (native.py), metrics, debug
             checks, profiling, the CUDA build
  examples/  runnable entry points (cornell_pt)
  csrc/      CUDA sources, built with nvcc at first use into _build/, and
             the host library's C++ source, built there with g++
"""

__version__ = "0.1.0"

from software_rasterizer_tpu_torch.config import RenderConfig  # noqa: F401
