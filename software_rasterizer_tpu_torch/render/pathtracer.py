"""PathTracing pipeline (reference: src/PathTracing.cpp).

draw(): per scene, transform to trace space (prepare_rt_scene) and run
the path integrator (ops/path.py), averaging `spp` samples per pixel
(PathTracing.cpp:62-88): the camera kernel (above 512 triangles its
chunk-culled walk), or, for a scene it cannot shade exactly (a textured
emitter), the wavefront integrator on the camera's rays with its bounce
kernel. The constructor takes the JAX package's arguments in its order,
`block` and `chunk` among them, and keeps them without reading them: both
routes here run the whole frame in one launch a sample batch, so neither
would change a frame (`block` bounds the plain wavefront,
`ops.path.path_render(fused=False)`, which this class never asks for;
`chunk` sized an XLA triangle sweep).

Beyond the reference, the pipeline keeps a PROGRESSIVE ACCUMULATOR
(sum image + sample count) per scene: `accumulate()` adds sample
batches, `resolve()` divides once, and `save_checkpoint()` /
`load_checkpoint()` persist the running state in the JAX package's
`.npz` format, so a checkpoint written by either package loads in the
other. The RNG is keyed by absolute sample index, so a resumed or
batched render reproduces a monolithic one up to float32 summation
order. The sum image stays a device tensor between batches.

WHERE THE SCENE LIVES: the scene's geometry goes up to the device once,
at its first draw, as a `DeviceRTGeometry` that the pipeline base keeps
(`RenderingPipeline._geometry`) until `invalidate()`, which drops the
scene's accumulator too. Every draw and `accumulate()` uploads only the
frame's matrices, eye and background and builds the trace-space scene
from them on the device (`prepare_rt_scene`), so a scene turned between
draws is traced as it stands.

SAMPLE-PARALLEL: given a `mesh` (`parallel.make_render_mesh`) of more
than one rank, `draw()` renders each scene through
`parallel.sharded_path_render`: every rank calls `draw()` with the same
seed (SPMD), each spp rank draws `spp / n_spp` of the frame's samples,
keyed by absolute sample index, one all-reduce sums them, and every rank
reads back the whole frame. With one spp rank the frame equals the
single-rank draw bit for bit, with more up to the order of the sum. The
accumulator stays single-rank: `accumulate()`, `resolve()` and the
checkpoints raise on such a mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from software_rasterizer_tpu_torch.models.scene import Scene
from software_rasterizer_tpu_torch.ops.intersect import (
    DeviceRTGeometry,
    RTScene,
    check_device,
    prepare_rt_geometry,
    prepare_rt_scene,
)
from software_rasterizer_tpu_torch.ops.path import path_render, path_render_sum
from software_rasterizer_tpu_torch.parallel.mesh import RenderMesh
from software_rasterizer_tpu_torch.parallel.render import sharded_path_render
from software_rasterizer_tpu_torch.render.pipeline import (
    Primitive,
    RenderingPipeline,
    readback,
)
from software_rasterizer_tpu_torch.utils.debug import nan_check
from software_rasterizer_tpu_torch.utils.profiling import span


class PathTracing(RenderingPipeline):
    def __init__(self, width: int, height: int, spp: int = 16,
                 max_bounces: int = 16, block: int = 1 << 16,
                 chunk: int = 512, seed: int = 0, device="cuda", *,
                 mesh: Optional[RenderMesh] = None):
        super().__init__(width, height)
        self.spp = spp
        self.max_bounces = max_bounces
        self.block = block    # the JAX package's; not read (module docstring)
        self.chunk = chunk
        self.seed = seed
        self.device = check_device(device)
        self.mesh = mesh
        # progressive state per scene: (sum image (N,3) on device, n_samples)
        self._accum: Dict[str, Tuple[torch.Tensor, int]] = self._per_scene()

    @property
    def sharded(self) -> bool:
        """Whether draw() renders over a mesh of more than one rank."""
        return self.mesh is not None and self.mesh.n_devices > 1

    def set_spp(self, spp: int):
        """PathTracing::setSPP."""
        self.spp = spp

    def _device_geometry(self, scene: Scene) -> DeviceRTGeometry:
        return prepare_rt_geometry(scene.rt_geometry(), self.device)

    def _rt_scene(self, scene: Scene) -> RTScene:
        return prepare_rt_scene(self._geometry(scene), scene.rt_frame(),
                                self.device)

    @span("srt.draw")
    def draw(self, primitive: Primitive = Primitive.TRIANGLES):
        if primitive not in (Primitive.LINES, Primitive.TRIANGLES):
            raise ValueError("Primitive Type is not supported!")
        for scene in self.scenes.values():
            rt = self._rt_scene(scene)
            if not self.sharded:
                img = path_render(rt, self.width, self.height, scene.fovy,
                                  self.seed, spp=self.spp, p_rr=scene.rr,
                                  max_bounces=self.max_bounces)
            else:
                img = sharded_path_render(
                    rt, self.mesh, self.width, self.height, scene.fovy,
                    self.seed, spp=self.spp, p_rr=scene.rr,
                    max_bounces=self.max_bounces)
            with span("srt.readback"):
                self.frame = readback(nan_check("PathTracing.draw", img))

    # -- progressive / resumable accumulation --------------------------------

    def _single_rank(self, what: str):
        if self.sharded:
            raise ValueError(f"PathTracing.{what} renders on one rank; this "
                             f"pipeline has a {self.mesh.n_spp}x{self.mesh.n_tile} mesh")

    def accumulate(self, scene_name: str, n_samples: int):
        """Add `n_samples` fresh per-pixel samples to the running sum,
        with start_sample = samples done, by the route `draw()` takes."""
        self._single_rank("accumulate")
        scene = self.scenes[scene_name]
        rt = self._rt_scene(scene)
        acc, done = self._accum.get(scene_name, (None, 0))
        if acc is None:
            acc = torch.zeros((self.width * self.height, 3),
                              dtype=torch.float32, device=self.device)
        acc = acc + path_render_sum(
            rt, self.width, self.height, scene.fovy, self.seed, done,
            n_samples, p_rr=scene.rr, max_bounces=self.max_bounces)
        self._accum[scene_name] = (acc, done + n_samples)

    def samples_done(self, scene_name: str) -> int:
        return self._accum.get(scene_name, (None, 0))[1]

    def resolve(self, scene_name: str) -> np.ndarray:
        """Current mean image from the accumulator; also sets self.frame."""
        self._single_rank("resolve")
        acc, done = self._accum[scene_name]
        img = acc.cpu().numpy().reshape(self.height, self.width, 3) / max(done, 1)
        self.frame = img.astype(np.float32)
        return self.frame

    def save_checkpoint(self, scene_name: str, path: str):
        self._single_rank("save_checkpoint")
        acc, done = self._accum[scene_name]
        np.savez(
            path, sum_image=acc.cpu().numpy(), n_samples=done,
            width=self.width, height=self.height, seed=self.seed,
        )

    def load_checkpoint(self, scene_name: str, path: str):
        self._single_rank("load_checkpoint")
        z = np.load(path)
        if int(z["width"]) != self.width or int(z["height"]) != self.height:
            raise ValueError("checkpoint resolution mismatch")
        self.seed = int(z["seed"])
        self._accum[scene_name] = (
            torch.as_tensor(z["sum_image"].astype(np.float32), device=self.device),
            int(z["n_samples"]),
        )
