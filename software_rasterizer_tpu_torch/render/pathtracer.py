"""PathTracing pipeline (reference: src/PathTracing.cpp).

draw(): per scene, transform to trace space (prepare_rt_scene) and run
the path integrator (ops/path.py), averaging `spp` samples per pixel
(PathTracing.cpp:62-88): the camera kernel, or, for a scene it cannot
shade exactly (a textured emitter), the wavefront integrator on the
camera's rays with its bounce kernel. The JAX package's `block` and
`chunk` arguments are not taken: both routes here run the whole frame in
one launch a sample batch, so neither would change a frame (`block`
bounds the plain wavefront, `ops.path.path_render(fused=False)`, which
this class never asks for; `chunk` sized an XLA triangle sweep).

Beyond the reference, the pipeline keeps a PROGRESSIVE ACCUMULATOR
(sum image + sample count) per scene: `accumulate()` adds sample
batches, `resolve()` divides once, and `save_checkpoint()` /
`load_checkpoint()` persist the running state in the JAX package's
`.npz` format, so a checkpoint written by either package loads in the
other. The RNG is keyed by absolute sample index, so a resumed or
batched render reproduces a monolithic one up to float32 summation
order. The sum image stays a device tensor between batches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from software_rasterizer_tpu_torch.models.scene import RTGeometry, Scene
from software_rasterizer_tpu_torch.ops.intersect import (
    RTScene,
    check_device,
    prepare_rt_scene,
)
from software_rasterizer_tpu_torch.ops.path import path_render, path_render_sum
from software_rasterizer_tpu_torch.render.pipeline import Primitive, RenderingPipeline


class PathTracing(RenderingPipeline):
    def __init__(self, width: int, height: int, spp: int = 16,
                 max_bounces: int = 16, seed: int = 0,
                 device="cuda"):
        super().__init__(width, height)
        self.spp = spp
        self.max_bounces = max_bounces
        self.seed = seed
        self.device = check_device(device)
        self._geom_cache: Dict[str, RTGeometry] = {}
        # progressive state per scene: (sum image (N,3) on device, n_samples)
        self._accum: Dict[str, Tuple[torch.Tensor, int]] = {}

    def set_spp(self, spp: int):
        """PathTracing::setSPP."""
        self.spp = spp

    def _geometry(self, scene: Scene) -> RTGeometry:
        g = self._geom_cache.get(scene.name)
        if g is None:
            g = scene.rt_geometry()
            self._geom_cache[scene.name] = g
        return g

    def invalidate(self, scene_name: Optional[str] = None):
        if scene_name is None:
            self._geom_cache.clear()
            self._accum.clear()
        else:
            self._geom_cache.pop(scene_name, None)
            self._accum.pop(scene_name, None)

    def _rt_scene(self, scene: Scene) -> RTScene:
        return prepare_rt_scene(self._geometry(scene), scene.rt_frame(),
                                self.device)

    def draw(self, primitive: Primitive = Primitive.TRIANGLES):
        if primitive not in (Primitive.LINES, Primitive.TRIANGLES):
            raise ValueError("Primitive Type is not supported!")
        for scene in self.scenes.values():
            rt = self._rt_scene(scene)
            img = path_render(rt, self.width, self.height, scene.fovy,
                              self.seed, spp=self.spp, p_rr=scene.rr,
                              max_bounces=self.max_bounces)
            self.frame = img.cpu().numpy()

    # -- progressive / resumable accumulation --------------------------------

    def accumulate(self, scene_name: str, n_samples: int):
        """Add `n_samples` fresh per-pixel samples to the running sum,
        with start_sample = samples done, by the route `draw()` takes."""
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
        acc, done = self._accum[scene_name]
        img = acc.cpu().numpy().reshape(self.height, self.width, 3) / max(done, 1)
        self.frame = img.astype(np.float32)
        return self.frame

    def save_checkpoint(self, scene_name: str, path: str):
        acc, done = self._accum[scene_name]
        np.savez(
            path, sum_image=acc.cpu().numpy(), n_samples=done,
            width=self.width, height=self.height, seed=self.seed,
        )

    def load_checkpoint(self, scene_name: str, path: str):
        z = np.load(path)
        if int(z["width"]) != self.width or int(z["height"]) != self.height:
            raise ValueError("checkpoint resolution mismatch")
        self.seed = int(z["seed"])
        self._accum[scene_name] = (
            torch.as_tensor(z["sum_image"].astype(np.float32), device=self.device),
            int(z["n_samples"]),
        )
