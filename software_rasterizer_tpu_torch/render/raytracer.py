"""RayTracing pipeline (reference: src/RayTracing.cpp).

draw(): per scene, transform to trace space (prepare_rt_scene) and run
the Whitted integrator over the full framebuffer (ops/whitted.py). The
kernel walks every pixel's whole recursion tree, so no ray is dropped;
the per-frame stats (dropped_rays, rays_main, rays_shadow) are surfaced
on `self.last_stats` as in the JAX package. The pipeline keeps a key and
splits it for every scene it draws, as the JAX package does, so two
draws of a scene with several emitters pick their emitters anew.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from software_rasterizer_tpu_torch.models.scene import RTGeometry, Scene
from software_rasterizer_tpu_torch.ops.intersect import check_device, prepare_rt_scene
from software_rasterizer_tpu_torch.ops.whitted import whitted_render_exact
from software_rasterizer_tpu_torch.render.pipeline import Primitive, RenderingPipeline
from software_rasterizer_tpu_torch.utils.debug import nan_check
from software_rasterizer_tpu_torch.utils.rng import prng_key, split


class RayTracing(RenderingPipeline):
    """The JAX class's arguments in its order; `block` and `chunk` (the
    JAX integrator's lane block and triangle chunk) are kept and not read:
    the kernel walks every pixel's tree whole and picks its own chunks."""

    def __init__(self, width: int, height: int, spp: int = 1,
                 max_depth: int = 5, block: int = 8192, chunk: int = 512,
                 seed: int = 0, device="cuda"):
        super().__init__(width, height)
        self.spp = spp
        self.max_depth = max_depth
        self.block = block
        self.chunk = chunk
        self.seed = seed
        self.key = prng_key(seed)
        self.device = check_device(device)
        self._geom_cache: Dict[str, RTGeometry] = {}
        #: per-scene integrator stats of the last draw() —
        #: {scene_name: {"dropped_rays": 0, "rays_main": int,
        #:  "rays_shadow": int}}
        self.last_stats: Optional[Dict[str, dict]] = None

    def set_spp(self, spp: int):
        self.spp = spp

    def _geometry(self, scene: Scene) -> RTGeometry:
        g = self._geom_cache.get(scene.name)
        if g is None:
            g = scene.rt_geometry()
            self._geom_cache[scene.name] = g
        return g

    def invalidate(self, scene_name=None):
        if scene_name is None:
            self._geom_cache.clear()
        else:
            self._geom_cache.pop(scene_name, None)

    def draw(self, primitive: Primitive = Primitive.TRIANGLES):
        if primitive not in (Primitive.LINES, Primitive.TRIANGLES):
            raise ValueError("Primitive Type is not supported!")
        self.last_stats = {}
        for scene in self.scenes.values():
            rt = prepare_rt_scene(self._geometry(scene), scene.rt_frame(),
                                  self.device)
            # the recursion cap is the scene's, not self.max_depth, as in
            # the JAX package's RayTracing.draw
            self.key, sub = split(self.key)
            img, stats = whitted_render_exact(
                rt, self.width, self.height, scene.fovy, sub,
                spp=self.spp, max_depth=scene.max_depth, return_stats=True)
            self.last_stats[scene.name] = {
                k: int(stats[k])
                for k in ("dropped_rays", "rays_main", "rays_shadow")
            }
            img = nan_check("RayTracing.draw", img)
            self.frame = np.array(img.cpu().numpy())  # writable copy
