"""TraditionalRasterizer pipeline (reference: src/Rasterizer.cpp).

Each draw(): flatten the scene's per-frame matrices (host, tiny), upload
them in one copy and run the device raster step (ops/raster.py). The
geometry bundle is uploaded once per scene and cached, so the
animated-rotation loop (main.cpp:113-175) re-runs only the device step
with fresh matrices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from software_rasterizer_tpu_torch.models.scene import Scene
from software_rasterizer_tpu_torch.ops.intersect import check_device
from software_rasterizer_tpu_torch.ops.lines import rasterize_wireframe
from software_rasterizer_tpu_torch.ops.raster import (
    DeviceRasterGeometry,
    prepare_raster_frames,
    prepare_raster_geometry,
    render_raster_frame,
)
from software_rasterizer_tpu_torch.ops.raster_kernel import TILE_H, TILE_W
from software_rasterizer_tpu_torch.render.pipeline import Primitive, RenderingPipeline


class TraditionalRasterizer(RenderingPipeline):
    """`tile` is the tile kernels' (rows, cols) block of pixels; `shaded`
    (also an attribute, read at every draw) asks for the tile kernel with
    in-kernel Blinn-Phong where the scene's shaders allow it
    (ops/raster.shaded_kernel_applies), else the deferred-shading kernel
    runs."""

    def __init__(self, width: int, height: int,
                 tile: Tuple[int, int] = (TILE_H, TILE_W),
                 shaded: bool = False, device="cuda"):
        super().__init__(width, height)
        self.tile = tuple(tile)
        self.shaded = bool(shaded)
        self.device = check_device(device)
        self._geom_cache: Dict[str, Tuple[DeviceRasterGeometry, tuple]] = {}
        self._geom_rev: Dict[str, int] = {}
        #: per-scene stats of the last draw() or draw_batch():
        #: {scene_name: {"bin_dropped": triangles beyond the per-tile list
        #: cap (an int after draw(); a 0-d device tensor summed over the
        #: frames after draw_batch(), which never waits for the device),
        #: "kernel": the tile kernel that ran}}
        self.last_stats: Optional[Dict[str, dict]] = None

    def invalidate(self, scene_name: Optional[str] = None):
        """Drop cached geometry (call after adding/removing meshes or
        rebinding shaders)."""
        if scene_name is None:
            self._geom_cache.clear()
        else:
            self._geom_cache.pop(scene_name, None)

    def _geometry(self, scene: Scene):
        entry = self._geom_cache.get(scene.name)
        if entry is None or self._geom_rev.get(scene.name) != len(scene.meshes()):
            g = scene.raster_geometry()
            active = tuple(sorted(set(int(t) for t in g.shader_type)))
            entry = (prepare_raster_geometry(g, self.device), active)
            self._geom_cache[scene.name] = entry
            self._geom_rev[scene.name] = len(scene.meshes())
        return entry

    def _render(self, geom, active, frame):
        return render_raster_frame(
            geom, frame, self.height, self.width, tile=self.tile,
            active_types=active, with_stats=True, shaded=self.shaded)

    def draw_batch(self, scene: Scene, frames):
        """Render K frames of one scene without waiting for the device
        between them.

        `frames`: list of `RasterFrame` bundles (scene.raster_frame()
        captured after each per-frame matrix update, the batched analog
        of the reference's rotate-then-draw loop, main.cpp:113-175).
        Returns (images (K,H,W,3) f32, zbufs (K,H,W) f32) as device
        tensors. The K frames go up in one copy and every frame runs the
        same device step as draw(), so each (image, zbuf) pair is
        bit-identical to a draw() of the same matrices."""
        geom, active = self._geometry(scene)
        images, zbufs, dropped, kernel = [], [], 0, None
        for frame in prepare_raster_frames(frames, self.device):
            image, zbuf, stats = self._render(geom, active, frame)
            images.append(image)
            zbufs.append(zbuf)
            dropped = dropped + stats["bin_dropped"]
            kernel = stats["kernel"]
        self.last_stats = {scene.name: {"bin_dropped": dropped, "kernel": kernel}}
        return torch.stack(images), torch.stack(zbufs)

    def draw(self, primitive: Primitive = Primitive.TRIANGLES):
        if primitive not in (Primitive.LINES, Primitive.TRIANGLES):
            raise ValueError("Primitive Type is not supported!")
        self.last_stats = {}
        for scene in self.scenes.values():
            geom, active = self._geometry(scene)
            frame = scene.raster_frame()
            if primitive == Primitive.TRIANGLES:
                image, zbuf, stats = self._render(geom, active, frame)
                self.last_stats[scene.name] = {
                    "bin_dropped": int(stats["bin_dropped"]),
                    "kernel": stats["kernel"]}
            else:
                image, zbuf = rasterize_wireframe(
                    geom, frame, self.height, self.width)
            image = image.cpu().numpy()
            zbuf = zbuf.cpu().numpy()
            # multi-scene composition via shared z-buffer (Render.hpp:250-257)
            nearer = zbuf < self.zbuffer
            self.frame = np.where(nearer[..., None], image, self.frame)
            self.zbuffer = np.minimum(zbuf, self.zbuffer)
