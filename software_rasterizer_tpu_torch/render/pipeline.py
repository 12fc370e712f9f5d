"""RenderingPipeline base (reference: src/Render.cpp, include/base/Render.hpp).

The reference pipeline owns planar float channels + a z-buffer and a GUI
display loop. Here `display()` runs the device pipeline and returns the
frame as a numpy image; `save()` writes PNG. Framebuffer clear semantics
match Render.cpp:31-55 (color -> 0, z -> +inf). Every pipeline's `draw()`
reads its frame back to the host through `readback`.

The base owns where each scene's geometry lives: `_geometry(scene)`
uploads it to the pipeline's device at the scene's first draw and keeps
it until `invalidate()`, so a later draw uploads only its frame's
matrices. A pipeline says only how its geometry is built
(`_device_geometry`) and, where it has one, what else makes it stale
(`_geometry_revision`).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

import numpy as np
import torch

from software_rasterizer_tpu_torch.models.scene import Scene
from software_rasterizer_tpu_torch.utils.image_io import to_u8, write_png


class Primitive(enum.IntEnum):
    """Render.hpp primitive types."""

    LINES = 0
    TRIANGLES = 1


class Buffers(enum.IntFlag):
    """Render.hpp buffer-clear flags."""

    Color = 1
    Depth = 2


class RenderingPipeline:
    """Base: resolution, scene registry, framebuffer, display flow."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.scenes: Dict[str, Scene] = {}
        self.frame = np.zeros((self.height, self.width, 3), np.float32)
        self.zbuffer = np.full((self.height, self.width), np.inf, np.float32)
        self._scene_dicts: List[dict] = []
        # scene name -> (revision, the scene's geometry on the device)
        self._geom_cache: Dict[str, tuple] = self._per_scene()

    def _per_scene(self) -> dict:
        """A new dict keyed by scene name that `invalidate` empties with
        the geometry cache."""
        d: dict = {}
        self._scene_dicts.append(d)
        return d

    def _device_geometry(self, scene: Scene):
        """The scene's geometry on this pipeline's device, as its draws
        read it."""
        raise NotImplementedError

    def _geometry_revision(self, scene: Scene):
        """What, besides `invalidate`, makes a scene's cached geometry
        stale when it changes; nothing by default."""
        return None

    def _geometry(self, scene: Scene):
        """The scene's device geometry, built at its first draw and kept."""
        rev = self._geometry_revision(scene)
        entry = self._geom_cache.get(scene.name)
        if entry is None or entry[0] != rev:
            entry = (rev, self._device_geometry(scene))
            self._geom_cache[scene.name] = entry
        return entry[1]

    def invalidate(self, scene_name: Optional[str] = None):
        """Drop the cached geometry and other per-scene state of
        `scene_name`, or of every scene (call after adding or removing
        meshes, rebinding shaders or changing materials)."""
        for d in self._scene_dicts:
            if scene_name is None:
                d.clear()
            else:
                d.pop(scene_name, None)

    def add_scene(self, scene: Scene):
        """Render.cpp:66-97: registers the scene and sets its NDC/aspect."""
        self.scenes[scene.name] = scene
        scene.set_ndc_matrix(self.width, self.height)

    def clear(self, buffers: Buffers = Buffers.Color | Buffers.Depth):
        if buffers & Buffers.Color:
            self.frame[:] = 0.0
        if buffers & Buffers.Depth:
            self.zbuffer[:] = np.inf

    def draw(self, primitive: Primitive):
        raise NotImplementedError

    def display(self, primitive: Primitive = Primitive.TRIANGLES) -> np.ndarray:
        """draw -> merge -> 8-bit frame (Render.cpp:57-64)."""
        self.draw(primitive)
        return to_u8(self.frame)

    def save(self, path: str):
        write_png(path, self.frame)


def readback(t: torch.Tensor) -> np.ndarray:
    """`t` as a host array with the bytes, dtype and shape of
    `t.cpu().numpy()`, which is what it returns for a CPU tensor.

    A CUDA tensor is copied, blocking, into page-locked memory from
    PyTorch's caching host allocator: the copy runs at the link's speed
    instead of through the CUDA driver's pageable staging, and touches no
    fresh page. The array keeps its host tensor alive, so it is fresh and
    writable and no later read-back writes into it; the block goes back
    to the allocator's cache when the caller drops the array (a caller
    that keeps one frame while the next is drawn rotates two blocks).

    The allocator rounds a block up to a power of two (16 MiB for a
    1024x1024x3 float32 frame) and hands no cached block back to the
    system on its own: the page-locked memory a process holds is set by
    the most frames it ever kept alive at once, and stays at that for the
    life of the process (`torch.cuda.host_memory_stats()` reads it)."""
    if t.device.type != "cuda":
        return t.cpu().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def check_raster_tile(tile) -> tuple:
    """`tile` as (rows, cols) if each side is at least 1, else
    ValueError. The tile kernels take any such tile: one of more than
    `raster_kernel.MAX_TILE_PIXELS` pixels gives way to the default
    kernel tile (`raster_kernel.kernel_tile`)."""
    th, tw = (int(x) for x in tile)
    if th < 1 or tw < 1:
        raise ValueError(f"raster_tile {tuple(tile)}: each side must be at least 1")
    return th, tw


def pipeline_from_config(cfg, kind: str = "path", device="cuda"):
    """Construct a render pipeline from a RenderConfig (config.py) on a
    torch device: the card unless the caller asks for "cpu". kind:
    "raster" | "whitted" | "path". `cfg.raster_tile` is the raster tile
    kernels' tile; a non-positive side raises (`check_raster_tile`). No
    output depends on it."""
    if kind == "raster":
        from software_rasterizer_tpu_torch.render.rasterizer import (
            TraditionalRasterizer,
        )

        return TraditionalRasterizer(cfg.width, cfg.height,
                                     tile=check_raster_tile(cfg.raster_tile),
                                     device=device)
    if kind == "whitted":
        from software_rasterizer_tpu_torch.render.raytracer import RayTracing

        return RayTracing(cfg.width, cfg.height, spp=cfg.spp,
                          max_depth=cfg.max_depth, seed=cfg.seed,
                          device=device)
    if kind == "path":
        from software_rasterizer_tpu_torch.render.pathtracer import PathTracing

        return PathTracing(cfg.width, cfg.height, spp=cfg.spp,
                           max_bounces=cfg.max_bounces, seed=cfg.seed,
                           device=device)
    raise ValueError(f"unknown pipeline kind {kind!r}")
