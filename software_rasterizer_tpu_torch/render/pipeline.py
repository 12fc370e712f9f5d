"""RenderingPipeline base (reference: src/Render.cpp, include/base/Render.hpp).

The reference pipeline owns planar float channels + a z-buffer and a GUI
display loop. Here `display()` runs the device pipeline and returns the
frame as a numpy image; `save()` writes PNG. Framebuffer clear semantics
match Render.cpp:31-55 (color -> 0, z -> +inf).
"""

from __future__ import annotations

import enum
from typing import Dict

import numpy as np

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


def pipeline_from_config(cfg, kind: str = "path", device="cuda"):
    """Construct a render pipeline from a RenderConfig (config.py) on a
    torch device: the card unless the caller asks for "cpu". kind:
    "raster" | "whitted" | "path". `cfg.raster_tile` sizes the TPU
    kernel's blocks and is not read: the CUDA tile kernels keep their own
    default tile, and no output depends on it."""
    if kind == "raster":
        from software_rasterizer_tpu_torch.render.rasterizer import (
            TraditionalRasterizer,
        )

        return TraditionalRasterizer(cfg.width, cfg.height, device=device)
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
