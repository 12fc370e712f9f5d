"""Configuration layer.

The reference has no config system: resolution/spp/camera all hardcoded in
`src/main.cpp` with constructor defaults (spp=16 RayTracing.hpp:12,
maxdepth=5 / rr=0.8 Scene.hpp:38, fovy=45 Scene.cpp:26, near=0.1/far=100
Scene.hpp:175). We provide a real dataclass config (SURVEY.md section 5.6).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass
class RenderConfig:
    """All render-time knobs in one place.

    Defaults mirror the reference's constructor defaults so that demo
    scenes reproduce its behavior (reference: Scene.hpp:38, Scene.cpp:26,
    RayTracing.hpp:12, Scene.hpp:175).
    """

    width: int = 1024
    height: int = 1024
    spp: int = 16
    max_depth: int = 5           # Whitted recursion cap (Scene.hpp:38)
    russian_roulette: float = 0.8  # path-tracer RR survival prob (Scene.hpp:38)
    max_bounces: int = 24        # wavefront cap for the RR loop (RR makes the
                                 # tail negligible: 0.8^24 ~ 4.7e-3 of paths)
    fovy: float = 45.0           # degrees (quirk: raster projection treats it
                                 # as radians, faithful to Scene.cpp:293)
    near: float = 0.1
    far: float = 100.0
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    epsilon: float = 1e-5        # Scene.hpp:160
    seed: int = 0
    # Device-mesh axes: framebuffer tiles ("tile") x sample shards ("spp").
    tile_shards: int = 1
    spp_shards: int = 1
    # Pallas raster tile size (rows, cols) — fp32-aligned (8,128) multiples.
    raster_tile: Tuple[int, int] = (128, 128)
    # Use brute-force intersection below this triangle count, BVH above.
    bvh_threshold: int = 8192
    # Progressive checkpoint of the spp accumulator every K sample batches
    # (0 disables). See render/pathtracer.py save_checkpoint/load_checkpoint.
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        d = json.loads(s)
        if "raster_tile" in d:
            d["raster_tile"] = tuple(d["raster_tile"])
        if "background" in d:
            d["background"] = tuple(d["background"])
        return cls(**d)
