"""Point lights (reference: include/light/Light.hpp light_struct)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class PointLight:
    """light_struct: {position, intensity} (Light.hpp:8-45)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    intensity: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class AreaLight(PointLight):
    """Rectangle light (reference AreaLight, src/AreaLight.cpp:4-14 —
    defined but never instantiated by any pipeline; kept for API parity).
    sample_point() = pos + u*u_vec + v*v_vec with uniform u,v."""

    normal: Tuple[float, float, float] = (0.0, -1.0, 0.0)
    u_vec: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    v_vec: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    length: float = 100.0

    def sample_point(self, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        u, v = rng.random(), rng.random()
        return (
            np.asarray(self.position, np.float64)
            + u * np.asarray(self.u_vec, np.float64)
            + v * np.asarray(self.v_vec, np.float64)
        )


def pack_lights(lights: List[PointLight]) -> Tuple[np.ndarray, np.ndarray]:
    """-> positions (L,3) f32, intensities (L,3) f32 (L >= 1, zero-padded
    so shaders always see a static light count)."""
    if not lights:
        return np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32)
    pos = np.array([l.position for l in lights], np.float32)
    inten = np.array([l.intensity for l in lights], np.float32)
    return pos, inten
