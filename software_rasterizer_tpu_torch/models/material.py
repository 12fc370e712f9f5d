"""Materials (reference: include/object/Material.hpp, src/Material.cpp).

The BRDF itself (hemisphere sampling, pdf, fr) is implemented as array ops
in ops/sampling.py; this module is the host-side description plus the
packed table the integrators consume.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple

import numpy as np


class MaterialType(enum.IntEnum):
    """Material.hpp:10-14."""

    DIFFUSE_AND_GLOSSY = 0
    REFLECTION_AND_REFRACTION = 1
    REFLECTION = 2


@dataclasses.dataclass
class Material:
    """Fields per Material.hpp:47-73 (defaults per Material ctor)."""

    type: MaterialType = MaterialType.DIFFUSE_AND_GLOSSY
    Ka: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Kd: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    specular_exponent: float = 0.0
    ior: float = 0.0
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # parsed-but-unused OBJ fields kept for API parity (Material.hpp:47-63)
    name: str = ""
    Ns: float = 0.0
    Ni: float = 0.0
    d: float = 0.0
    illum: int = 0
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def has_emission(self) -> bool:
        """Material.cpp:65-68: ||emission|| > float eps."""
        return float(np.linalg.norm(self.emission)) > np.finfo(np.float32).eps


@dataclasses.dataclass
class MaterialTable:
    """Packed SoA material table for device integrators (host NumPy;
    ops/intersect.prepare_rt_scene moves it to the device)."""

    type: np.ndarray       # (M,) i32
    ka: np.ndarray         # (M,3) f32
    kd: np.ndarray         # (M,3) f32
    ks: np.ndarray         # (M,3) f32
    spec_exp: np.ndarray   # (M,) f32
    ior: np.ndarray        # (M,) f32
    emission: np.ndarray   # (M,3) f32

    @classmethod
    def pack(cls, materials: List[Material]) -> "MaterialTable":
        if not materials:
            materials = [Material()]
        return cls(
            type=np.array([int(m.type) for m in materials], np.int32),
            ka=np.array([m.Ka for m in materials], np.float32),
            kd=np.array([m.Kd for m in materials], np.float32),
            ks=np.array([m.Ks for m in materials], np.float32),
            spec_exp=np.array([m.specular_exponent for m in materials], np.float32),
            ior=np.array([m.ior for m in materials], np.float32),
            emission=np.array([m.emission for m in materials], np.float32),
        )

    @property
    def is_emissive(self) -> np.ndarray:
        return np.linalg.norm(self.emission, axis=-1) > np.finfo(np.float32).eps
