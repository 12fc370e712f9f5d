"""Geometry objects (reference: include/object/* hierarchy).

No virtual dispatch here — objects are host-side descriptions; all
intersection/shading math happens over flattened arrays (SURVEY.md 7.1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from software_rasterizer_tpu_torch.models.material import Material
from software_rasterizer_tpu_torch.utils import transforms as tf
from software_rasterizer_tpu_torch.utils.obj_loader import MeshData
from software_rasterizer_tpu_torch.utils.texture import Texture


@dataclasses.dataclass
class ShaderBinding:
    """A fragment shader = (type, texture) pair (Shader.hpp:32-38 types;
    one texture per shader, Shader ctor)."""

    name: str
    type: int  # ShaderType value (see ops/shading.py)
    texture: Optional[Texture]


class SceneObject:
    """Base: model matrix handling shared by all objects (Object.cpp:23-31)."""

    def __init__(self, material: Optional[Material] = None):
        self.material = material if material is not None else Material()
        self.model = np.eye(4, dtype=np.float32)
        self.shader: Optional[ShaderBinding] = None

    def update_model_matrix(self, axis, angle_deg, translation, scale):
        self.model = tf.model_trs(axis, angle_deg, translation, scale)

    def bind_shader(self, shader: ShaderBinding):
        self.shader = shader

    def is_self_emissive(self) -> bool:
        return self.material.has_emission()


class MeshObject(SceneObject):
    """Triangle mesh (reference Mesh). Owns untransformed SoA arrays; the
    per-frame transform and (re)build of acceleration data happen on
    device / at flatten time rather than via per-triangle objects
    (Mesh.cpp:73-89 rebuilds its BVH every frame; we rebuild only when
    transforms change, SURVEY.md 7.4)."""

    def __init__(self, data: MeshData, material: Optional[Material] = None):
        super().__init__(material)
        self.data = data
        if material is None and data.material is not None:
            m = data.material
            self.material = Material(
                Ka=m.Ka, Kd=m.Kd, Ks=m.Ks, name=m.name,
                Ns=m.Ns, Ni=m.Ni, d=m.d, illum=m.illum,
            )

    @property
    def n_faces(self) -> int:
        return int(self.data.faces.shape[0])

    def areas(self, verts: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-triangle area 0.5*|e1 x e2| (Triangle.cpp:259-266)."""
        v = self.data.vertices if verts is None else verts
        f = self.data.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


class SphereObject(SceneObject):
    """Analytic sphere (reference Sphere)."""

    def __init__(
        self,
        center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        radius: float = 1.0,
        material: Optional[Material] = None,
    ):
        super().__init__(material)
        self.center = np.asarray(center, np.float32)
        self.radius = float(radius)

    def transformed(self, view: np.ndarray, projection: np.ndarray):
        """Sphere::updatePosition (Sphere.cpp:22-42): center through
        P*V*M with divide, radius scaled by max model-scale component."""
        mvp = projection @ view @ self.model
        c = tf.transform_points_h(mvp, self.center[None])[0]
        r = self.radius * tf.decompose_max_scale(self.model)
        return c, np.float32(r)

    def area(self, radius: float) -> float:
        return float(4.0 * np.pi * radius * radius)


class CubeObject(SceneObject):
    """API-parity stub (reference Cube, src/Cube.cpp:7-45 — every method
    returns empty/defaults; it exists only as a class-hierarchy slot).
    Instantiable and transformable, contributes no geometry."""

    def __init__(self, material: Optional[Material] = None):
        super().__init__(material)

    @property
    def n_faces(self) -> int:
        return 0


class SphereLight(SphereObject):
    """Sphere + intensity; emissive spheres double as raster point lights
    (SphereLight.hpp, Scene.cpp:296-312)."""

    def __init__(
        self,
        center=(0.0, 0.0, 0.0),
        intensity=(1.0, 1.0, 1.0),
        radius: float = 1.0,
        material: Optional[Material] = None,
    ):
        super().__init__(center, radius, material)
        self.intensity = np.asarray(intensity, np.float32)
