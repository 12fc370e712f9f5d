"""The scene inputs the reference reads, taken from a scene object as a
user built it: each mesh's own arrays, model matrix, material, shader and
texture, and the scene's matrices, camera and lights. Nothing that the
program derives from them (trace tables, BVH order, packed atlases) is
read."""

from __future__ import annotations

import numpy as np


def _material(m) -> dict:
    return {"type": int(m.type), "ka": np.asarray(m.Ka, np.float32),
            "kd": np.asarray(m.Kd, np.float32), "ks": np.asarray(m.Ks, np.float32),
            "spec": np.float32(m.specular_exponent), "ior": np.float32(m.ior),
            "emission": np.asarray(m.emission, np.float32)}


def scene_inputs(scene) -> dict:
    """A dict of plain numpy arrays and numbers (see `reference.scene`)."""
    meshes = []
    for name, obj in scene.meshes():
        d = obj.data
        shader = obj.shader
        tex = None
        if shader is not None and shader.texture is not None:
            tex = np.round(np.asarray(shader.texture.data) * 255.0).astype(np.uint8)
        meshes.append({
            "name": name,
            "vertices": np.asarray(d.vertices, np.float32),
            "normals": np.asarray(d.normals, np.float32),
            "uvs": np.asarray(d.uvs, np.float32),
            "colors": np.asarray(d.colors, np.float32),
            "faces": np.asarray(d.faces, np.int64),
            "model": np.asarray(obj.model, np.float32),
            "material": _material(obj.material),
            "shader": None if shader is None else int(shader.type),
            "texture": tex,
        })
    lights = scene.load_lights()
    return {
        "meshes": meshes,
        "n_spheres": len(scene.spheres()),
        "view": np.asarray(scene.view, np.float32),
        "projection": np.asarray(scene.projection, np.float32),
        "ndc": np.asarray(scene.ndc, np.float32),
        "eye": np.asarray(scene.eye, np.float32),
        "background": np.asarray(scene.background, np.float32),
        "fovy": float(scene.fovy), "near": float(scene.near), "far": float(scene.far),
        "rr": float(scene.rr), "max_depth": int(scene.max_depth),
        "lights": {
            "pos": np.array([l.position for l in lights] or [[0.0] * 3], np.float32),
            "int": np.array([l.intensity for l in lights] or [[0.0] * 3], np.float32),
        },
    }
