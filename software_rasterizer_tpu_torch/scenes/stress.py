"""Large-scene stress workload: a midpoint-tessellated mesh.

The reference's scenes top out at ~6K triangles. `subdivide_mesh`
tessellates any mesh by recursive midpoint subdivision (4^k faces per
source face), which makes scenes of a real size from the meshes the
repository holds; `build_stress_scene` is the JAX package's tessellated
Stanford bunny (4968 * 4^levels faces), from an OBJ file the caller
names.
"""

from __future__ import annotations

import numpy as np

from software_rasterizer_tpu_torch.models.material import Material, MaterialType
from software_rasterizer_tpu_torch.models.objects import MeshObject
from software_rasterizer_tpu_torch.models.scene import Scene
from software_rasterizer_tpu_torch.utils.obj_loader import MeshData, load_obj


def subdivide_mesh(data: MeshData, levels: int = 1) -> MeshData:
    """Midpoint (1:4) subdivision of a triangle soup, `levels` times.

    New vertices are edge midpoints with attributes (normal/uv/color)
    averaged from the edge endpoints; shared edges are deduplicated so
    the surface stays watertight where the source was. Geometry is
    unchanged as a point set limit: this is a load generator, not a
    smoothing scheme (no Loop weights on purpose: the positions must
    stay ON the original surface so renders stay comparable)."""
    v, n, uv, col, f = (
        data.vertices, data.normals, data.uvs, data.colors, data.faces,
    )
    for _ in range(levels):
        nv = v.shape[0]
        edges = {}
        v_new = [v]
        n_new = [n]
        uv_new = [uv]
        c_new = [col]

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            m = edges.get(key)
            if m is None:
                m = nv + len(edges)
                edges[key] = m
            return m

        fa, fb, fc = f[:, 0], f[:, 1], f[:, 2]
        mab = np.array([midpoint(a, b) for a, b in zip(fa, fb)], np.int32)
        mbc = np.array([midpoint(a, b) for a, b in zip(fb, fc)], np.int32)
        mca = np.array([midpoint(a, b) for a, b in zip(fc, fa)], np.int32)

        pairs = np.array(sorted(edges, key=edges.get), np.int32)  # (E,2)
        for src, dst in ((v, v_new), (n, n_new), (uv, uv_new), (col, c_new)):
            dst.append((src[pairs[:, 0]] + src[pairs[:, 1]]) * 0.5)
        v = np.concatenate(v_new).astype(np.float32)
        n = np.concatenate(n_new).astype(np.float32)
        norms = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(norms, 1e-20)
        uv = np.concatenate(uv_new).astype(np.float32)
        col = np.concatenate(c_new).astype(np.float32)
        f = np.concatenate([
            np.stack([fa, mab, mca], 1),
            np.stack([mab, fb, mbc], 1),
            np.stack([mca, mbc, fc], 1),
            np.stack([mab, mbc, mca], 1),
        ]).astype(np.int32)
    return MeshData(
        name=data.name, vertices=v, normals=n, uvs=uv, colors=col, faces=f,
        material=data.material,
        bbox_min=v.min(0), bbox_max=v.max(0), had_normals=data.had_normals,
    )


def build_stress_scene(bunny_obj: str, levels: int = 3) -> Scene:
    """Tessellated bunny from the OBJ file `bunny_obj` (4968 * 4^levels
    faces; levels=3 -> 317,952) lit by an emissive ceiling quad, framed
    like the README bunny walkthrough (eye (0,0,-3), bunny scaled 12x,
    README.md:288-375)."""
    scene = Scene(
        "BunnyStress",
        eye=(0.0, 0.0, -3.0),
        center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        background=(0.2355, 0.6735, 0.2400),
    )
    data = subdivide_mesh(load_obj(bunny_obj, name="bunny"), levels)
    mat = Material(type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(0.7, 0.7, 0.7))
    scene.add_graphic_obj(MeshObject(data, material=mat), "bunny")
    scene.set_model_matrix(
        "bunny", (0.0, 1.0, 0.0), 0.0, (0.0, -1.0, 0.0), (12.0, 12.0, 12.0)
    )

    # emissive quad above (two triangles), so integrators have a light
    lv = np.array([
        [-1.0, 2.0, -1.0], [1.0, 2.0, -1.0],
        [1.0, 2.0, 1.0], [-1.0, 2.0, 1.0],
    ], np.float32)
    ln = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (4, 1))
    light_data = MeshData(
        name="light", vertices=lv, normals=ln,
        uvs=np.zeros((4, 2), np.float32),
        colors=np.ones((4, 3), np.float32),
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material=None, bbox_min=lv.min(0), bbox_max=lv.max(0),
        had_normals=True,
    )
    lmat = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(1.0, 1.0, 1.0),
        emission=(24.0, 24.0, 24.0),
    )
    scene.add_graphic_obj(MeshObject(light_data, material=lmat), "light")
    scene.set_model_matrix(
        "light", (0.0, 1.0, 0.0), 0.0, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    )
    return scene
