"""Pure-Python Wavefront OBJ/MTL loader.

Replaces the reference's tinyobjloader + conversion layer
(ObjLoader.cpp:78-233) with zero heavy deps. Reproduced behaviors:

  * fan triangulation of polygon faces (tinyobj default),
  * vertex dedup by exact (position, normal, uv, color) equality
    (ObjLoader.cpp:93-95,155-160),
  * texcoord V flip ``1 - v`` (ObjLoader.cpp:152),
  * default vertex color (1,1,1) (tinyobj attrib.colors default),
  * missing-normal synthesis with the angle-weighted cross-product formula
    (ObjLoader.cpp:178-185 -> Tools::calculateNormalWithWeight,
    Tools.cpp:234-248), assigned per-face in face order so later faces
    overwrite shared vertices exactly like the reference loop,
  * MTL conversion keeps only the LAST material in the file
    (processMatrial loop quirk, ObjLoader.cpp:47-73),
  * bounding box accumulated over raw positions (ObjLoader.cpp:124-130).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MtlMaterial:
    """Parsed .mtl fields (Material.hpp:47-63 equivalents)."""

    name: str = ""
    Ka: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Kd: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ns: float = 0.0
    Ni: float = 0.0
    d: float = 1.0
    illum: int = 0
    map_Ka: str = ""
    map_Kd: str = ""
    map_Ks: str = ""
    map_Ns: str = ""
    map_d: str = ""
    map_bump: str = ""


@dataclasses.dataclass
class MeshData:
    """Deduplicated triangle-soup arrays for one OBJ file."""

    name: str
    vertices: np.ndarray   # (V,3) f32
    normals: np.ndarray    # (V,3) f32
    uvs: np.ndarray        # (V,2) f32
    colors: np.ndarray     # (V,3) f32
    faces: np.ndarray      # (F,3) i32
    material: MtlMaterial
    bbox_min: np.ndarray   # (3,) f32
    bbox_max: np.ndarray   # (3,) f32
    had_normals: bool


def parse_mtl(path: str) -> Dict[str, MtlMaterial]:
    """Parse a .mtl file into {name: MtlMaterial}."""
    mats: Dict[str, MtlMaterial] = {}
    cur: Optional[MtlMaterial] = None
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key, vals = parts[0], parts[1:]
            if key == "newmtl":
                cur = MtlMaterial(name=vals[0] if vals else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key in ("Ka", "Kd", "Ks") and len(vals) >= 3:
                setattr(cur, key, tuple(float(v) for v in vals[:3]))
            elif key == "Ns":
                cur.Ns = float(vals[0])
            elif key == "Ni":
                cur.Ni = float(vals[0])
            elif key == "d":
                cur.d = float(vals[0])
            elif key == "Tr":
                cur.d = 1.0 - float(vals[0])
            elif key == "illum":
                cur.illum = int(float(vals[0]))
            elif key in ("map_Ka", "map_Kd", "map_Ks", "map_Ns", "map_d"):
                setattr(cur, key, vals[-1] if vals else "")
            elif key in ("map_bump", "bump"):
                cur.map_bump = vals[-1] if vals else ""
    return mats


def _last_material(mats: Dict[str, MtlMaterial]) -> MtlMaterial:
    """The reference's processMatrial keeps only the last material
    encountered (ObjLoader.cpp:47-73)."""
    out = MtlMaterial()
    for m in mats.values():  # dict preserves insertion order
        out = m
    return out


def _angle_weighted_normal(pa: np.ndarray, pb: np.ndarray, pc: np.ndarray) -> np.ndarray:
    """Tools::calculateNormalWithWeight (Tools.cpp:234-248), including its
    asin weighting and normalize."""
    ab = pb - pa
    ac = pc - pa
    n = np.cross(ab, ac)
    length = np.linalg.norm(n)
    denom = np.linalg.norm(ab) * np.linalg.norm(ac)
    if denom > 0 and not (-1e-8 <= length <= 1e-8):
        ratio = min(length / denom, 1.0)
        n = n * (np.arcsin(ratio) / length)
    ln = np.linalg.norm(n)
    return (n / ln).astype(np.float32) if ln > 0 else n.astype(np.float32)


def _angle_weighted_normals_vec(pa: np.ndarray, pb: np.ndarray, pc: np.ndarray) -> np.ndarray:
    """Vectorized Tools::calculateNormalWithWeight over (F,3) corner
    triples — same dtype (f32) and formula as the scalar version."""
    ab = pb - pa
    ac = pc - pa
    n = np.cross(ab, ac)
    length = np.linalg.norm(n, axis=-1)
    denom = np.linalg.norm(ab, axis=-1) * np.linalg.norm(ac, axis=-1)
    apply = (denom > 0) & ~((length >= -1e-8) & (length <= 1e-8))
    ratio = np.minimum(np.divide(length, np.where(denom > 0, denom, 1.0)), 1.0)
    w = np.arcsin(ratio) / np.where(length != 0, length, 1.0)
    n = np.where(apply[:, None], n * w[:, None], n)
    ln = np.linalg.norm(n, axis=-1)
    return np.where((ln > 0)[:, None], n / np.where(ln > 0, ln, 1.0)[:, None], n).astype(np.float32)


def _assemble_mesh(
    positions: np.ndarray,   # (P,3) raw OBJ positions (f32 or f64)
    normals_in: np.ndarray,  # (N,3)
    uvs_in: np.ndarray,      # (T,2)
    corners: np.ndarray,     # (C,3) i32 (v, vt, vn), -1 absent, C = 3*faces
    material: MtlMaterial,
    name: str,
) -> MeshData:
    """Dedup + normal synthesis, vectorized (the OBJ hot path for large
    assets; reference analog: ObjLoader::processingVertexData,
    ObjLoader.cpp:78-195)."""
    vi = corners[:, 0]
    ti = corners[:, 1]
    ni = corners[:, 2]
    c = vi.shape[0]

    pos = positions[vi]
    bbox_min = (
        pos.min(axis=0).astype(np.float32) if c else np.full(3, np.inf, np.float32)
    )
    bbox_max = (
        pos.max(axis=0).astype(np.float32) if c else np.full(3, -np.inf, np.float32)
    )

    had_normals = bool((ni >= 0).any())
    if normals_in.size:
        # normalized on load (f64 math like the scalar path)
        nn = normals_in.astype(np.float64)
        ln = np.linalg.norm(nn, axis=-1, keepdims=True)
        nn = np.where(ln > 0, nn / np.where(ln > 0, ln, 1.0), nn)
        nrm = np.where((ni >= 0)[:, None], nn[np.maximum(ni, 0)], 0.0)
    else:
        nrm = np.zeros((c, 3), np.float64)

    if uvs_in.size:
        uvr = uvs_in[np.maximum(ti, 0)]
        # texcoord V flip 1 - v (ObjLoader.cpp:152)
        uv = np.stack([uvr[:, 0], 1.0 - uvr[:, 1]], axis=1)
        uv = np.where((ti >= 0)[:, None], uv, 0.0)
    else:
        uv = np.zeros((c, 2), positions.dtype)

    # Vertex dedup by exact record equality (ObjLoader.cpp:155-160):
    # first-occurrence order, like the reference's hash-map insert.
    # Vertex color is the constant tinyobj default (1,1,1) — excluded
    # from the key (it cannot distinguish records).
    records = np.concatenate(
        [pos.astype(np.float64), nrm.astype(np.float64), uv.astype(np.float64)],
        axis=1,
    )
    records = records + 0.0  # canonicalize -0.0 == +0.0 (value equality)
    uniq, first, inv = np.unique(
        records, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.shape[0], np.int64)
    rank[order] = np.arange(order.shape[0])
    indices = rank[inv.reshape(-1)]
    src = first[order]  # corner row that introduced each unique vertex

    vertices = pos[src].astype(np.float32).reshape(-1, 3)
    normals = nrm[src].astype(np.float32).reshape(-1, 3)
    uvs = uv[src].astype(np.float32).reshape(-1, 2)
    colors = np.ones((vertices.shape[0], 3), np.float32)

    n_faces = c // 3
    faces = indices.astype(np.int32).reshape(n_faces, 3)

    if not had_normals and n_faces:
        # Missing-normal synthesis, per-face overwrite in face order
        # (ObjLoader.cpp:166-186 quirk: shared vertices end with the LAST
        # face's normal). Flat fancy-index assignment in corner order
        # reproduces the write order exactly (later rows win).
        pa = vertices[faces[:, 0]]
        pb = vertices[faces[:, 1]]
        pc = vertices[faces[:, 2]]
        na = _angle_weighted_normals_vec(pa, pb, pc)
        nb = _angle_weighted_normals_vec(pb, pc, pa)
        ncr = _angle_weighted_normals_vec(pc, pa, pb)
        vals = np.stack([na, nb, ncr], axis=1).reshape(-1, 3)
        normals[faces.reshape(-1)] = vals

    return MeshData(
        name=name,
        vertices=vertices,
        normals=normals,
        uvs=uvs,
        colors=colors,
        faces=faces,
        material=material,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        had_normals=had_normals,
    )


def _scan_header_lines(text: str) -> Tuple[List[str], str]:
    """mtllib file list + first o/g name (the only non-geometry state the
    native scanner does not extract)."""
    import re

    mtl_files: List[str] = []
    obj_name = ""
    for m in re.finditer(r"(?m)^[ \t]*(mtllib|o|g)[ \t]+(.+?)[ \t\r]*$", text):
        key, val = m.group(1), m.group(2)
        if key == "mtllib":
            mtl_files.extend(val.split())
        elif not obj_name:
            obj_name = val.split()[0]
    return mtl_files, obj_name


def load_obj(path: str, name: str = "") -> MeshData:
    """Load an OBJ file into deduplicated SoA arrays."""
    with open(path, "r", errors="replace") as f:
        return load_obj_source(
            f.read(), name=name or os.path.basename(path),
            base_dir=os.path.dirname(path),
        )


def load_obj_source(text: str, name: str = "", base_dir: str = "") -> MeshData:
    """Parse OBJ content from a string (same pipeline as `load_obj`).

    The geometry scan is pure Python; assembly (dedup, V-flip, normal
    synthesis) is vectorized NumPy. The output equals the native
    scanner's (native/srt_native.cpp) that the JAX package may use.
    """
    mtl_files, obj_name = _scan_header_lines(text)
    mats: Dict[str, MtlMaterial] = {}
    for mf in mtl_files:
        mp = os.path.join(base_dir, mf)
        if os.path.exists(mp):
            mats.update(parse_mtl(mp))
    material = _last_material(mats)

    pos, nrm, uv, corners = _scan_obj_python(text)

    return _assemble_mesh(
        pos, nrm, uv, corners, material, name or obj_name or "mesh"
    )


def _scan_obj_python(text: str):
    """Pure-Python OBJ geometry scan (the same outputs as the JAX
    package's native scanner: positions, normals, uvs, fan-triangulated
    corner triples)."""
    positions: List[Tuple[float, float, float]] = []
    normals_in: List[Tuple[float, float, float]] = []
    uvs_in: List[Tuple[float, float]] = []
    face_corners: List[Tuple[int, int, int]] = []  # (v, vt, vn), -1 absent

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key, vals = parts[0], parts[1:]
        if key == "v":
            positions.append(tuple(float(v) for v in vals[:3]))
        elif key == "vn":
            normals_in.append(tuple(float(v) for v in vals[:3]))
        elif key == "vt":
            uvs_in.append(tuple(float(v) for v in vals[:2]))
        elif key == "f":
            corners = []
            # same 64-vertex face cap as the native scanner
            # (native/srt_native.cpp fill buffer), so both paths parse
            # identical geometry for pathological polygon faces
            for tok in vals[:64]:
                fields = tok.split("/")
                vi = int(fields[0])
                ti = int(fields[1]) if len(fields) > 1 and fields[1] else 0
                ni = int(fields[2]) if len(fields) > 2 and fields[2] else 0
                # OBJ is 1-based; negatives are relative to current count.
                vi = vi - 1 if vi > 0 else len(positions) + vi
                ti = ti - 1 if ti > 0 else (len(uvs_in) + ti if ti < 0 else -1)
                ni = ni - 1 if ni > 0 else (len(normals_in) + ni if ni < 0 else -1)
                corners.append((vi, ti, ni))
            # fan triangulation (tinyobj default for polygons)
            for k in range(1, len(corners) - 1):
                face_corners.append(corners[0])
                face_corners.append(corners[k])
                face_corners.append(corners[k + 1])

    return (
        np.asarray(positions, np.float64).reshape(-1, 3),
        np.asarray(normals_in, np.float64).reshape(-1, 3),
        np.asarray(uvs_in, np.float64).reshape(-1, 2),
        np.asarray(face_corners, np.int32).reshape(-1, 3),
    )
