"""The device scene of the ray-traced pipelines (reference:
Scene::updatePosition, Scene.cpp:882-901; Triangle.cpp:215-231).

`prepare_rt_scene` transforms the host geometry (`models.scene.RTGeometry`
+ `RTFrame`) into trace space on a torch device. `RTScene` holds the
fields the path-tracing and Whitted slices read; the JAX package's other
fields (`tri_obj`, `sph_obj`, `emitter_center/radius/mask/order`,
`prim_attr`, `prim_shadow`, `prim_cls`, `mt_coef`, `chunk_lo/hi`,
`tex_packed`) come with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

BIG = 1e30


@dataclasses.dataclass
class RTScene:
    """Transformed scene (post P*V*M, perspective-divided — the
    reference traces rays in this space). Tensors live on one device."""

    v0: torch.Tensor          # (F,3) f32
    v1: torch.Tensor          # (F,3)
    v2: torch.Tensor          # (F,3)
    n0: torch.Tensor          # (F,3) normalized vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor         # (F,2) vertex uvs
    uv1: torch.Tensor
    uv2: torch.Tensor
    tri_mat: torch.Tensor     # (F,) i32
    tri_tex: torch.Tensor     # (F,) i32 texture id (-1 none)
    tri_valid: torch.Tensor   # (F,) bool
    tri_table: torch.Tensor   # (F,12) [v0|e1|e2|pad], invalid rows zero
    n_tri: int                # 1 + last valid triangle index
    sph_c: torch.Tensor       # (S,3) transformed centers
    sph_r: torch.Tensor       # (S,) transformed radii
    sph_mat: torch.Tensor     # (S,) i32
    sph_valid: torch.Tensor   # (S,) bool
    n_sph: int                # 1 + last valid sphere index
    mat_type: torch.Tensor    # (M,) i32
    mat_ka: torch.Tensor      # (M,3)
    mat_kd: torch.Tensor      # (M,3)
    mat_ks: torch.Tensor      # (M,3)
    mat_spec: torch.Tensor    # (M,) specular exponent
    mat_ior: torch.Tensor     # (M,)
    mat_emit: torch.Tensor    # (M,3)
    emitter_cr: torch.Tensor  # (max(n_emitters,1),4) [center, radius],
                              # emissive objects first
    n_emitters: int
    background: torch.Tensor  # (3,)
    eye: torch.Tensor         # (3,)
    textures: torch.Tensor    # (K,Hm,Wm,3) u8 atlas
    tex_wh: torch.Tensor      # (K,2) i32 (width, height)
    tex_on_emitter: bool      # an emissive triangle carries a texture

    @property
    def device(self) -> torch.device:
        return self.v0.device


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return device


def hom_transform(mats: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Per-point 4x4 transform with perspective divide. mats (N,4,4)
    gathered per point, points (N,3) -> (N,3). The 3-term dot is summed
    left to right, as XLA's CPU dot does."""
    h = (mats[:, :, 0] * points[:, 0:1] + mats[:, :, 1] * points[:, 1:2]
         + mats[:, :, 2] * points[:, 2:3]) + mats[:, :, 3]
    return h[:, :3] / h[:, 3:4]


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim))


def mt_tri_table(v0, v1, v2, valid) -> torch.Tensor:
    """(F,12) [v0 | e1 | e2 | pad] rows with invalid rows zeroed (det = 0
    rejects them)."""
    tab = torch.cat([v0, v1 - v0, v2 - v0, torch.zeros_like(v0)], dim=1)
    return torch.where(valid[:, None], tab, torch.zeros_like(tab))


def loop_bound(valid: np.ndarray) -> int:
    """1 + the index of the last valid row (0 if none): the kernels'
    primitive loop bound, from host flags so no device sync is needed."""
    idx = np.flatnonzero(np.asarray(valid))
    return int(idx[-1]) + 1 if idx.size else 0


def _emitter_table(obj_emissive: np.ndarray, centers, radii):
    """[center, radius] rows with emissive objects first (stable), cut to
    the true emitter count (at least one row)."""
    emissive = np.asarray(obj_emissive, bool)
    order = np.argsort(~emissive, kind="stable")
    cr = torch.cat([centers, radii[:, None]], dim=1)[
        torch.as_tensor(order, device=centers.device)]
    n_emit = int(emissive.sum())
    return cr[: max(n_emit, 1)], n_emit


def prepare_rt_scene(geom, frame, device) -> RTScene:
    """Transform geometry into trace space (Scene::updatePosition analog).

    geom: models.scene.RTGeometry; frame: models.scene.RTFrame (host
    NumPy); device: where the scene's tensors live."""
    device = check_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32 = torch.float32
    vmesh = t(geom.vertex_mesh, torch.int64)
    pos = hom_transform(t(frame.mvp, f32)[vmesh], t(geom.positions, f32))
    nm = t(frame.normal_mat3, f32)[vmesh]
    nv = t(geom.normals, f32)
    nrm = (nm[:, :, 0] * nv[:, 0:1] + nm[:, :, 1] * nv[:, 1:2]
           + nm[:, :, 2] * nv[:, 2:3])
    nrm = nrm / torch.clamp(_norm(nrm, keepdim=True), min=1e-20)

    faces = t(geom.faces, torch.int64)
    tv = pos[faces]   # (F,3,3)
    tn = nrm[faces]
    tuv = t(geom.uvs, f32)[faces]   # (F,3,2)
    valid = t(geom.face_valid, torch.bool)

    sc = hom_transform(t(frame.sph_mvp, f32), t(geom.sph_center, f32))
    sr = t(geom.sph_radius, f32) * t(frame.sph_scale, f32)
    sph_valid = t(geom.sph_valid, torch.bool)

    # per-object emitter bounding spheres (sampleLight, Scene.cpp:398-476):
    # bbox center + |diagonal|/2 over each object's transformed extent
    tri_obj = t(geom.tri_obj, torch.int64)
    sph_obj = t(geom.sph_obj, torch.int64)
    big = torch.tensor(BIG, dtype=f32, device=device)
    centers, radii = [], []
    for o in range(len(geom.obj_emissive)):
        tmask = ((tri_obj == o) & valid)[:, None, None]
        lo_t = torch.where(tmask, tv, big).amin(dim=(0, 1))
        hi_t = torch.where(tmask, tv, -big).amax(dim=(0, 1))
        smask = ((sph_obj == o) & sph_valid)[:, None]
        lo_s = torch.where(smask, sc - sr[:, None], big).amin(dim=0)
        hi_s = torch.where(smask, sc + sr[:, None], -big).amax(dim=0)
        lo = torch.minimum(lo_t, lo_s)
        hi = torch.maximum(hi_t, hi_s)
        centers.append((lo + hi) * 0.5)
        radii.append(_norm(hi - lo) * 0.5)
    emitter_cr, n_emit = _emitter_table(
        geom.obj_emissive, torch.stack(centers), torch.stack(radii))

    tri_table = mt_tri_table(tv[:, 0], tv[:, 1], tv[:, 2], valid)
    mt = geom.materials
    return RTScene(
        v0=tv[:, 0], v1=tv[:, 1], v2=tv[:, 2],
        n0=tn[:, 0], n1=tn[:, 1], n2=tn[:, 2],
        uv0=tuv[:, 0], uv1=tuv[:, 1], uv2=tuv[:, 2],
        tri_mat=t(geom.tri_mat, torch.int32),
        tri_tex=t(geom.tri_tex, torch.int32), tri_valid=valid,
        tri_table=tri_table, n_tri=loop_bound(geom.face_valid),
        sph_c=sc, sph_r=sr, sph_mat=t(geom.sph_mat, torch.int32),
        sph_valid=sph_valid, n_sph=loop_bound(geom.sph_valid),
        mat_type=t(mt.type, torch.int32), mat_ka=t(mt.ka, f32),
        mat_kd=t(mt.kd, f32), mat_ks=t(mt.ks, f32),
        mat_spec=t(mt.spec_exp, f32), mat_ior=t(mt.ior, f32),
        mat_emit=t(mt.emission, f32),
        emitter_cr=emitter_cr, n_emitters=n_emit,
        background=t(frame.background, f32), eye=t(frame.eye, f32),
        textures=t(geom.textures, torch.uint8),
        tex_wh=t(geom.tex_wh, torch.int32),
        tex_on_emitter=bool(np.asarray(geom.tex_on_emitter).size),
    )


def rt_scene_from_numpy(arrays: Dict[str, np.ndarray], device) -> RTScene:
    """Build the port's RTScene from the JAX package's RTScene arrays
    (`{k: np.asarray(v) for k, v in rt._asdict().items()}`), so that
    both packages can be fed the identical scene. Fields the port does
    not hold are ignored."""
    device = check_device(device)

    def t(k, dtype):
        return torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)

    f32 = torch.float32
    return RTScene(
        v0=t("v0", f32), v1=t("v1", f32), v2=t("v2", f32),
        n0=t("n0", f32), n1=t("n1", f32), n2=t("n2", f32),
        uv0=t("uv0", f32), uv1=t("uv1", f32), uv2=t("uv2", f32),
        tri_mat=t("tri_mat", torch.int32), tri_tex=t("tri_tex", torch.int32),
        tri_valid=t("tri_valid", torch.bool),
        tri_table=t("tri_table", f32), n_tri=int(arrays["n_tri"]),
        sph_c=t("sph_c", f32), sph_r=t("sph_r", f32),
        sph_mat=t("sph_mat", torch.int32), sph_valid=t("sph_valid", torch.bool),
        n_sph=loop_bound(arrays["sph_valid"]),
        mat_type=t("mat_type", torch.int32), mat_ka=t("mat_ka", f32),
        mat_kd=t("mat_kd", f32), mat_ks=t("mat_ks", f32),
        mat_spec=t("mat_spec", f32), mat_ior=t("mat_ior", f32),
        mat_emit=t("mat_emit", f32),
        emitter_cr=t("emitter_cr", f32), n_emitters=int(arrays["n_emitters"]),
        background=t("background", f32), eye=t("eye", f32),
        textures=t("textures", torch.uint8), tex_wh=t("tex_wh", torch.int32),
        tex_on_emitter=bool(np.asarray(arrays["tex_on_emitter"]).size),
    )
