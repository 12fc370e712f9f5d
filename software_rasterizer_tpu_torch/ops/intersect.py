"""The device scene of the ray-traced pipelines (reference:
Scene::updatePosition, Scene.cpp:882-901; Triangle.cpp:215-231).

The scene is split in two. `prepare_rt_geometry` carries a
`models.scene.RTGeometry` onto a torch device once, as a
`DeviceRTGeometry`: every array no frame changes, the material table and
texture atlas among them, and what the host works out from them (loop
bounds, emitter order). `prepare_rt_scene` then uploads only the frame's
`RTFrame` arrays and transforms that geometry into trace space on the
device; given a host `RTGeometry` it carries it over first. `RTScene`
holds the fields the tracing layers read, the chunk boxes of the
large-scene trace tiers among them. Of the JAX package's fields it
leaves out `mt_coef` (the coefficients of the bilinear matmul form of
Moller-Trumbore, a TPU form: every tier here tests the `tri_table` rows
exactly) and `tex_packed` (no caller yet).

Tracing explicit rays: `nearest_hit` finds the nearest primitive of
every ray and joins the winner's surface properties into a `Hit`;
`nearest_emit_hit` is the emit-only form for visibility rays;
`classify_hit` + `surface_attrs` split the search from the join so an
integrator can compact lanes between them. The triangle search is a tier
chosen by triangle count (`_trace_backend`): `trace_nearest_vpu` up to
1024 triangles, the fused two-level chunk cull `trace_nearest_mm2c` up
to 16,384, the cull prepass and the streamed listed sweep
`trace_nearest_mm2_stream` above; `backend=` names one instead (also
"mm", the unculled chunked sweep `trace_nearest_mm`, taken only by
name, as the JAX package takes it only under SRT_MM_TRACE=1). Every
tier returns the same winners bit for bit; the winner's (u, v, t) are
then recomputed with `_mt_uv`. The JAX package's one-hot joins, its
8-column class gather and its blocking over 8192 lanes work around TPU
costs; here rows are read by index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from software_rasterizer_tpu_torch.ops import trace_kernel, trace_tiers
from software_rasterizer_tpu_torch.ops.bvh import slab_test
from software_rasterizer_tpu_torch.utils.debug import nan_check
from software_rasterizer_tpu_torch.utils.profiling import span

BIG = 1e30

# The triangle search by triangle count (the padded table's rows):
#   <= VPU_TRACE_MAX_TRIS: "vpu", every ray against every row;
#   <= MM_TRACE_MAX_TRIS: "mm2c", chunks of MM2_CHUNK rows in BVH leaf
#       order, culled by a two-level box vote fused into the sweep;
#   above: "mm2s", chunks of MM2S_CHUNK rows, a cull prepass, per-block
#       lists and the double-buffered listed sweep.
# "mm2" (the listed sweep over chunks of the scene's granule) and "mm"
# (every chunk of the table, no boxes) are taken only by name.
VPU_TRACE_MAX_TRIS = 1024
MM_TRACE_MAX_TRIS = 16384
MM2_CHUNK = 128
MM2S_CHUNK = 256
TRACE_BACKENDS = ("vpu", "mm2c", "mm2", "mm2s", "mm")


def _cull_granule(f_pad: int) -> int:
    """Rows of a chunk of `RTScene.chunk_lo/hi`: what `_trace_backend`
    picks for a table of `f_pad` rows sweeps."""
    return MM2_CHUNK if f_pad <= MM_TRACE_MAX_TRIS else MM2S_CHUNK


def _trace_backend(f_pad: int) -> str:
    """The tier `_trace_tris` takes for a table of `f_pad` rows, by the
    count alone, on every device. No upper limit: the JAX package leaves
    its kernels above 2,097,152 triangles for the size of its mask plane,
    and the mask here is a tensor."""
    if f_pad <= VPU_TRACE_MAX_TRIS:
        return "vpu"
    return "mm2c" if f_pad <= MM_TRACE_MAX_TRIS else "mm2s"


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
    tri_obj: torch.Tensor     # (F,) i32 top-level object id
    tri_valid: torch.Tensor   # (F,) bool
    tri_table: torch.Tensor   # (F,12) [v0|e1|e2|pad], invalid rows zero
    n_tri: int                # 1 + last valid triangle index
    chunk_lo: torch.Tensor    # (nc,3) boxes of runs of `cull_chunk` rows of
    chunk_hi: torch.Tensor    # tri_table (BVH leaf order), for the chunk cull
    cull_chunk: int           # rows a chunk (`_cull_granule`)
    sph_c: torch.Tensor       # (S,3) transformed centers
    sph_r: torch.Tensor       # (S,) transformed radii
    sph_mat: torch.Tensor     # (S,) i32
    sph_obj: torch.Tensor     # (S,) i32
    sph_valid: torch.Tensor   # (S,) bool
    n_sph: int                # 1 + last valid sphere index
    mat_type: torch.Tensor    # (M,) i32
    mat_ka: torch.Tensor      # (M,3)
    mat_kd: torch.Tensor      # (M,3)
    mat_ks: torch.Tensor      # (M,3)
    mat_spec: torch.Tensor    # (M,) specular exponent
    mat_ior: torch.Tensor     # (M,)
    mat_emit: torch.Tensor    # (M,3)
    emitter_center: torch.Tensor  # (O,3) bbox centers per object
    emitter_radius: torch.Tensor  # (O,) |bbox diagonal|/2
    emitter_mask: torch.Tensor    # (O,) bool emissive object
    emitter_order: torch.Tensor   # (O,) i32 object ids, emissive first
    emitter_cr: torch.Tensor  # (max(n_emitters,1),4) [center, radius],
                              # emissive objects first
    n_emitters: int
    prim_attr: torch.Tensor   # (F+S,40) per-primitive attribute rows,
                              # triangles then spheres (_pack_prim_tables)
    prim_shadow: torch.Tensor  # (F+S,12) [v0|v1|v2|emit] rows
    prim_cls: torch.Tensor    # (F+S,8) [mat_type, ior, 0...] rows
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


def _pack_prim_tables(tv, tn, tuv, tri_mat, tri_tex, tri_obj, sc, sr, sph_mat,
                      sph_obj, sph_valid, mat_type, mat_ior, mat_kd, mat_emit):
    """prim_attr (F+S,40), prim_shadow (F+S,12) and prim_cls (F+S,8), the
    JAX package's row layouts (ops/intersect.py:241-293): triangle rows
    [v0 v1 v2 | n0 n1 n2 | uv0 uv1 uv2 | kd | emit | mat type | ior | mat
    id | tex id | obj id | is_sphere=0 | pad], sphere rows [center | 0.. |
    kd | emit | type | ior | mat id | -1 | obj id | 1 | radius | pad]."""
    f32 = torch.float32
    dev = tv.device
    f, ns = tv.shape[0], sc.shape[0]
    tm, sm = tri_mat.long(), sph_mat.long()

    def col(x):
        return x[:, None].to(f32)

    tri_rows = torch.cat([
        tv[:, 0], tv[:, 1], tv[:, 2],                         # 0:9
        tn[:, 0], tn[:, 1], tn[:, 2],                         # 9:18
        tuv[:, 0], tuv[:, 1], tuv[:, 2],                      # 18:24
        mat_kd[tm], mat_emit[tm],                             # 24:30
        col(mat_type[tm]), col(mat_ior[tm]),                  # 30, 31
        col(tri_mat), col(tri_tex), col(tri_obj),             # 32, 33, 34
        torch.zeros((f, 5), dtype=f32, device=dev),           # 35 is_sphere, pad
    ], dim=1)
    sph_rows = torch.cat([
        sc, torch.zeros((ns, 21), dtype=f32, device=dev),     # 0:3 center
        mat_kd[sm], mat_emit[sm],                             # 24:30
        col(mat_type[sm]), col(mat_ior[sm]), col(sph_mat),
        torch.full((ns, 1), -1.0, dtype=f32, device=dev),     # 33 tex id
        col(sph_obj),
        torch.ones((ns, 1), dtype=f32, device=dev),           # 35 is_sphere
        col(sr),                                              # 36 radius
        torch.zeros((ns, 3), dtype=f32, device=dev),
    ], dim=1)
    prim_attr = torch.cat([tri_rows, sph_rows], dim=0)
    prim_cls = torch.cat([
        torch.cat([col(mat_type[tm]), col(mat_ior[tm])], dim=1),
        torch.cat([col(mat_type[sm]), col(mat_ior[sm])], dim=1),
    ], dim=0)
    prim_cls = torch.cat(
        [prim_cls, torch.zeros((f + ns, 6), dtype=f32, device=dev)], dim=1)
    prim_shadow = torch.cat([
        torch.cat([tv[:, 0], tv[:, 1], tv[:, 2], mat_emit[tm]], dim=1),
        torch.cat([torch.zeros((ns, 9), dtype=f32, device=dev),
                   torch.where(sph_valid[:, None], mat_emit[sm], 0.0)], dim=1),
    ], dim=0).to(f32)
    return prim_attr, prim_shadow, prim_cls


@dataclasses.dataclass
class DeviceRTGeometry:
    """`models.scene.RTGeometry` on one device in the dtypes `RTScene`
    holds, and what no frame changes: the face-gathered uvs, the loop
    bounds, the emitter order and the objects that the emitter bounds
    reduce over. `prepare_rt_geometry` makes it once per scene and
    pipeline; every draw passes it to `prepare_rt_scene`."""

    positions: torch.Tensor    # (V,3) f32 untransformed
    normals: torch.Tensor      # (V,3) f32
    vertex_mesh: torch.Tensor  # (V,) i64
    faces: torch.Tensor        # (F,3) i64
    tri_uv: torch.Tensor       # (F,3,2) f32 per-corner uvs
    face_valid: torch.Tensor   # (F,) bool
    tri_mat: torch.Tensor      # (F,) i32
    tri_tex: torch.Tensor      # (F,) i32
    tri_obj: torch.Tensor      # (F,) i32
    n_tri: int                 # 1 + last valid triangle index
    sph_center: torch.Tensor   # (S,3) f32 untransformed
    sph_radius: torch.Tensor   # (S,) f32
    sph_mat: torch.Tensor      # (S,) i32
    sph_obj: torch.Tensor      # (S,) i32
    sph_valid: torch.Tensor    # (S,) bool
    n_sph: int                 # 1 + last valid sphere index
    mat_type: torch.Tensor     # (M,) i32
    mat_ka: torch.Tensor       # (M,3) f32
    mat_kd: torch.Tensor       # (M,3)
    mat_ks: torch.Tensor       # (M,3)
    mat_spec: torch.Tensor     # (M,)
    mat_ior: torch.Tensor      # (M,)
    mat_emit: torch.Tensor     # (M,3)
    emitter_mask: torch.Tensor   # (O,) bool emissive object
    emitter_order: torch.Tensor  # (O,) i32 object ids, emissive first
    n_emitters: int
    bound_seg: torch.Tensor    # (3F+S,3) i64 object of each triangle
                               # corner, then sphere; O where invalid
    textures: torch.Tensor     # (K,Hm,Wm,3) u8 atlas
    tex_wh: torch.Tensor       # (K,2) i32 (width, height)
    tex_on_emitter: bool       # an emissive triangle carries a texture


def prepare_rt_geometry(geom, device) -> DeviceRTGeometry:
    """Carry a `models.scene.RTGeometry` (host NumPy) onto `device`."""
    device = check_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    emissive = np.asarray(geom.obj_emissive, bool)
    n_obj = emissive.shape[0]

    def seg(obj, valid):
        return np.where(np.asarray(valid, bool), np.asarray(obj, np.int64), n_obj)

    bound_seg = np.concatenate([np.repeat(seg(geom.tri_obj, geom.face_valid), 3),
                                seg(geom.sph_obj, geom.sph_valid)])
    faces = t(geom.faces, i64)
    mt = geom.materials
    return DeviceRTGeometry(
        positions=t(geom.positions, f32), normals=t(geom.normals, f32),
        vertex_mesh=t(geom.vertex_mesh, i64), faces=faces,
        tri_uv=t(geom.uvs, f32)[faces], face_valid=t(geom.face_valid, torch.bool),
        tri_mat=t(geom.tri_mat, i32), tri_tex=t(geom.tri_tex, i32),
        tri_obj=t(geom.tri_obj, i32), n_tri=loop_bound(geom.face_valid),
        sph_center=t(geom.sph_center, f32), sph_radius=t(geom.sph_radius, f32),
        sph_mat=t(geom.sph_mat, i32), sph_obj=t(geom.sph_obj, i32),
        sph_valid=t(geom.sph_valid, torch.bool), n_sph=loop_bound(geom.sph_valid),
        mat_type=t(mt.type, i32), mat_ka=t(mt.ka, f32), mat_kd=t(mt.kd, f32),
        mat_ks=t(mt.ks, f32), mat_spec=t(mt.spec_exp, f32),
        mat_ior=t(mt.ior, f32), mat_emit=t(mt.emission, f32),
        emitter_mask=t(emissive, torch.bool),
        emitter_order=t(np.argsort(~emissive, kind="stable"), i32),
        n_emitters=int(emissive.sum()),
        bound_seg=t(bound_seg, i64)[:, None].expand(-1, 3),
        textures=t(geom.textures, torch.uint8), tex_wh=t(geom.tex_wh, i32),
        tex_on_emitter=bool(np.asarray(geom.tex_on_emitter).size),
    )


def _emitter_bounds(geom: DeviceRTGeometry, tv, sc, sr):
    """Per-object emitter bounding spheres (sampleLight, Scene.cpp:398-476):
    bbox center + |diagonal|/2 over each object's transformed extent, its
    valid triangles' corners and its valid spheres' boxes. One segment min
    and one max over `geom.bound_seg`; invalid rows land in a spare last
    segment. Min and max are exact, so the result does not depend on
    the order of the reduction."""
    n_obj = geom.emitter_mask.shape[0]
    corners = tv.reshape(-1, 3)
    r = sr[:, None]

    def reduce(fill, pts, how):
        out = torch.full((n_obj + 1, 3), fill, dtype=torch.float32, device=tv.device)
        return out.scatter_reduce_(0, geom.bound_seg, pts, how)[:n_obj]

    lo = reduce(BIG, torch.cat([corners, sc - r]), "amin")
    hi = reduce(-BIG, torch.cat([corners, sc + r]), "amax")
    return (lo + hi) * 0.5, _norm(hi - lo) * 0.5


@span("srt.scene_upload")
def prepare_rt_scene(geom, frame, device) -> RTScene:
    """Transform geometry into trace space (Scene::updatePosition analog).

    geom: a `DeviceRTGeometry` on `device` (`prepare_rt_geometry`), or a
    host `models.scene.RTGeometry`, which is carried there first; frame:
    models.scene.RTFrame (host NumPy), whose arrays are all that goes up
    to the device for a `DeviceRTGeometry`; device: where the scene's
    tensors live."""
    device = check_device(device)
    if not isinstance(geom, DeviceRTGeometry):
        geom = prepare_rt_geometry(geom, device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    pos = hom_transform(t(frame.mvp)[geom.vertex_mesh], geom.positions)
    nm = t(frame.normal_mat3)[geom.vertex_mesh]
    nv = geom.normals
    nrm = (nm[:, :, 0] * nv[:, 0:1] + nm[:, :, 1] * nv[:, 1:2]
           + nm[:, :, 2] * nv[:, 2:3])
    nrm = nrm / torch.clamp(_norm(nrm, keepdim=True), min=1e-20)

    tv = pos[geom.faces]   # (F,3,3)
    tn = nrm[geom.faces]
    tuv = geom.tri_uv      # (F,3,2)
    valid = geom.face_valid

    sc = hom_transform(t(frame.sph_mvp), geom.sph_center)
    sr = geom.sph_radius * t(frame.sph_scale)

    centers, radii = _emitter_bounds(geom, tv, sc, sr)
    emitter_cr = torch.cat([centers, radii[:, None]], dim=1).index_select(
        0, geom.emitter_order[: max(geom.n_emitters, 1)])

    tri_table = mt_tri_table(tv[:, 0], tv[:, 1], tv[:, 2], valid)
    cull_chunk = _cull_granule(tv.shape[0])
    chunk_lo, chunk_hi = trace_tiers.chunk_bounds(
        tv[:, 0], tv[:, 1], tv[:, 2], valid, cull_chunk)
    prim_attr, prim_shadow, prim_cls = _pack_prim_tables(
        tv, tn, tuv, geom.tri_mat, geom.tri_tex, geom.tri_obj, sc, sr,
        geom.sph_mat, geom.sph_obj, geom.sph_valid, geom.mat_type,
        geom.mat_ior, geom.mat_kd, geom.mat_emit)
    return RTScene(
        v0=tv[:, 0], v1=tv[:, 1], v2=tv[:, 2],
        n0=tn[:, 0], n1=tn[:, 1], n2=tn[:, 2],
        uv0=tuv[:, 0], uv1=tuv[:, 1], uv2=tuv[:, 2],
        tri_mat=geom.tri_mat, tri_tex=geom.tri_tex, tri_obj=geom.tri_obj,
        tri_valid=valid,
        tri_table=tri_table, n_tri=geom.n_tri,
        chunk_lo=chunk_lo, chunk_hi=chunk_hi, cull_chunk=cull_chunk,
        sph_c=sc, sph_r=sr, sph_mat=geom.sph_mat, sph_obj=geom.sph_obj,
        sph_valid=geom.sph_valid, n_sph=geom.n_sph,
        mat_type=geom.mat_type, mat_ka=geom.mat_ka, mat_kd=geom.mat_kd,
        mat_ks=geom.mat_ks, mat_spec=geom.mat_spec, mat_ior=geom.mat_ior,
        mat_emit=geom.mat_emit,
        emitter_center=centers, emitter_radius=radii,
        emitter_mask=geom.emitter_mask, emitter_order=geom.emitter_order,
        emitter_cr=emitter_cr, n_emitters=geom.n_emitters,
        prim_attr=prim_attr, prim_shadow=prim_shadow, prim_cls=prim_cls,
        background=t(frame.background), eye=t(frame.eye),
        textures=geom.textures, tex_wh=geom.tex_wh,
        tex_on_emitter=geom.tex_on_emitter,
    )


def rt_scene_from_numpy(arrays: Dict[str, np.ndarray], device) -> RTScene:
    """Build the port's RTScene from the JAX package's RTScene arrays
    (`{k: np.asarray(v) for k, v in rt._asdict().items()}`), so that
    both packages can be fed the identical scene. Fields the port does
    not hold (`mt_coef`, `tex_packed`) are ignored."""
    device = check_device(device)

    def t(k, dtype):
        return torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)

    f32 = torch.float32
    return RTScene(
        v0=t("v0", f32), v1=t("v1", f32), v2=t("v2", f32),
        n0=t("n0", f32), n1=t("n1", f32), n2=t("n2", f32),
        uv0=t("uv0", f32), uv1=t("uv1", f32), uv2=t("uv2", f32),
        tri_mat=t("tri_mat", torch.int32), tri_tex=t("tri_tex", torch.int32),
        tri_obj=t("tri_obj", torch.int32), tri_valid=t("tri_valid", torch.bool),
        tri_table=t("tri_table", f32), n_tri=int(arrays["n_tri"]),
        chunk_lo=t("chunk_lo", f32), chunk_hi=t("chunk_hi", f32),
        cull_chunk=_cull_granule(np.asarray(arrays["v0"]).shape[0]),
        sph_c=t("sph_c", f32), sph_r=t("sph_r", f32),
        sph_mat=t("sph_mat", torch.int32), sph_obj=t("sph_obj", torch.int32),
        sph_valid=t("sph_valid", torch.bool),
        n_sph=loop_bound(arrays["sph_valid"]),
        mat_type=t("mat_type", torch.int32), mat_ka=t("mat_ka", f32),
        mat_kd=t("mat_kd", f32), mat_ks=t("mat_ks", f32),
        mat_spec=t("mat_spec", f32), mat_ior=t("mat_ior", f32),
        mat_emit=t("mat_emit", f32),
        emitter_center=t("emitter_center", f32),
        emitter_radius=t("emitter_radius", f32),
        emitter_mask=t("emitter_mask", torch.bool),
        emitter_order=t("emitter_order", torch.int32),
        emitter_cr=t("emitter_cr", f32), n_emitters=int(arrays["n_emitters"]),
        prim_attr=t("prim_attr", f32), prim_shadow=t("prim_shadow", f32),
        prim_cls=t("prim_cls", f32),
        background=t("background", f32), eye=t("eye", f32),
        textures=t("textures", torch.uint8), tex_wh=t("tex_wh", torch.int32),
        tex_on_emitter=bool(np.asarray(arrays["tex_on_emitter"]).size),
    )


# ------------------------------------------------- tracing explicit rays


class Hit(NamedTuple):
    """Intersection record SoA (reference: Intersection.hpp:12-29, with
    the winner's material constants joined in so integrators need no
    further table lookups)."""

    hit: torch.Tensor        # (N,) bool
    t: torch.Tensor          # (N,) f32 (BIG when miss)
    is_sphere: torch.Tensor  # (N,) bool
    prim: torch.Tensor       # (N,) i64 primitive index
    bary_u: torch.Tensor     # (N,) f32 (triangles)
    bary_v: torch.Tensor     # (N,)
    coords: torch.Tensor     # (N,3)
    normal: torch.Tensor     # (N,3) interpolated/analytic, normalized
    color: torch.Tensor      # (N,3) getDiffuseColor (tex/Kd); 0 for spheres
    emit: torch.Tensor       # (N,3)
    mat: torch.Tensor        # (N,) i64
    obj: torch.Tensor        # (N,) i64
    kd: torch.Tensor         # (N,3) material Kd of the winner
    mat_type: torch.Tensor   # (N,) i64 MaterialType of the winner
    ior: torch.Tensor        # (N,) f32
    # texture identity of the winner, for deferred color fetches
    # (defer_color=True returns color=Kd); -1 for spheres/untextured,
    # tuv zeroed when `lite`
    tex: torch.Tensor        # (N,) i64
    tuv: torch.Tensor        # (N,2) f32


class ShadowHit(NamedTuple):
    """Minimal record for emit-only visibility rays (the Whitted shadow
    test needs only whether the NEAREST hit is emissive and its t,
    Scene.cpp:522-545)."""

    hit: torch.Tensor   # (N,) bool
    t: torch.Tensor     # (N,) f32 (BIG on miss)
    emit: torch.Tensor  # (N,3)


class LiteHit(NamedTuple):
    """Winner + material CLASS only, no attribute join: `classify_hit`'s
    output, enough to build an integrator's branch masks and to compact
    lanes before `surface_attrs`."""

    hit: torch.Tensor       # (N,) bool
    use_s: torch.Tensor     # (N,) bool: the winner is a sphere
    tri: torch.Tensor       # (N,) i64 triangle winner (clamped >= 0)
    sph: torch.Tensor       # (N,) i64 sphere winner (clamped >= 0)
    t_tri: torch.Tensor     # (N,) f32 the trace kernel's winner t (BIG on miss)
    st: torch.Tensor        # (N,) f32 exact sphere t (BIG on miss)
    mat_type: torch.Tensor  # (N,) i64 winner MaterialType


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of (...,3) tensors, summed left to right (one order
    on every device)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _mt_uv(orig, d, v0, v1, v2):
    """Exact (u, v, t) of rays (N,3) against their per-ray winning
    triangle (N,3): the O(N) epilogue of the winner search."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = _cross3(d, e2)
    det = _dot3(e1, p)
    inv = 1.0 / torch.where(det.abs() < 1e-6, 1.0, det)
    tvec = orig - v0
    u = _dot3(tvec, p) * inv
    q = _cross3(tvec, e1)
    v = _dot3(d, q) * inv
    t = _dot3(e2, q) * inv
    return u, v, t


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (N,K); zero rows for an empty table."""
    if table.shape[0] == 0:
        return torch.zeros((idx.shape[0], table.shape[1]), dtype=table.dtype,
                           device=table.device)
    return table[idx]


def _trace_tris(scene: RTScene, orig, d, backend: Optional[str] = None):
    """Winner search over triangles: (tri_hit (N,) bool, idx (N,) i64 with
    -1 on a miss, t (N,) f32 with BIG on a miss), from the tier
    `_trace_backend` picks for the scene's table or the one `backend`
    names (`TRACE_BACKENDS`): its kernel on CUDA tensors, its
    plain version on CPU tensors. Every tier gives the same three tensors
    bit for bit. The returned t is the kernel's own; callers that need the
    oracle's t recompute it for the winner with `_mt_uv`."""
    backend = backend or _trace_backend(scene.v0.shape[0])
    stage = f"nearest_hit's trace tier {backend!r}"
    if backend == "vpu":
        return nan_check(stage, trace_kernel.trace_nearest_vpu(
            scene.tri_table, scene.n_tri, orig, d))
    if backend == "mm":
        return nan_check(stage, trace_tiers.trace_nearest_mm(scene.tri_table, orig, d))
    tiers = {"mm2c": trace_tiers.trace_nearest_mm2c,
             "mm2": trace_tiers.trace_nearest_mm2,
             "mm2s": trace_tiers.trace_nearest_mm2_stream}
    if backend not in tiers:
        raise ValueError(f"unknown trace backend {backend!r}; expected one of "
                         f"{TRACE_BACKENDS}")
    return nan_check(stage, tiers[backend](
        scene.tri_table, scene.chunk_lo, scene.chunk_hi, orig, d, chunk=scene.cull_chunk))


# (ray, triangle) tests of one plane of `_intersect_tri_raw`
_RAW_PLANE = 1 << 22


def _intersect_tri_raw(orig, d, v0, v1, v2, valid, chunk: int = 512,
                       cull_chunks: bool = True):
    """Winner search in plain tensor code (the JAX package's XLA sweep):
    (hit (N,) bool, idx (N,) i64 with -1 on a miss, t (N,) f32 with BIG on
    a miss). Triangles in chunks of `chunk`; with `cull_chunks` a chunk
    whose box no ray enters (`ops/bvh.slab_test`) is skipped, which is
    exact because the test is conservative. The rays are taken in slices
    that keep a (rays, chunk) plane to `_RAW_PLANE` elements; a slice
    culls for itself, so the slicing changes no result."""
    f, n, dev = v0.shape[0], orig.shape[0], orig.device
    chunk = max(1, min(chunk, f))
    n_chunks = -(-f // chunk)
    cull = cull_chunks and n_chunks > 1
    if cull:
        chunk_lo, chunk_hi = trace_tiers.chunk_bounds(v0, v1, v2, valid, chunk)
    table = mt_tri_table(v0, v1, v2, valid)     # an invalid row is zero: det = 0
    bt = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    step = max(1, _RAW_PLANE // chunk)
    for r0 in range(0, n, step):
        o_, d_ = orig[r0:r0 + step], d[r0:r0 + step]
        st, si = bt[r0:r0 + step], bi[r0:r0 + step]      # views: updated in place
        for ci in range(n_chunks):
            s = ci * chunk
            if cull and not bool(slab_test(o_, d_, chunk_lo[ci:ci + 1],
                                           chunk_hi[ci:ci + 1]).any()):
                continue
            ct, ca = trace_kernel.plane_winner(
                trace_kernel.mt_plane(o_, d_, table[s:s + chunk]))
            better = ct < st
            si.copy_(torch.where(better, ca + s, si))
            st.copy_(torch.where(better, ct, st))
    hit = bt < BIG
    return hit, torch.where(hit, bi, -1), bt


def intersect_triangles(orig, d, v0, v1, v2, valid, chunk: int = 512,
                        cull_chunks: bool = True):
    """Nearest triangle per ray by the chunked sweep `_intersect_tri_raw`.
    Returns (t, idx, u, v) each (N,); idx = -1 / t = BIG on a miss."""
    hit, i, _ = _intersect_tri_raw(orig, d, v0, v1, v2, valid, chunk,
                                   cull_chunks)
    c = torch.clamp(i, min=0)
    u, v, t = _mt_uv(orig, d, _rows(v0, c), _rows(v1, c), _rows(v2, c))
    return torch.where(hit, t, BIG), i, u, v


def intersect_spheres(orig, d, centers, radii, valid, t_min: float = 0.0):
    """Nearest sphere per ray (Sphere.cpp:106-146, numerically stable
    roots). Returns (t, idx) each (N,); t = BIG / idx = -1 on a miss.
    t_min=0 reproduces the reference's strict t0 > 0 acceptance."""
    n, s = orig.shape[0], centers.shape[0]
    if s == 0:
        return (torch.full((n,), BIG, dtype=orig.dtype, device=orig.device),
                torch.full((n,), -1, dtype=torch.int64, device=orig.device))
    lx = orig[:, 0:1] - centers[None, :, 0]           # (N,S) planes
    ly = orig[:, 1:2] - centers[None, :, 1]
    lz = orig[:, 2:3] - centers[None, :, 2]
    a = _dot3(d, d)[:, None]                          # (N,1)
    b = 2.0 * (d[:, 0:1] * lx + d[:, 1:2] * ly + d[:, 2:3] * lz)
    c = lx * lx + ly * ly + lz * lz - (radii * radii)[None]
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    q = torch.where(q == 0.0, 1e-30, q)
    x0 = q / a
    x1 = c / q
    both = (x0 > t_min) & (x1 > t_min)
    t = torch.where(both, torch.minimum(x0, x1), torch.where(x0 > t_min, x0, x1))
    ok = (disc >= 0.0) & (t > t_min) & valid[None]
    t = torch.where(ok, t, BIG)
    bt = t.min(dim=1).values
    # the lowest index among equal t (torch.min may return any of them)
    first = (t == bt[:, None]).to(torch.int8).argmax(dim=1)
    return bt, torch.where(bt < BIG, first, -1)


def nearest_emit_hit(scene: RTScene, orig, d,
                     backend: Optional[str] = None) -> ShadowHit:
    """Nearest hit with the minimal epilogue: the winner's exact t
    (`_mt_uv`) and its emission from `prim_shadow` ([v0|v1|v2|emit]
    rows). Shadow rays need no normals, uv, materials or textures.
    `backend`: see `_trace_tris`."""
    f_pad = scene.v0.shape[0]
    tri_hit, ti, _ = _trace_tris(scene, orig, d, backend)
    a = _rows(scene.prim_shadow[:f_pad], torch.clamp(ti, min=0))
    _, _, t_tri = _mt_uv(orig, d, a[:, 0:3], a[:, 3:6], a[:, 6:9])
    tt = torch.where(tri_hit, t_tri, BIG)
    st, si = intersect_spheres(orig, d, scene.sph_c, scene.sph_r,
                               scene.sph_valid, 0.0)
    use_s = st < tt
    t = torch.where(use_s, st, tt)
    s_emit = _rows(scene.prim_shadow[f_pad:, 9:12], torch.clamp(si, min=0))
    emit = torch.where(use_s[:, None], s_emit, a[:, 9:12])
    return ShadowHit(hit=t < BIG, t=t, emit=emit)


def _surface(scene: RTScene, orig, d, hit, use_s, tidx, sidx, st, lite: bool,
             defer_color: bool, exact_pick: bool) -> Hit:
    """The surface-property join shared by `nearest_hit` and
    `surface_attrs` (Triangle.cpp:160-177, Sphere.cpp:148-154): the
    winner's exact (u, v, t), hit point, normal, uv and colour.

    `exact_pick`: triangle against sphere by the exact recomputed t
    (`nearest_hit`); otherwise `use_s` and `hit` are the caller's
    (`surface_attrs`)."""
    from software_rasterizer_tpu_torch.ops.texture_ops import fetch_nearest

    f_pad = scene.v0.shape[0]
    a_tri = _rows(scene.prim_attr[:f_pad], tidx)
    tu, tv, t_tri = _mt_uv(orig, d, a_tri[:, 0:3], a_tri[:, 3:6], a_tri[:, 6:9])
    if exact_pick:
        tt = torch.where(hit, t_tri, BIG)     # `hit` is the triangle hit here
        use_s = st < tt
        t = torch.where(use_s, st, tt)
        hit = t < BIG
    else:
        t = torch.where(hit, torch.where(use_s, st, t_tri), BIG)
    coords = orig + d * t[:, None]
    a = torch.where(use_s[:, None], _rows(scene.prim_attr[f_pad:], sidx), a_tri)
    n0, n1, n2 = a[:, 9:12], a[:, 12:15], a[:, 15:18]
    kd = a[:, 24:27]
    tex = a[:, 33].round().long()

    w = 1.0 - tu - tv
    tn = w[:, None] * n0 + tu[:, None] * n1 + tv[:, None] * n2
    tn = tn / torch.clamp(_norm(tn, keepdim=True), min=1e-20)
    if lite:
        tcol = torch.zeros_like(coords)
        tuv_i = torch.zeros((coords.shape[0], 2), dtype=coords.dtype,
                            device=coords.device)
    else:
        tuv_i = (w[:, None] * a[:, 18:20] + tu[:, None] * a[:, 20:22]
                 + tv[:, None] * a[:, 22:24])
        if defer_color:
            tcol = kd
        else:
            tcol = torch.where(
                (tex >= 0)[:, None],
                fetch_nearest(scene.textures, scene.tex_wh, tex, tuv_i), kd)

    # spheres: the analytic normal only; Properties.color stays (0,0,0),
    # a faithful quirk (Object.hpp:36-40). Sphere rows carry the centre
    # in columns 0:3
    sn = coords - a[:, 0:3]
    sn = sn / torch.clamp(_norm(sn, keepdim=True), min=1e-20)
    return Hit(
        hit=hit, t=t, is_sphere=use_s, prim=torch.where(use_s, sidx, tidx),
        bary_u=tu, bary_v=tv, coords=coords,
        normal=torch.where(use_s[:, None], sn, tn),
        color=torch.where(use_s[:, None], 0.0, tcol),
        emit=a[:, 27:30], mat=a[:, 32].round().long(),
        obj=a[:, 34].round().long(), kd=kd,
        mat_type=a[:, 30].round().long(), ior=a[:, 31], tex=tex, tuv=tuv_i)


def nearest_hit(scene: RTScene, orig, d, sphere_t_min: float = 0.0,
                lite: bool = False, defer_color: bool = False,
                backend: Optional[str] = None) -> Hit:
    """Scene::traceScene (Scene.cpp:349-396): nearest over all primitives,
    then the surface properties of the winner (barycentric normal/uv and
    diffuse colour for triangles, analytic normal and zero colour for
    spheres). orig/d: (N,3) float32 on the scene's device.

    `lite=True` skips the uv and colour path: visibility rays need only
    (hit, t, coords, normal, emit). `defer_color=True` skips only the
    texel fetch (color = Kd) and returns the winner's (tex, tuv).
    `backend` names the triangle search (one of `TRACE_BACKENDS`) in
    place of the one the triangle count picks; the result is the same."""
    tri_hit, ti, _ = _trace_tris(scene, orig, d, backend)
    st, si = intersect_spheres(orig, d, scene.sph_c, scene.sph_r,
                               scene.sph_valid, sphere_t_min)
    return _surface(scene, orig, d, tri_hit, None, torch.clamp(ti, min=0),
                    torch.clamp(si, min=0), st, lite, defer_color, True)


def classify_hit(scene: RTScene, orig, d,
                 backend: Optional[str] = None) -> LiteHit:
    """Nearest-winner search and material class WITHOUT surface
    attributes. The triangle-against-sphere pick compares the trace
    kernel's triangle t with the exact sphere t, where `nearest_hit`
    compares the `_mt_uv` recompute; the two t agree to rounding, so only
    a triangle and a sphere that coincide within an ulp can pick the other
    primitive, and the values stay exact (`surface_attrs` recomputes
    them). `backend`: see `_trace_tris`."""
    f_pad = scene.v0.shape[0]
    tri_hit, ti, tk = _trace_tris(scene, orig, d, backend)
    tt = torch.where(tri_hit, tk, BIG)
    st, si = intersect_spheres(orig, d, scene.sph_c, scene.sph_r,
                               scene.sph_valid, 0.0)
    use_s = st < tt
    hit = torch.where(use_s, st, tt) < BIG
    tidx, sidx = torch.clamp(ti, min=0), torch.clamp(si, min=0)
    cls = scene.prim_cls[torch.where(use_s, f_pad + sidx, tidx)]
    return LiteHit(hit=hit, use_s=use_s, tri=tidx, sph=sidx, t_tri=tt, st=st,
                   mat_type=cls[:, 0].round().long())


def surface_attrs(scene: RTScene, orig, d, lh: LiteHit, lite: bool = False,
                  defer_color: bool = False) -> Hit:
    """The surface-property join of `nearest_hit` for ALREADY CLASSIFIED
    winners (the same formulas), so an integrator can compact lanes
    between the winner search and the join. Per-lane outputs equal
    nearest_hit's wherever the classify pick agrees."""
    return _surface(scene, orig, d, lh.hit, lh.use_s, lh.tri, lh.sph, lh.st,
                    lite, defer_color, False)
