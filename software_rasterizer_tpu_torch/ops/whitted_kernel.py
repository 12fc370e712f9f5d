"""Whitted über-kernel (the port of the JAX package's
`ops/pallas_whitted.whitted_uber_trace` / `_uber_kernel`, with
`ops/whitted._apply_tex_slots` folded in).

One call walks every lane's whole Whitted tree (Scene::whittedRayTracing,
Scene.cpp:478-617) from its (origin, direction) pair: nearest hit over
triangles and spheres; a miss adds weight * background; a diffuse hit
adds the Phong term toward an emitter's centre behind a shadow trace; a
mirror or glass hit below `max_depth` continues into its
reflect child and, for glass with a refraction, pushes the refract
child onto the lane's stack; a lane with nothing to continue pops its
stack and stops when it is empty. A specular hit at `max_depth` adds
nothing (the reference's black depth cap).

  * `whitted_uber_trace`: the entry point. On CUDA tensors it launches
    the hand-written kernel (csrc/whitted_uber.cu) and counts the launch
    in `LAUNCHES`; on CPU tensors it runs the plain version.
  * `whitted_uber_trace_plain`: the same computation in plain PyTorch,
    vectorized over lanes, looping while any lane is live, over spans of
    triangle rows as (lanes, rows) planes and over spheres, in the
    kernel's operation order.

Two tiers of the triangle search (`cull`, as in the path kernels,
ops/path_kernel.use_cull): every row, or, above 512 rows unless the
caller names a tier, the culled walk in which the main ray and the shadow
ray each test only the rows of the chunks whose boxes they enter (the
kernel's warp walk, modelled by `trace_tiers.warp_walk_plain`). The two
agree pixel for pixel.

The kernel's step is warp-uniform: each warp takes one DFS step of all
its live lanes a pass, one main trace and then the shadow traces, as the
plain version steps all lanes a pass (`warp_step_plain` models the
warps' schedule).

Several emitters (the JAX package serves these by its wavefront,
ops/whitted.py:214-265): a ray carries the id `rid`, the absolute pixel
id (`lane_offset` + lane) at depth 0, 2 rid + 1 for a reflect child and
2 rid + 2 for a refract child. At a diffuse hit of depth d, sample s
picks emitter min(floor(u * n_e), n_e - 1) with u =
lane_uniforms(fold_in(key, d), rid, s); the term is
sum_o count_o * v(o) / spp in ascending o, v(o) the Phong term toward
emitter o's centre (for spp = 1 that is v of the one pick). The host
passes the (max_depth+1, spp) table of the picks' 32-bit seeds. The
kernel has no cap on the number of emitters. With one emitter every pick
lands on it and the frame reads neither the key nor spp.

Unlike the TPU kernel, a textured diffuse hit fetches its texel in
place (Kd := texel) instead of deferring it through per-lane slots, so
nothing can overflow; the nearest hit is exact Moller-Trumbore (the CPU
wavefront's arithmetic), not the bilinear MXU form.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from software_rasterizer_tpu_torch.ops.intersect import RTScene
from software_rasterizer_tpu_torch.ops.path_kernel import (
    _as_f32_rows,
    _check_cull,
    _check_table,
    _norm3,
    pack_cull_tables,
    use_cull,
)
from software_rasterizer_tpu_torch.ops.trace_tiers import WARP, CullTables, walk_nearest_plain
from software_rasterizer_tpu_torch.ops.texture_ops import fetch_nearest
from software_rasterizer_tpu_torch.utils.debug import nan_check
from software_rasterizer_tpu_torch.utils.rng import _M32, fold_in, hash_uniform, key_bits

EPS = 1e-5          # Scene.hpp:160
BIG = 1e30
SHADOW_BIAS = 1e-4  # shadow-ray offset scale (ops/whitted re-exports both)
# compile-time bound of the kernel's per-thread stack (csrc/whitted_uber.cu
# kMaxDepth): a refract child is pushed at most once per depth level, and
# the kernel sizes the stack by the smallest of 8, 16 and 32 entries that
# holds max_depth
MAX_DEPTH = 32
ATTR_COLS = 40
SPH_COLS = 24

# attr table columns (the JAX package's pack_uber_tables row layout)
_A_V0, _A_N0, _A_UV0 = 0, 9, 18
_A_KD, _A_EMIT = 24, 27
_A_MTYPE, _A_IOR, _A_TEX = 30, 31, 32
_A_KA, _A_KS, _A_SPEC = 33, 36, 39

# kernel launches made by whitted_uber_trace, full sweep and culled walk
# (the plain version is not counted); a caller may reset them to 0 to
# count one run
LAUNCHES = 0
LAUNCHES_CULLED = 0

# the kernel's optional (2, 3) int64 tally: a row for the main rays and
# one for the shadow rays, each [(ray, row) tests, slab tests, row-test
# slots the warps issued]; the SIMT efficiency of a trace is tests / slots
TALLY_ROWS = ("main", "shadow")
TALLY_COLUMNS = ("row_tests", "slab_tests", "slots")


def pack_whitted_tables(scene: RTScene) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, int, int]:
    """Kernel operand tables: tri_table (F,12) [v0|e1|e2|pad], attr (F,40)
    with the rows of pack_uber_tables (ops/pallas_whitted.py:123-138;
    Kd/emit/Ka/Ks zeroed on invalid rows), sph (S,24) laid out as at
    :145-161, and the loop bounds n_tri and n_sph."""
    f32 = torch.float32
    tm = scene.tri_mat.long()
    sm = scene.sph_mat.long()
    tv = scene.tri_valid[:, None]
    sv = scene.sph_valid[:, None]
    s = scene.sph_c.shape[0]
    attr = torch.cat([
        scene.v0, scene.v1, scene.v2,                          # 0:9
        scene.n0, scene.n1, scene.n2,                          # 9:18
        scene.uv0, scene.uv1, scene.uv2,                       # 18:24
        torch.where(tv, scene.mat_kd[tm], 0.0),                # 24:27
        torch.where(tv, scene.mat_emit[tm], 0.0),              # 27:30
        scene.mat_type[tm][:, None].to(f32),                   # 30
        scene.mat_ior[tm][:, None],                            # 31
        scene.tri_tex[:, None].to(f32),                        # 32
        torch.where(tv, scene.mat_ka[tm], 0.0),                # 33:36
        torch.where(tv, scene.mat_ks[tm], 0.0),                # 36:39
        scene.mat_spec[tm][:, None],                           # 39
    ], dim=1).to(f32).contiguous()
    sph = torch.cat([
        scene.sph_c,                                           # 0:3
        scene.sph_r[:, None],                                  # 3
        torch.where(sv, scene.mat_emit[sm], 0.0),              # 4:7
        sv.to(f32),                                            # 7
        scene.mat_type[sm][:, None].to(f32),                   # 8
        scene.mat_ior[sm][:, None],                            # 9
        torch.where(sv, scene.mat_ka[sm], 0.0),                # 10:13
        torch.where(sv, scene.mat_ks[sm], 0.0),                # 13:16
        scene.mat_spec[sm][:, None],                           # 16
        torch.zeros((s, 7), dtype=f32, device=scene.device),   # 17:24
    ], dim=1).to(f32).contiguous()
    return (scene.tri_table.to(f32).contiguous(), attr, sph, scene.n_tri,
            scene.n_sph)


def whitted_scalars(scene: RTScene, shadow_bias: float) -> torch.Tensor:
    """(8,) [emitter centre | background | shadow_bias | any emitter]
    (ops/pallas_whitted.py:840-847)."""
    extra = torch.tensor([shadow_bias, float(scene.n_emitters > 0)],
                         dtype=torch.float32, device=scene.device)
    return torch.cat([scene.emitter_cr[0, 0:3].float(),
                      scene.background.float(), extra])


def pick_seed_table(key, max_depth: int, spp: int) -> np.ndarray:
    """(max_depth+1, spp) int32: the seed of the emitter pick of sample s
    at depth d, key_bits(fold_in(fold_in(key, d), s)): what the JAX
    package's `lane_uniforms(fold_in(key, d), rid, s)` hashes rid with."""
    depth_keys = fold_in(key, np.arange(max_depth + 1))              # (D,2)
    return np.stack([key_bits(fold_in(k, np.arange(max(spp, 1))))
                     for k in depth_keys]).view(np.int32)


def _pick_emitter(rid: torch.Tensor, seed: int, n_e: int) -> torch.Tensor:
    """The emitter a ray of id `rid` (int64 holding a 32-bit word) picks
    under the 32-bit `seed`."""
    u = hash_uniform(rid, seed)
    return torch.clamp(torch.floor(u * float(n_e)).to(torch.int64), max=n_e - 1)


def check_max_depth(max_depth: int) -> None:
    if not 0 <= max_depth <= MAX_DEPTH:
        raise ValueError(
            f"max_depth={max_depth} is outside [0, {MAX_DEPTH}], the Whitted "
            f"kernel's per-thread stack bound")


def _check_rays(orig: torch.Tensor, d: torch.Tensor) -> int:
    if orig.dim() != 2 or orig.shape[1] != 3 or d.shape != orig.shape:
        raise ValueError(f"rays must be (N,3); got {tuple(orig.shape)} and "
                         f"{tuple(d.shape)}")
    return orig.shape[0]


# ---------------------------------------------------------------- CUDA


def _cuda_fn():
    from software_rasterizer_tpu_torch.utils.cuda_build import load_library

    lib = load_library("whitted_uber", ["whitted_uber.cu"])
    fn = lib.srt_whitted_uber
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 12 + [ci] * 9 + [vp] * 4 + [ci] * 2 + [vp, vp]
        fn.restype = ci
    return fn


def build_kernel() -> None:
    """Compile (or reuse) and load the CUDA library."""
    _cuda_fn()


def launch_whitted_uber(tri: torch.Tensor, attr: torch.Tensor,
                        sph: torch.Tensor, scal: torch.Tensor,
                        atlas: torch.Tensor, tex_wh: torch.Tensor,
                        orig: torch.Tensor, d: torch.Tensor, *, n_tri: int,
                        n_sph: int, max_depth: int,
                        ecr: torch.Tensor = None,
                        pick_seeds: torch.Tensor = None, n_emitters: int = 1,
                        lane_offset: int = 0,
                        cull_tables: Optional[CullTables] = None,
                        tally: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/whitted_uber.cu on the current stream; returns rgb
    (N,3) float32 and nray (2,N) int32. `ecr` (O,4) and `pick_seeds`
    (max_depth+1, spp) int32 are read only when n_emitters > 1. With
    `cull_tables` a culled instance runs; a `tally` (2, 3) int64 gets the
    (ray, row) tests, slab tests and row-test slots of the main rays (row
    0) and of the shadow rays (row 1) added (`TALLY_ROWS`,
    `TALLY_COLUMNS`). Checks every operand and raises on a launch
    error."""
    global LAUNCHES, LAUNCHES_CULLED
    device = tri.device
    if device.type != "cuda":
        raise ValueError(f"launch_whitted_uber needs CUDA tensors, got {device}")
    check_max_depth(max_depth)
    f32 = torch.float32
    _check_table("tri_table", tri, f32, 12, device)
    _check_table("attr", attr, f32, ATTR_COLS, device)
    _check_table("sph", sph, f32, SPH_COLS, device)
    _check_table("scal", scal, f32, None, device)
    _check_table("textures", atlas, torch.uint8, None, device)
    _check_table("tex_wh", tex_wh, torch.int32, 2, device)
    _check_table("orig", orig, f32, 3, device)
    _check_table("dir", d, f32, 3, device)
    n = _check_rays(orig, d)
    if scal.shape != (8,):
        raise ValueError("scal must be (8,)")
    if atlas.dim() != 4 or atlas.shape[3] != 3 or atlas.shape[0] != tex_wh.shape[0]:
        raise ValueError(f"textures {tuple(atlas.shape)} disagree with tex_wh "
                         f"{tuple(tex_wh.shape)}")
    if attr.shape[0] != tri.shape[0] or not 0 <= n_tri <= tri.shape[0]:
        raise ValueError("triangle tables disagree with n_tri")
    if not 0 <= n_sph <= sph.shape[0]:
        raise ValueError("n_sph exceeds the sphere table")
    if n >= 2 ** 31 or not 0 <= lane_offset < 2 ** 31 - n:
        raise ValueError("too many rays: lane ids must fit int32")
    spp = 1
    if n_emitters > 1:
        _check_table("emitter_cr", ecr, f32, 4, device)
        _check_table("pick_seeds", pick_seeds, torch.int32, None, device)
        if ecr.shape[0] < n_emitters:
            raise ValueError("emitter table has fewer rows than emitters")
        if pick_seeds.dim() != 2 or pick_seeds.shape[0] != max_depth + 1 \
                or pick_seeds.shape[1] < 1:
            raise ValueError(f"pick_seeds has shape {tuple(pick_seeds.shape)}, "
                             f"expected ({max_depth + 1}, spp)")
        spp = pick_seeds.shape[1]
    cull_args = _check_cull(cull_tables, n_tri, device)
    tally_ptr = None
    if tally is not None:
        _check_table("tally", tally, torch.int64, None, device)
        want = (len(TALLY_ROWS), len(TALLY_COLUMNS))
        if tally.shape != want:
            raise ValueError(f"tally has shape {tuple(tally.shape)}, expected {want}: "
                             f"rows {TALLY_ROWS} x columns {TALLY_COLUMNS}")
        tally_ptr = tally.data_ptr()
    rgb = torch.empty((n, 3), dtype=f32, device=device)
    nray = torch.empty((2, n), dtype=torch.int32, device=device)
    if n == 0:
        return rgb, nray
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _cuda_fn()(
        tri.data_ptr(), attr.data_ptr(), sph.data_ptr(), scal.data_ptr(),
        ecr.data_ptr() if n_emitters > 1 else None,
        pick_seeds.data_ptr() if n_emitters > 1 else None,
        atlas.data_ptr(), tex_wh.data_ptr(), orig.data_ptr(), d.data_ptr(),
        rgb.data_ptr(), nray.data_ptr(),
        n_tri, n_sph, n, atlas.shape[1], atlas.shape[2], max_depth,
        n_emitters, spp, lane_offset, *cull_args, tally_ptr, stream,
    )
    if rc != 0:
        raise RuntimeError(f"whitted_uber kernel launch failed: cudaError {rc}")
    if cull_tables is None:
        LAUNCHES += 1
    else:
        LAUNCHES_CULLED += 1
    return rgb, nray


def whitted_launch_args(scene: RTScene, orig: torch.Tensor, d: torch.Tensor,
                        max_depth: int = 5, shadow_bias: float = SHADOW_BIAS,
                        key=0, spp: int = 1, lane_offset: int = 0,
                        cull: Optional[bool] = None) -> Tuple[tuple, dict]:
    """The operands of `launch_whitted_uber` for the rays `orig`, `d` of a
    CUDA `scene`, as (positional, keyword) arguments: the packed tables,
    the emitter picks' seeds where the scene has several emitters, and the
    chunk tables where `cull` (None: `use_cull`) takes the culled walk."""
    check_max_depth(max_depth)
    tri, attr, sph, n_tri, n_sph = pack_whitted_tables(scene)
    kw = dict(n_tri=n_tri, n_sph=n_sph, max_depth=max_depth,
              cull_tables=pack_cull_tables(scene) if use_cull(scene, cull) else None)
    if scene.n_emitters > 1:
        kw.update(ecr=scene.emitter_cr.float().contiguous(),
                  pick_seeds=torch.as_tensor(pick_seed_table(key, max_depth, spp),
                                             device=scene.device),
                  n_emitters=scene.n_emitters, lane_offset=lane_offset)
    args = (tri, attr, sph, whitted_scalars(scene, shadow_bias),
            scene.textures.contiguous(), scene.tex_wh.contiguous(), orig, d)
    return args, kw


def whitted_uber_trace(scene: RTScene, orig: torch.Tensor, d: torch.Tensor,
                       max_depth: int = 5, shadow_bias: float = SHADOW_BIAS,
                       key=0, spp: int = 1, lane_offset: int = 0,
                       cull: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitted radiance of the (N,3) rays `orig`, `d`: rgb (N,3) float32
    (textures applied) and nray (2,N) int32 = [main rays traced, diffuse
    hits] per lane. `key` (an integer seed or a (2,) uint32 key), `spp`
    and `lane_offset` (the absolute pixel id of lane 0) drive the emitter
    picks of a scene with several emitters; a scene with one reads none
    of them. `cull` names the tier of the triangle search (None:
    `use_cull`); both give the same frame. CUDA scenes run the kernel;
    CPU scenes run `whitted_uber_trace_plain`."""
    device = scene.device
    if device.type == "cpu":
        return nan_check("whitted_uber_trace", whitted_uber_trace_plain(
            scene, orig, d, max_depth, shadow_bias, key, spp, lane_offset, cull=cull))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    args, kw = whitted_launch_args(scene, orig, d, max_depth, shadow_bias, key, spp,
                                   lane_offset, cull)
    return nan_check("whitted_uber_trace", launch_whitted_uber(*args, **kw))


# --------------------------------------------------------- plain version


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _trace(tri_t, cull, sph, n_tri, n_sph, o, d, active=None, tally=None):
    """Nearest triangle (tt, bf) and nearest sphere (st, bs) per lane:
    exact Moller-Trumbore (`walk_nearest_plain` over the table `tri_t`,
    every row or the culled walk) and the sphere quadratic
    (ops/pallas_whitted.py:253-285, :371-396); a strict `<` keeps the
    lowest index on a tie. Sphere rows are host lists of float32 values.
    Lanes outside `active` miss every triangle; `tally` counts the tests
    of those inside and the row-test slots of their warps (`WARP` lanes in
    launch order): with `cull` those of the warp walk ("slots") and of the
    per-ray walk ("slots_thread", `trace_tiers.warp_slots`); without, a
    warp with an active lane steps through every row in both."""
    ox, oy, oz = o
    dx, dy, dz = d
    tt, bf, _, _ = walk_nearest_plain(tri_t, n_tri, torch.stack(o, dim=1),
                                      torch.stack(d, dim=1), cull, active, tally)
    if cull is None and tally is not None:
        lanes = torch.arange(ox.shape[0], device=ox.device)
        if active is not None:
            lanes = lanes[active]
        sweep = WARP * n_tri * torch.unique(torch.div(lanes, WARP, rounding_mode="floor")).numel()
        for k in ("slots", "slots_thread"):
            tally[k] = tally.get(k, 0) + sweep
    bf = torch.clamp(bf, min=0)
    st = torch.full_like(ox, BIG)
    bs = torch.zeros_like(bf)
    for s in range(n_sph):
        cx, cy, cz, rr = sph[s][:4]
        lx, ly, lz = ox - cx, oy - cy, oz - cz
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (dx * lx + dy * ly + dz * lz)
        c0 = lx * lx + ly * ly + lz * lz - rr * rr
        disc = b * b - 4.0 * a * c0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
        q = torch.where(q == 0.0, 1e-30, q)
        x0 = q / a
        x1 = c0 / q
        both = (x0 > 0.0) & (x1 > 0.0)
        ts = torch.where(both, torch.minimum(x0, x1), torch.where(x0 > 0.0, x0, x1))
        ts = torch.where((disc >= 0.0) & (ts > 0.0) & (sph[s][7] > 0.0), ts, BIG)
        bet = ts < st
        st = torch.where(bet, ts, st)
        bs = torch.where(bet, s, bs)
    return tt, bf, st, bs


def _mt(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, o, d):
    """Moller-Trumbore (u, v, t) with the reference thresholds; t = BIG
    where the ray misses. Vertex terms are floats or per-lane tensors."""
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(det.abs() < 1e-6, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ((det.abs() >= 1e-6) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 1e-6))
    return u, v, torch.where(ok, t, BIG), t


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as columns (C, N); a zero row for an empty table."""
    if table.shape[0] == 0:
        return torch.zeros((table.shape[1], idx.shape[0]), dtype=table.dtype,
                           device=idx.device)
    return table[idx].T


def whitted_uber_trace_plain(scene: RTScene, orig: torch.Tensor,
                             d: torch.Tensor, max_depth: int = 5,
                             shadow_bias: float = SHADOW_BIAS, key=0,
                             spp: int = 1, lane_offset: int = 0,
                             cull: Optional[bool] = None,
                             stats: Optional[dict] = None,
                             rays: Optional[list] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `whitted_uber_trace` (same signature and
    semantics), on the scene's device: every live lane takes one DFS step
    a pass, as the JAX kernel sweeps a tile. A `stats` dict gets
    "row_tests" and "slab_tests": the (ray, row) and slab tests of the
    traces the kernel makes, and "main" and "shadow": dicts of the same
    two counts and the row-test slots ("slots", "slots_thread", see
    `_trace`) of the main and the shadow traces apart; the kernel's `tally`
    adds them up (`TALLY_ROWS`, `TALLY_COLUMNS`). A `rays` list gets an
    entry a trace: (kind "main" or "shadow", the emitter of a shadow trace
    or -1, the lanes traced (k,), their depths (k,), origins (k,3) and
    directions (k,3))."""
    return _uber_plain(scene, orig, d, max_depth, shadow_bias, key, spp, lane_offset,
                       cull, stats, rays, None)


def warp_step_plain(scene: RTScene, orig: torch.Tensor, d: torch.Tensor,
                    max_depth: int = 5, shadow_bias: float = SHADOW_BIAS, key=0,
                    spp: int = 1, lane_offset: int = 0, cull: Optional[bool] = None,
                    stats: Optional[dict] = None, rays: Optional[list] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A CPU model of the kernel's warp-uniform step: `whitted_uber_trace_plain`
    with the lanes in warps of `WARP` in launch order, each warp taking its
    passes on its own until none of its lanes is live, warp after warp. A
    pass makes one main trace for the warp's live lanes, then the shadow
    trace of its diffuse lanes (with several emitters, one an emitter in
    ascending order for the lanes whose picks count it; none where no lane
    of the warp needs it). Same arguments and results; `rays` shows the
    calls in the kernel's order. A model of the schedule, not a second
    reference."""
    return _uber_plain(scene, orig, d, max_depth, shadow_bias, key, spp, lane_offset,
                       cull, stats, rays, WARP)


def _uber_plain(scene, orig, d, max_depth, shadow_bias, key, spp, lane_offset, cull,
                stats, rays, warp):
    """Both plain schedules: the lanes in groups of `warp` (None: one
    group), each group stepping until none of its lanes is live."""
    check_max_depth(max_depth)
    n = _check_rays(orig, d)
    n_e = scene.n_emitters
    if n_e > 1:
        if spp < 1:
            raise ValueError(f"bad spp={spp}")
        seeds = pick_seed_table(key, max_depth, spp)
        ecr = scene.emitter_cr.float().cpu().tolist()
    dev = scene.device
    f32 = torch.float32
    tri_t, attr_t, sph_t, n_tri, n_sph = pack_whitted_tables(scene)
    ct = pack_cull_tables(scene) if use_cull(scene, cull) else None
    sph = _as_f32_rows(sph_t, n_sph)
    tally = {"main": {}, "shadow": {}}
    scal = [float(v) for v in whitted_scalars(scene, shadow_bias).cpu()]
    ec, bg, bias0, any_e = scal[0:3], scal[3:6], scal[6], scal[7] > 0.0

    zero = torch.zeros(n, dtype=f32, device=dev)
    o = tuple(orig[:, k].to(f32) for k in range(3))
    dd = tuple(d[:, k].to(f32) for k in range(3))
    w = (zero + 1.0, zero + 1.0, zero + 1.0)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros_like(depth)
    stack = torch.zeros((max(max_depth, 1), 9, n), dtype=f32, device=dev)
    stack_depth = torch.zeros((max(max_depth, 1), n), dtype=torch.int64, device=dev)
    # ray ids, 32-bit words held in int64 (children 2 rid + 1 and 2 rid + 2)
    rid = (lane_offset + torch.arange(n, dtype=torch.int64, device=dev)) & _M32
    stack_rid = torch.zeros_like(stack_depth)
    rgb = [zero, zero, zero]
    nray = torch.zeros((2, n), dtype=torch.int32, device=dev)
    lanes = torch.arange(n, device=dev)
    groups = ([lanes >= 0] if warp is None
              else [torch.div(lanes, warp, rounding_mode="floor") == k
                    for k in range(-(-n // warp))])

    def log(kind, emitter, active, ro, rd):
        if rays is not None:
            sel = lanes[active]
            rays.append((kind, emitter, sel, depth[sel],
                         torch.stack(ro, dim=1)[sel], torch.stack(rd, dim=1)[sel]))

    def step(live):
        """One DFS step of the `live` lanes (the lanes outside it keep
        their state); returns the lanes still live after it."""
        nonlocal o, dd, w, depth, sp, rid
        nray[0] += live.to(torch.int32)

        # ---- main trace and the winner's attributes (:470-558)
        log("main", -1, live, o, dd)
        tt, bf, st, bs = _trace(tri_t, ct, sph, n_tri, n_sph, o, dd, live, tally["main"])
        use_s = st < tt
        hit = live & (torch.minimum(st, tt) < BIG)
        g = _rows(tri_t, bf)
        a = _rows(attr_t, bf)
        sa = _rows(sph_t, bs)
        u, v, _, t_ex = _mt(g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7],
                            g[8], o, dd)
        t = torch.where(use_s, st, t_ex)
        c = tuple(o[k] + dd[k] * t for k in range(3))
        w_b = 1.0 - u - v
        tn = _norm3(*(w_b * a[_A_N0 + k] + u * a[_A_N0 + 3 + k] + v * a[_A_N0 + 6 + k]
                      for k in range(3)), eps=1e-20)
        sn = _norm3(*(c[k] - sa[k] for k in range(3)), eps=1e-20)
        nrm = _where3(use_s, sn, tn)
        mtype = torch.where(use_s, sa[8], a[_A_MTYPE]).round().to(torch.int64)
        ior = torch.where(use_s, sa[9], a[_A_IOR])
        ka = tuple(torch.where(use_s, sa[10 + k], a[_A_KA + k]) for k in range(3))
        ks = tuple(torch.where(use_s, sa[13 + k], a[_A_KS + k]) for k in range(3))
        sexp = torch.where(use_s, sa[16], a[_A_SPEC])
        tex = torch.where(use_s, -1.0, a[_A_TEX])
        uv = torch.stack([w_b * a[_A_UV0 + k] + u * a[_A_UV0 + 2 + k]
                          + v * a[_A_UV0 + 4 + k] for k in range(2)], dim=-1)
        texed = (tex >= 0.0) & ~use_s
        texel = fetch_nearest(scene.textures, scene.tex_wh,
                              tex.round().to(torch.int64), uv)
        # diffuse colour: 0 for spheres (Object.hpp:36-40), the texel for
        # a textured triangle, Kd otherwise
        kd = tuple(torch.where(use_s, 0.0, torch.where(texed, texel[:, k],
                                                       a[_A_KD + k]))
                   for k in range(3))

        # ---- classify (:566-575)
        miss = live & ~hit
        for k in range(3):
            rgb[k] = rgb[k] + torch.where(miss, w[k] * bg[k], 0.0)
        is_diff = hit & (mtype == 0)
        is_spec = hit & ((mtype == 1) | (mtype == 2))
        is_glass = is_spec & (mtype == 1)
        nray[1] += is_diff.to(torch.int32)

        # ---- Phong toward an emitter's centre, behind a shadow trace (:577-643)
        def phong_toward(ec, shade, emitter):
            """(term without the ray's weight, lit) toward the centre ec;
            the kernel traces the shadow rays of the `shade` lanes."""
            ll = _norm3(ec[0] - c[0], ec[1] - c[1], ec[2] - c[2])
            ndl = _dot(nrm, ll)
            side = torch.where(ndl >= 0.0, 1.0, -1.0)
            bias = bias0 * torch.maximum(torch.maximum(
                c[0].abs(), torch.maximum(c[1].abs(), c[2].abs())),
                torch.ones_like(zero))
            so = tuple(c[k] + nrm[k] * (side * bias) for k in range(3))
            diff = torch.clamp(ndl, min=0.0)
            mldn = (-ll[0]) * nrm[0] + (-ll[1]) * nrm[1] + (-ll[2]) * nrm[2]
            rl = _norm3(*(-ll[k] - 2.0 * mldn * nrm[k] for k in range(3)))
            sdot = torch.clamp(-_dot(dd, rl), min=0.0)
            spec = torch.where(
                sdot > 0.0,
                torch.exp(sexp * torch.log(torch.clamp(sdot, min=1e-30))),
                torch.where(sexp == 0.0, 1.0, 0.0))

            log("shadow", emitter, shade, so, ll)
            tt2, bf2, st2, bs2 = _trace(tri_t, ct, sph, n_tri, n_sph, so, ll,
                                        shade, tally["shadow"])
            use_s2 = st2 < tt2
            t_sh = torch.where(use_s2, st2, tt2)
            a2 = _rows(attr_t, bf2)
            s2 = _rows(sph_t, bs2)
            em = tuple(torch.where(use_s2, s2[4 + k],
                                   torch.where(tt2 < BIG, a2[_A_EMIT + k], 0.0))
                       for k in range(3))
            lit = (t_sh < BIG) & (torch.sqrt(_dot(em, em)) >= EPS)
            if not any_e:
                lit = torch.zeros_like(lit)
            dl = tuple(ll[k] * t_sh for k in range(3))
            dist2 = _dot(dl, dl)
            in_shadow = (t_sh * t_sh - dist2).abs() > 1e-6
            amb = torch.where(in_shadow, 0.0, 1.0)
            return tuple(amb * (ka[k] + diff * kd[k]) * em[k]
                         + spec * ks[k] * em[k] for k in range(3)), lit

        if bool(is_diff.any()) and n_e <= 1:
            term, lit = phong_toward(ec, is_diff, 0)
            dep = is_diff & lit
            for k in range(3):
                rgb[k] = rgb[k] + torch.where(dep, w[k] * term[k], 0.0)
        elif bool(is_diff.any()):
            # mean over the spp emitter picks, regrouped by emitter; every
            # live lane of one loop iteration need not share a depth
            picks = [torch.zeros_like(depth) for _ in range(spp)]
            for dep_i in range(max_depth + 1):
                at = depth == dep_i
                if bool((at & is_diff).any()):
                    for s_i in range(spp):
                        picks[s_i] = torch.where(
                            at, _pick_emitter(rid, seeds[dep_i, s_i], n_e),
                            picks[s_i])
            total = [zero, zero, zero]
            for o_i in range(n_e):
                count = sum((pk == o_i).to(f32) for pk in picks)
                if not bool((is_diff & (count > 0)).any()):
                    continue
                term, lit = phong_toward(ecr[o_i][0:3], is_diff & (count > 0), o_i)
                for k in range(3):
                    total[k] = total[k] + torch.where(
                        lit & (count > 0), count * term[k], 0.0)
            for k in range(3):
                rgb[k] = rgb[k] + torch.where(
                    is_diff, w[k] * (total[k] / float(spp)), 0.0)

        # ---- specular: Fresnel fork, push / continue / pop (:683-799)
        cont = is_spec & (depth < max_depth)
        pop = live & ~cont & (sp > 0)
        if bool(cont.any()):
            cosi = torch.clamp(_dot(dd, nrm), -1.0, 1.0)
            exiting = cosi > 0
            etai = torch.where(exiting, ior, 1.0)
            etat = torch.where(exiting, 1.0, ior)
            sint = etai / etat * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=0.0))
            tir = sint >= 1.0
            cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=0.0))
            ci = cosi.abs()
            rs = (etat * ci - etai * cost) / (etat * ci + etai * cost)
            rp = (etai * ci - etat * cost) / (etai * ci + etat * cost)
            kr = torch.clamp(torch.where(tir, 1.0, (rs * rs + rp * rp) * 0.5),
                             0.0, 1.0)
            rf = _norm3(*(dd[k] - 2.0 * cosi * nrm[k] for k in range(3)))
            entering = cosi < 0
            r_etai = torch.where(entering, 1.0, ior)
            r_etat = torch.where(entering, ior, 1.0)
            nn2 = tuple(torch.where(entering, nrm[k], -nrm[k]) for k in range(3))
            eta = r_etai / r_etat
            kk = 1.0 - eta * eta * (1.0 - ci * ci)
            rr_s = eta * ci - torch.sqrt(torch.clamp(kk, min=0.0))
            rr = tuple(torch.where(kk < 0, 0.0, eta * dd[k] + rr_s * nn2[k])
                       for k in range(3))
            has_refr = (torch.sqrt(_dot(rr, rr)) > 1e-6) & ((kr - 1.0).abs() > 1e-6)
            rr = _norm3(*rr, eps=1e-20)
            side_g = torch.where(cosi < 0, 1.0, -1.0)
            side_m = torch.where(_dot(rf, nrm) > 0, 1.0, -1.0)
            side_r = torch.where(cosi > 0, 1.0, -1.0)
            refl_side = torch.where(is_glass, side_g, side_m)
            ro = tuple(c[k] + nrm[k] * refl_side * EPS for k in range(3))
            qo = tuple(c[k] + nrm[k] * side_r * EPS for k in range(3))
            refl_w = torch.where(is_glass, kr, 1.0)

            push = cont & is_glass & has_refr
            idx = lanes[push]
            if idx.numel():
                vals = torch.stack([*qo, *rr, *(w[k] * (1.0 - kr) for k in range(3))])
                stack[sp[idx], :, idx] = vals[:, idx].T
                stack_depth[sp[idx], idx] = depth[idx] + 1
                stack_rid[sp[idx], idx] = (2 * rid[idx] + 2) & _M32
                sp = sp + push.to(torch.int64)
            o = _where3(cont, ro, o)
            dd = _where3(cont, rf, dd)
            w = _where3(cont, tuple(w[k] * refl_w for k in range(3)), w)
            depth = torch.where(cont, depth + 1, depth)
            rid = torch.where(cont, (2 * rid + 1) & _M32, rid)

        idx = lanes[pop]
        if idx.numel():
            sp = sp - pop.to(torch.int64)
            top = stack[sp[idx], :, idx].T
            o, dd, w = (tuple(x.clone() for x in v3) for v3 in (o, dd, w))
            for k in range(3):
                o[k][idx] = top[k]
                dd[k][idx] = top[3 + k]
                w[k][idx] = top[6 + k]
            depth = depth.clone()
            depth[idx] = stack_depth[sp[idx], idx]
            rid = rid.clone()
            rid[idx] = stack_rid[sp[idx], idx]
        return cont | pop

    # the lanes in groups (the whole set, or warps), each group stepping
    # until none of its lanes is live
    for group in groups:
        live = group.clone()
        while bool(live.any()):
            live = step(live)

    if stats is not None:
        for k in ("row_tests", "slab_tests"):
            stats[k] = stats.get(k, 0) + sum(t.get(k, 0) for t in tally.values())
        for ray, t in tally.items():
            part = stats.setdefault(ray, {})
            for k in ("row_tests", "slab_tests", "slots", "slots_thread"):
                part[k] = part.get(k, 0) + t.get(k, 0)
    return torch.stack(rgb, dim=1), nray
