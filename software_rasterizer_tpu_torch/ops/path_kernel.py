"""The two path-tracing kernels: the persistent camera kernel (the port
of the JAX package's `ops/pallas_path.fused_path_camera_render` /
`_pt_kernel`, both tiers) and the fused bounce kernel of the wavefront
integrator (`fused_bounce_group` / `_bounce_kernel`; its section is at
the end of this file).

One camera call renders `spp` full path-tracing samples of each pixel lane in
[lane_offset, lane_offset + n_lanes) of the (width x height) camera
frame and returns the UN-normalized radiance sum (3, n) float32.

  * `path_camera_render`: the entry point. On a CUDA scene it launches
    the hand-written kernel (csrc/path_camera.cu) and counts the launch
    in `LAUNCHES`; on a CPU scene it runs the plain version.
  * `path_camera_render_plain`: the same computation in plain PyTorch,
    vectorized over lanes, looping over iterations, over spans of
    triangle rows as (lanes, rows) planes and over spheres. It is written
    from `_pt_kernel` and rounds every operation as that kernel does, so
    it reproduces the JAX kernel lane for lane up to transcendental
    rounding.

Two tiers of the triangle search, as in the JAX kernel (`cull`): the full
sweep traces the shadow ray and the bounce ray through every triangle
(its mm=False tier, the default up to `CULL_MIN_TRIS` rows); the culled
walk (its mm=True tier, the default above) lets each ray test only the
rows of the chunks whose boxes it enters (`pack_cull_tables`). The test
is conservative and the rows are tested with the same expressions in
the same order, so the two tiers agree lane for lane. Both kernels take
both tiers.

Semantics per sample (reference citations in the JAX package's
ops/pallas_path.py and ops/path.py): camera rays aimed at the z=0 plane;
primary miss adds the background once; sampleLight bounding-sphere NEE
with the |t^2 - d^2| <= 1e-4 shadow acceptance; RR before a uniform
hemisphere sample; an emissive shading point adds its stored color;
indirect hits on emitters end the path; spheres store color 0. A lane
whose path ends restarts its pixel's next sample. Draws are lowbias32
hashes keyed by (sample seed, absolute lane, depth*8 + slot), with one
threefry-derived seed per sample (utils/rng.sample_seeds), so
start_sample-resumed runs reproduce the monolithic per-sample values.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from software_rasterizer_tpu_torch.ops.camera import camera_scale
from software_rasterizer_tpu_torch.ops.intersect import RTScene, _rows
from software_rasterizer_tpu_torch.ops import trace_tiers
from software_rasterizer_tpu_torch.ops.trace_kernel import mt_plane
from software_rasterizer_tpu_torch.ops.trace_tiers import WARP, CullTables, walk_nearest_plain
from software_rasterizer_tpu_torch.utils.debug import nan_check
from software_rasterizer_tpu_torch.utils.rng import (
    bounce_uniform,
    lowbias32_uniform,
    sample_seeds,
)

INV_2PI = 0.15915494309189535
INV_PI = 0.3183098861837907
TWO_PI = 6.283185307179586
EPS = 1e-5
BIG = 1e30

# above this many triangle rows the kernels take the culled walk unless
# the caller names a tier (the JAX gate, ops/pallas_path.py:1249)
CULL_MIN_TRIS = 512

# rows of the triangle table the full sweeps stage in shared memory at a
# time (csrc/path_common.cuh kStageRows)
STAGE_ROWS = 256

# kernel launches made by path_camera_render and by fused_bounce_group,
# full sweep and culled walk (the plain versions are not counted); a
# caller may reset them to 0 to count one run
LAUNCHES = 0
LAUNCHES_CULLED = 0
LAUNCHES_BOUNCE = 0
LAUNCHES_BOUNCE_CULLED = 0


def use_cull(scene: RTScene, cull: Optional[bool]) -> bool:
    """The tier of the triangle search: `cull` where the caller names
    one, else the culled walk above `CULL_MIN_TRIS` rows."""
    return scene.v0.shape[0] > CULL_MIN_TRIS if cull is None else bool(cull)


def pack_cull_tables(scene: RTScene) -> CullTables:
    """The operands of the culled walk (the counterpart of the JAX
    package's `pack_mm_tables`, ops/pallas_path.py:298): the scene's own
    chunk boxes in BVH leaf order (`chunk_lo/hi`, `cull_chunk` rows a
    chunk) and their super-chunk boxes (`trace_tiers.super_bounds`). The
    kernels read exact rows of `tri_table` and the attribute table by
    index, so the JAX tables `coef_c` (the bilinear Moller-Trumbore form)
    and `attr24_c` (the one-hot join's feature-major rows) are left out:
    both are TPU form. `pack_scene_tables` emits its rows in the order of
    `tri_table`, so a chunk's rows are the chunk's triangles."""
    return trace_tiers.cull_tables(scene.chunk_lo, scene.chunk_hi, scene.cull_chunk)


def pack_scene_tables(scene: RTScene) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Kernel operand tables (ops/pallas_path.py:800-824): attr (F,16)
    [n0|n1|n2|kd|emit|0], sph (S,12) [c|r|emit|valid|kd|0] and n_sph =
    1 + the index of the last valid sphere."""
    f32 = torch.float32
    tv = scene.tri_valid[:, None]
    sv = scene.sph_valid[:, None]
    tm = scene.tri_mat.long()
    sm = scene.sph_mat.long()
    f = scene.v0.shape[0]
    s = scene.sph_c.shape[0]
    dev = scene.device
    attr = torch.cat([
        scene.n0, scene.n1, scene.n2,
        torch.where(tv, scene.mat_kd[tm], 0.0),
        torch.where(tv, scene.mat_emit[tm], 0.0),
        torch.zeros((f, 1), dtype=f32, device=dev),
    ], dim=1).to(f32).contiguous()
    sph = torch.cat([
        scene.sph_c,
        scene.sph_r[:, None],
        torch.where(sv, scene.mat_emit[sm], 0.0),
        sv.to(f32),
        torch.where(sv, scene.mat_kd[sm], 0.0),
        torch.zeros((s, 1), dtype=f32, device=dev),
    ], dim=1).to(f32).contiguous()
    return attr, sph, scene.n_sph


def _camera_table(scene: RTScene, fovy_deg: float, width: int,
                  height: int) -> torch.Tensor:
    """(8,) [eye | tan(fovy/2) | aspect | background] float32."""
    sa = torch.tensor([camera_scale(fovy_deg), width / float(height)],
                      dtype=torch.float32, device=scene.device)
    return torch.cat([scene.eye.float(), sa, scene.background.float()])


def _lane_count(width: int, height: int, lane_offset: int,
                n_lanes: Optional[int], spp: int, max_bounces: int) -> int:
    if width <= 0 or height <= 0:
        raise ValueError(f"bad frame size {width}x{height}")
    if width * height >= 2 ** 31:
        raise ValueError("frame too large: lane ids must fit int32")
    n = width * height if n_lanes is None else int(n_lanes)
    if n < 0 or lane_offset < 0 or lane_offset + n >= 2 ** 31:
        raise ValueError(f"bad lane range offset={lane_offset} n={n}")
    if spp < 0 or max_bounces < 0:
        raise ValueError(f"bad spp={spp} / max_bounces={max_bounces}")
    return n


# ---------------------------------------------------------------- CUDA


def _cuda_fn():
    from software_rasterizer_tpu_torch.utils.cuda_build import load_library

    lib = load_library("path_camera", ["path_camera.cu"])
    fn = lib.srt_path_camera_render
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 7 + [ci] * 9 + [cf] + [vp] * 4 + [ci] * 2 + [vp, ci, vp]
        fn.restype = ci
    return fn


def build_kernel() -> None:
    """Compile (or reuse) and load the CUDA library."""
    _cuda_fn()


def _check_table(name: str, t: torch.Tensor, dtype, cols: Optional[int],
                 device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if cols is not None and (t.dim() != 2 or t.shape[1] != cols):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (*, {cols})")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_cull(ct: Optional[CullTables], n_rows: int, device) -> tuple:
    """The culled walk's kernel arguments (lo, hi, lo2, hi2, nc, chunk),
    all null / 0 for the full sweep; checks the tables."""
    if ct is None:
        return None, None, None, None, 0, 0
    f32 = torch.float32
    for name, t in zip(("lo", "hi", "lo2", "hi2"), ct[:4]):
        _check_table(name, t, f32, 3, device)
    nc = ct.lo.shape[0]
    if ct.hi.shape[0] != nc or ct.lo2.shape != ct.hi2.shape \
            or ct.lo2.shape[0] != -(-nc // trace_tiers.MM2C_SUPER) or not 1 <= ct.chunk \
            or nc * ct.chunk < n_rows:
        raise ValueError(f"cull tables of {nc} chunks of {ct.chunk} rows and "
                         f"{ct.lo2.shape[0]} super-chunks do not cover {n_rows} rows")
    return (ct.lo.data_ptr(), ct.hi.data_ptr(), ct.lo2.data_ptr(),
            ct.hi2.data_ptr(), nc, ct.chunk)


# the entries of a path kernel's tally: (ray, row) tests, slab tests, the
# row-test slots the culled walk's warps issue (32 a row-step), and the
# full sweep's loop: the iterations its lanes were active in
# (lane-iterations, lane-bounces) and the lane-slots its warps issued (32
# an iteration of a warp with any lane active)
TALLY_ENTRIES = ("row_tests", "slab_tests", "walk_slots", "loop_active", "loop_slots")


def _check_tally(tally: Optional[torch.Tensor], device, slots: bool = False):
    """The kernels' optional (2,) int64 [row tests, slab tests] total; with
    `slots` also (3,) or (5,), the later entries those of
    `TALLY_ENTRIES`."""
    if tally is None:
        return None
    _check_table("tally", tally, torch.int64, None, device)
    if tally.shape != (2,) and not (slots and tally.shape in ((3,), (5,))):
        raise ValueError(f"tally has shape {tuple(tally.shape)}, expected (2,)"
                         + (", (3,) or (5,)" if slots else ""))
    return tally.data_ptr()


def launch_path_camera(tri: torch.Tensor, attr: torch.Tensor,
                       sph: torch.Tensor, ecr: torch.Tensor,
                       seeds: torch.Tensor, cam: torch.Tensor, *,
                       n_tri: int, n_sph: int, n_emitters: int,
                       lane_offset: int, n_lanes: int, width: int,
                       height: int, p_rr: float,
                       max_bounces: int,
                       cull_tables: Optional[CullTables] = None,
                       tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/path_camera.cu on the current stream; returns the
    (3, n_lanes) sum. With `cull_tables` the culled instance runs, else
    the full sweep. A `tally` (2,) int64 tensor gets the launch's (ray,
    row) tests and slab tests added; a (3,) one also, from the culled
    instance, the row-test slots its warps issue (32 a row-step of the
    warp walk: the SIMT efficiency is row tests / slots); a (5,) one also,
    from the full sweep, its loop's active lane-iterations and issued
    lane-slots (`TALLY_ENTRIES`; the loop's SIMT efficiency is their
    ratio). Checks every operand and raises on a launch error."""
    global LAUNCHES, LAUNCHES_CULLED
    device = tri.device
    if device.type != "cuda":
        raise ValueError(f"launch_path_camera needs CUDA tensors, got {device}")
    f32 = torch.float32
    _check_table("tri_table", tri, f32, 12, device)
    _check_table("attr", attr, f32, 16, device)
    _check_table("sph", sph, f32, 12, device)
    _check_table("emitter_cr", ecr, f32, 4, device)
    _check_table("seeds", seeds, torch.int32, None, device)
    _check_table("cam", cam, f32, None, device)
    if seeds.dim() != 1 or cam.shape != (8,):
        raise ValueError("seeds must be (spp,) and cam (8,)")
    if attr.shape[0] != tri.shape[0] or not 0 <= n_tri <= tri.shape[0]:
        raise ValueError("triangle tables disagree with n_tri")
    if not 0 <= n_sph <= sph.shape[0]:
        raise ValueError("n_sph exceeds the sphere table")
    if ecr.shape[0] < max(n_emitters, 1):
        raise ValueError("emitter table has fewer rows than emitters")
    cull_args = _check_cull(cull_tables, n_tri, device)
    tally_ptr = _check_tally(tally, device, slots=True)
    out = torch.empty((3, n_lanes), dtype=f32, device=device)
    if n_lanes == 0:
        return out
    tri = trace_tiers._aligned(tri)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _cuda_fn()(
        tri.data_ptr(), attr.data_ptr(), sph.data_ptr(), ecr.data_ptr(),
        seeds.data_ptr(), cam.data_ptr(), out.data_ptr(),
        n_tri, n_sph, n_emitters, seeds.shape[0], lane_offset, n_lanes,
        width, height, max_bounces, float(p_rr), *cull_args, tally_ptr,
        0 if tally is None else tally.shape[0], stream,
    )
    if rc != 0:
        raise RuntimeError(f"path_camera kernel launch failed: cudaError {rc}")
    if cull_tables is None:
        LAUNCHES += 1
    else:
        LAUNCHES_CULLED += 1
    return out


def path_camera_render(scene: RTScene, seed: int, width: int, height: int,
                       fovy_deg: float, spp: int, start_sample: int = 0,
                       lane_offset: int = 0, n_lanes: Optional[int] = None,
                       p_rr: float = 0.8, max_bounces: int = 16,
                       cull: Optional[bool] = None) -> torch.Tensor:
    """Render `spp` samples [start_sample, start_sample+spp) of the lanes
    [lane_offset, lane_offset+n_lanes) (default: the whole frame) and
    return the un-normalized (3, n) float32 sum. `cull` names the tier
    (None: `use_cull`); both give the same sum. CUDA scenes run the
    kernel; CPU scenes run `path_camera_render_plain`."""
    device = scene.device
    if device.type == "cpu":
        return nan_check("path_camera_render", path_camera_render_plain(
            scene, seed, width, height, fovy_deg, spp, start_sample,
            lane_offset, n_lanes, p_rr, max_bounces, cull=cull))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = _lane_count(width, height, lane_offset, n_lanes, spp, max_bounces)
    attr, sph, n_sph = pack_scene_tables(scene)
    seeds = torch.as_tensor(sample_seeds(seed, start_sample, spp)).to(device)
    return nan_check("path_camera_render", launch_path_camera(
        scene.tri_table.float().contiguous(), attr, sph,
        scene.emitter_cr.float().contiguous(), seeds,
        _camera_table(scene, fovy_deg, width, height),
        n_tri=scene.n_tri, n_sph=n_sph, n_emitters=scene.n_emitters,
        lane_offset=lane_offset, n_lanes=n, width=width, height=height,
        p_rr=p_rr, max_bounces=max_bounces,
        cull_tables=pack_cull_tables(scene) if use_cull(scene, cull) else None))


# --------------------------------------------------------- plain version


def _norm3(x, y, z, eps=0.0):
    n = torch.sqrt(x * x + y * y + z * z)
    inv = torch.where(n > 0, 1.0 / torch.where(n > 0, n, 1.0), 0.0)
    inv = torch.where(n > eps, inv, 0.0)
    return x * inv, y * inv, z * inv


def _to_world(lx, ly, lz, nx, ny, nz):
    """Tools::toWorld (Tools.cpp:315-327), component form."""
    use_x = nx.abs() > ny.abs()
    inv_a = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=1e-30))
    inv_b = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=1e-30))
    cx = torch.where(use_x, nz * inv_a, 0.0)
    cy = torch.where(use_x, 0.0, nz * inv_b)
    cz = torch.where(use_x, -nx * inv_a, -ny * inv_b)
    bx = cy * nz - cz * ny
    by = cz * nx - cx * nz
    bz = cx * ny - cy * nx
    return (lx * bx + ly * cx + lz * nx,
            lx * by + ly * cy + lz * ny,
            lx * bz + ly * cz + lz * nz)


class _Draws:
    """`_RngDyn`: draw slot i of an iteration uses counter base + i."""

    def __init__(self, seed, lane, base):
        self.seed, self.lane, self.base, self.i = seed, lane, base, 0

    def uniform(self):
        u = lowbias32_uniform(self.seed, self.lane, self.base + self.i)
        self.i += 1
        return u

    def sphere(self):
        z = 1.0 - 2.0 * self.uniform()
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = TWO_PI * self.uniform()
        return r * torch.cos(phi), r * torch.sin(phi), z


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


class _Tables(NamedTuple):
    """What the plain dual trace reads: the triangle and attribute tables
    (device tensors), the sphere rows (host lists of float32 values), the
    loop bounds, and the culled walk's tables (None: the full sweep)."""

    tri: torch.Tensor
    attr: torch.Tensor
    sph: list
    n_tri: int
    n_sph: int
    cull: Optional[CullTables]


def _plain_tables(scene: RTScene, cull: Optional[bool]) -> _Tables:
    attr, sph, n_sph = pack_scene_tables(scene)
    return _Tables(scene.tri_table.float().contiguous(), attr,
                   _as_f32_rows(sph, n_sph), scene.n_tri, n_sph,
                   pack_cull_tables(scene) if use_cull(scene, cull) else None)


def staged_sweep_plain(tri_table, n_rows: int, orig, d, slice_rows: int = STAGE_ROWS):
    """A CPU model of the full sweeps' triangle search
    (csrc/path_common.cuh dual_trace_block): the first `n_rows` rows of
    `tri_table` in staged slices of `slice_rows`, and each ray folding
    them one row at a time into its (t, row, u, v) under a strict `<`.
    Returns what `walk_nearest_plain` returns without a cull: (t (N,) with
    BIG on a miss, row (N,) int64 with -1, u, v of the winner, 0 on a
    miss), lane for lane."""
    n, dev = orig.shape[0], orig.device
    t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    row = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    for f0 in range(0, n_rows, slice_rows):
        cnt = min(slice_rows, n_rows - f0)
        tm, um, vm = mt_plane(orig, d, tri_table[f0:f0 + cnt], uv=True)
        for i in range(cnt):
            better = tm[:, i] < t
            t = torch.where(better, tm[:, i], t)
            row = torch.where(better, f0 + i, row)
            u = torch.where(better, um[:, i], u)
            v = torch.where(better, vm[:, i], v)
    return t, row, u, v


def _dual_trace(tabs: _Tables, o, la, lb, active=None, tally=None,
                slice_rows: Optional[int] = None):
    """Nearest hits of the shadow ray A (o, la) and the bounce ray B
    (o, lb): triangles (`walk_nearest_plain`: every row, or the culled
    walk of each ray on its own; with `slice_rows`, the full sweep's
    staged form `staged_sweep_plain`), then spheres, strict `<` merges
    (lowest index wins a tie; triangles before spheres). `tally` gets the
    (ray, row) and slab tests of the `active` lanes."""
    ox, oy, oz = o
    orig = torch.stack(o, dim=1)

    def tri_hit(d, bounce):
        if slice_rows is None:
            t, f, u, v = walk_nearest_plain(tabs.tri, tabs.n_tri, orig,
                                            torch.stack(d, dim=1), tabs.cull,
                                            active, tally)
        else:
            t, f, u, v = staged_sweep_plain(tabs.tri, tabs.n_tri, orig,
                                            torch.stack(d, dim=1), slice_rows)
        hit = f >= 0
        at = _rows(tabs.attr, torch.clamp(f, min=0)).T
        w = 1.0 - u - v
        nrm = tuple(torch.where(hit, w * at[k] + u * at[3 + k] + v * at[6 + k], 0.0)
                    for k in range(3))
        emit = tuple(torch.where(hit, at[12 + k], 0.0) for k in range(3))
        kd = tuple(torch.where(hit, at[9 + k], 0.0) for k in range(3)) if bounce else None
        return t, nrm, kd, emit

    tA, nA, _, eA = tri_hit(la, False)
    tB, nB, kB, eB = tri_hit(lb, True)
    sB = torch.zeros_like(ox, dtype=torch.bool)

    for s in range(tabs.n_sph):
        row = tabs.sph[s]
        cx, cy, cz, rr = row[:4]
        lx, ly, lz = ox - cx, oy - cy, oz - cz
        c0 = lx * lx + ly * ly + lz * lz - rr * rr
        valid = row[7] > 0.0
        inv_r = 1.0 / max(rr, 1e-20)

        def hit_sph(dx, dy, dz):
            a = dx * dx + dy * dy + dz * dz
            b = 2.0 * (dx * lx + dy * ly + dz * lz)
            disc = b * b - 4.0 * a * c0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
            q = torch.where(q == 0.0, 1e-30, q)
            x0 = q / a
            x1 = c0 / q
            both = (x0 > 0.0) & (x1 > 0.0)
            t = torch.where(both, torch.minimum(x0, x1),
                            torch.where(x0 > 0.0, x0, x1))
            ok = (disc >= 0.0) & (t > 0.0) & valid
            return torch.where(ok, t, BIG)

        def sph_nrm(dx, dy, dz, ts):
            return ((ox + dx * ts - cx) * inv_r, (oy + dy * ts - cy) * inv_r,
                    (oz + dz * ts - cz) * inv_r)

        ts = hit_sph(*la)
        bet = ts < tA
        tA = torch.where(bet, ts, tA)
        nA = _where3(bet, sph_nrm(*la, ts), nA)
        eA = tuple(torch.where(bet, row[4 + k], eA[k]) for k in range(3))

        ts = hit_sph(*lb)
        bet = ts < tB
        tB = torch.where(bet, ts, tB)
        nB = _where3(bet, sph_nrm(*lb, ts), nB)
        kB = tuple(torch.where(bet, row[8 + k], kB[k]) for k in range(3))
        eB = tuple(torch.where(bet, row[4 + k], eB[k]) for k in range(3))
        sB = sB | bet

    return (tA, nA, eA), (tB, nB, kB, eB, sB)


def _as_f32_rows(t: torch.Tensor, n: int) -> list:
    """The first n rows as host lists of Python floats; each value is a
    float32 and stays one when an op casts it back to the tensor dtype."""
    return t[:n].float().cpu().tolist()


def path_camera_render_plain(scene: RTScene, seed: int, width: int,
                             height: int, fovy_deg: float, spp: int,
                             start_sample: int = 0, lane_offset: int = 0,
                             n_lanes: Optional[int] = None,
                             p_rr: float = 0.8, max_bounces: int = 16,
                             stats: Optional[dict] = None,
                             cull: Optional[bool] = None) -> torch.Tensor:
    """Plain PyTorch version of `path_camera_render` (same signature and
    semantics), on the scene's device. A `stats` dict gets
    "lane_iterations": the loop iterations summed over lanes, each a
    restart or a bounce with its two traces (the kernel's unit of work),
    "per_lane": those iterations lane by lane ((n,) int64, the input of
    `loop_slots`), and "row_tests" / "slab_tests": the (ray, row) and slab tests of those
    iterations, the counts the kernel's `tally` adds up; with the culled
    walk also "slots" / "slots_thread": the row-test slots the kernel's
    warps issue (its `tally`'s third entry) and those the per-thread walk
    would (`trace_tiers.warp_slots`)."""
    n = _lane_count(width, height, lane_offset, n_lanes, spp, max_bounces)
    dev = scene.device
    f32 = torch.float32
    tabs = _plain_tables(scene, cull)
    ecr = scene.emitter_cr.float()
    seeds = torch.as_tensor(sample_seeds(seed, start_sample, spp)).to(dev)
    eye = [float(v) for v in scene.eye.float().cpu()]
    bg = [float(v) for v in scene.background.float().cpu()]
    scale = camera_scale(fovy_deg)
    aspect = float(torch.tensor(width / float(height), dtype=f32))
    n_e = scene.n_emitters
    any_e = n_e > 0
    n_e_f = float(max(n_e, 1))
    p_rr = float(torch.tensor(p_rr, dtype=f32))

    lane = lane_offset + torch.arange(n, dtype=torch.int64, device=dev)
    inb = lane < width * height
    lane_c = torch.where(inb, lane, 0)
    py_i = lane_c // width
    px_i = lane_c - py_i * width
    cxp = (2.0 * (px_i.to(f32) + 0.5) / width - 1.0) * aspect * scale
    cyp = (1.0 - 2.0 * (py_i.to(f32) + 0.5) / height) * scale
    cd = _norm3(cxp - eye[0], cyp - eye[1], 0.0 * cxp - eye[2])

    zero = torch.zeros(n, dtype=f32, device=dev)
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    next_s = torch.where(inb, 0, spp)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    pos = nrm = kd = emit = col = tp = (zero, zero, zero)
    acc = [zero, zero, zero]

    per_lane = torch.zeros(n, dtype=torch.int64, device=dev)
    tally = {} if stats is not None else None
    while bool((live | (next_s < spp)).any()):
        active = live | (next_s < spp)
        per_lane += active.long()
        restart = ~live & (next_s < spp)
        local_s = torch.clamp(next_s - 1, min=0)
        sseed = seeds[torch.clamp(local_s, max=max(spp - 1, 0))]
        rng = _Draws(sseed, lane, depth * 8)
        nn = _norm3(*nrm)

        # ---- sampleLight (Scene.cpp:429-476)
        u_pick = rng.uniform()
        k_e = torch.clamp(torch.floor(u_pick * n_e_f).to(torch.int64),
                          max=max(n_e - 1, 0))
        row = ecr[k_e]
        cc = (row[:, 0], row[:, 1], row[:, 2])
        crad = row[:, 3]
        bl = _norm3(cc[0] - pos[0], cc[1] - pos[1], cc[2] - pos[2])
        sx, sy, sz = rng.sphere()
        flip = sx * bl[0] + sy * bl[1] + sz * bl[2] < 0
        sx, sy, sz = _where3(flip, (-sx, -sy, -sz), (sx, sy, sz))
        hx, hy, hz = rng.sphere()
        sx, sy, sz = _norm3(sx + 1e-6 * hx, sy + 1e-6 * hy, sz + 1e-6 * hz)
        spx, spy, spz = cc[0] + sx * crad, cc[1] + sy * crad, cc[2] + sz * crad
        ll = _norm3(spx - pos[0], spy - pos[1], spz - pos[2])
        cos_t = ll[0] * bl[0] + ll[1] * bl[1] + ll[2] * bl[2]
        pdf_l = cos_t * INV_2PI if any_e else torch.zeros_like(cos_t)

        # ---- RR + uniform hemisphere (Material.cpp:14-34)
        u_rr = rng.uniform()
        survive = u_rr <= p_rr
        x1 = rng.uniform()
        x2 = rng.uniform()
        zl = (1.0 - 2.0 * x1).abs()
        rl = torch.sqrt(torch.clamp(1.0 - zl * zl, min=0.0))
        phi = TWO_PI * x2
        w = _norm3(*_to_world(rl * torch.cos(phi), rl * torch.sin(phi), zl, *nn))
        wdn = w[0] * nn[0] + w[1] * nn[1] + w[2] * nn[2]
        cos_o = torch.clamp(wdn, min=0.0)
        pdf_b = torch.where(wdn > 0, INV_2PI, 0.0)

        # ---- both traces; restarting lanes ride the B slot
        o = tuple(torch.where(restart, eye[k], pos[k] + 1e-6 * nn[k])
                  for k in range(3))
        bd = _where3(restart, cd, w)
        (tA, nA, eA), (tB, nB, kB, eB, sB) = _dual_trace(
            tabs, o, ll, bd, active, tally)

        # ---- NEE evaluation for live lanes (Scene.cpp:671-717)
        hit_a = tA < BIG
        sc = tuple(o[k] + ll[k] * tA for k in range(3))
        d3 = tuple(pos[k] - sc[k] for k in range(3))
        dist2 = d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]
        not_shadow = (tA * tA - dist2).abs() <= 1e-4
        lit = hit_a & (torch.sqrt(eA[0] * eA[0] + eA[1] * eA[1]
                                  + eA[2] * eA[2]) > EPS)
        if not any_e:
            lit = torch.zeros_like(lit)
        sn = _norm3(*nA, 1e-20)
        cos_on = torch.clamp(nn[0] * ll[0] + nn[1] * ll[1] + nn[2] * ll[2],
                             min=0.0)
        cos_ln = torch.clamp(-(sn[0] * ll[0] + sn[1] * ll[1] + sn[2] * ll[2]),
                             min=0.0)
        ldn = ll[0] * nn[0] + ll[1] * nn[1] + ll[2] * nn[2]
        pdf_ok_l = (pdf_l >= EPS) & (pdf_l < BIG) & (pdf_l == pdf_l)
        denom = torch.where(pdf_ok_l, pdf_l, 1.0) * torch.clamp(dist2, min=1e-30)
        nee_s = torch.where(lit & not_shadow & pdf_ok_l & (ldn > 0),
                            cos_on * cos_ln / denom * INV_PI, 0.0)
        cur_emissive = torch.sqrt(emit[0] * emit[0] + emit[1] * emit[1]
                                  + emit[2] * emit[2]) > EPS
        for k in range(3):
            direct = torch.where(cur_emissive, col[k], eA[k] * kd[k] * nee_s)
            acc[k] = acc[k] + torch.where(live, tp[k] * direct, 0.0)

        # ---- primary miss -> background, once per restarted sample
        hit_b = tB < BIG
        p_miss = restart & ~hit_b
        for k in range(3):
            acc[k] = acc[k] + torch.where(p_miss, bg[k], 0.0)

        # ---- state update
        emis_b = torch.sqrt(eB[0] * eB[0] + eB[1] * eB[1] + eB[2] * eB[2]) > EPS
        depth_n = depth + 1
        live_b = (live & survive & (pdf_b >= EPS) & hit_b & ~emis_b
                  & (depth_n < max_bounces))
        new_live = live_b | (restart & hit_b)
        wgt = torch.where(wdn > 0, cos_o / torch.clamp(pdf_b * p_rr, min=1e-30),
                          0.0) * INV_PI
        tp_n = tuple(torch.where(restart, 1.0, tp[k] * kd[k] * wgt)
                     for k in range(3))
        pos_n = tuple(o[k] + bd[k] * tB for k in range(3))
        nrm_n = _norm3(*nB, 1e-20)
        col_n = tuple(torch.where(sB, 0.0, kB[k]) for k in range(3))
        pos = _where3(new_live, pos_n, pos)
        nrm = _where3(new_live, nrm_n, nrm)
        kd = _where3(new_live, kB, kd)
        emit = _where3(new_live, eB, emit)
        col = _where3(new_live, col_n, col)
        tp = _where3(new_live, tp_n, tp)
        live = new_live
        next_s = torch.where(restart, next_s + 1, next_s)
        depth = torch.where(restart, 0, depth_n)

    if stats is not None:
        stats["lane_iterations"] = stats.get("lane_iterations", 0) + int(per_lane.sum())
        stats["per_lane"] = stats.get("per_lane", 0) + per_lane
        _add_tally(stats, tally)
    return torch.stack(acc)


def _add_tally(stats: dict, tally: dict) -> None:
    for k in ("row_tests", "slab_tests", "slots", "slots_thread"):
        stats[k] = stats.get(k, 0) + tally.get(k, 0)


# ------------------------------------------------ the fused bounce kernel
#
# `fused_bounce_group` runs up to `n_bounces` bounces of every lane of an
# explicit wavefront (ops/pallas_path.py:635-797). A bounce draws twelve
# uniforms in a fixed order (emitter pick 1, Box-Muller 4 + 4, roulette 1,
# hemisphere 2) from `utils/rng.bounce_uniform`: draw k of bounce b has
# counter 12 b + k + 1. The light direction comes from two Box-Muller
# triples (not the camera kernel's (z, phi) form), and the BRDF factor
# Kd/pi is multiplied in before the weight, as the JAX kernel orders it.
#
# Dead lanes: a lane that is dead at the start of a bounce keeps its
# state as it is; a lane that dies in a bounce still takes that bounce's
# state update. (The JAX kernel goes on updating dead lanes' state, which
# nothing reads: compare states on live lanes only.) acc and live are
# defined on every lane.

STATE_ROWS = 18  # [pos | nrm | kd | emit | color | throughput]
# a live lane between two bounces of the bounce-major kernel: its state
# rows and its three sums (csrc/path_bounce.cu kScratchRows); a done lane:
# those, live and padding (kDoneRows)
BOUNCE_SCRATCH_ROWS = STATE_ROWS + 3
BOUNCE_DONE_ROWS = 24


def _check_state(state: torch.Tensor, live: torch.Tensor, device) -> int:
    _check_table("state", state, torch.float32, None, device)
    _check_table("live", live, torch.bool, None, device)
    if state.dim() != 2 or state.shape[0] != STATE_ROWS:
        raise ValueError(f"state has shape {tuple(state.shape)}, expected "
                         f"({STATE_ROWS}, N)")
    if live.shape != (state.shape[1],):
        raise ValueError(f"live has shape {tuple(live.shape)}, expected "
                         f"({state.shape[1]},)")
    if state.shape[1] >= 2 ** 31:
        raise ValueError("too many lanes: lane ids must fit int32")
    return state.shape[1]


def _bounce_fn():
    from software_rasterizer_tpu_torch.utils.cuda_build import load_library

    lib = load_library("path_bounce", ["path_bounce.cu"])
    fn = lib.srt_path_bounce
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([vp] * 9 + [ci] * 6 + [cf] + [vp] * 4 + [ci] * 2 + [vp] * 4
                       + [vp, ci, vp, vp])
        fn.restype = ci
    return fn


def build_bounce_kernel() -> None:
    """Compile (or reuse) and load the bounce kernel's CUDA library."""
    _bounce_fn()


def launch_path_bounce(tri: torch.Tensor, attr: torch.Tensor,
                       sph: torch.Tensor, ecr: torch.Tensor,
                       state: torch.Tensor, live: torch.Tensor, *,
                       n_tri: int, n_sph: int, n_emitters: int, seed: int,
                       n_bounces: int, p_rr: float,
                       cull_tables: Optional[CullTables] = None,
                       tally: Optional[torch.Tensor] = None,
                       timeline: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/path_bounce.cu on the current stream; returns (acc
    (3,N), state (18,N), live (N,)). `cull_tables` and `tally` as in
    `launch_path_camera` (a (5,) tally's loop entries count lane-bounces).
    The full sweep is one cooperative launch that runs bounce-major over
    lists of the live lanes, in a workspace allocated here (two planes of
    `BOUNCE_SCRATCH_ROWS` floats, `BOUNCE_DONE_ROWS` floats and two ints a
    lane, 272 bytes); a `timeline` (n_bounces + 3,) int64 tensor gets its
    device clock in ns at its start, after it built the first list, after
    each bounce (the entries after the bounce in which the last live lane
    died are not written) and at its end. Checks
    every operand and raises on a launch error;
    nothing falls back to another schedule."""
    global LAUNCHES_BOUNCE, LAUNCHES_BOUNCE_CULLED
    device = state.device
    if device.type != "cuda":
        raise ValueError(f"launch_path_bounce needs CUDA tensors, got {device}")
    f32 = torch.float32
    _check_table("tri_table", tri, f32, 12, device)
    _check_table("attr", attr, f32, 16, device)
    _check_table("sph", sph, f32, 12, device)
    _check_table("emitter_cr", ecr, f32, 4, device)
    n = _check_state(state, live, device)
    if attr.shape[0] != tri.shape[0] or not 0 <= n_tri <= tri.shape[0]:
        raise ValueError("triangle tables disagree with n_tri")
    if not 0 <= n_sph <= sph.shape[0]:
        raise ValueError("n_sph exceeds the sphere table")
    if ecr.shape[0] < max(n_emitters, 1):
        raise ValueError("emitter table has fewer rows than emitters")
    if n_bounces < 0:
        raise ValueError(f"bad n_bounces={n_bounces}")
    cull_args = _check_cull(cull_tables, n_tri, device)
    tally_ptr = _check_tally(tally, device, slots=True)
    if timeline is not None:
        _check_table("timeline", timeline, torch.int64, None, device)
        if cull_tables is not None or timeline.shape != (n_bounces + 3,):
            raise ValueError(f"timeline has shape {tuple(timeline.shape)}, expected "
                             f"({n_bounces + 3},), and the full sweep")
    out_state = torch.empty_like(state)
    out_live = torch.empty_like(live)
    acc = torch.empty((3, n), dtype=f32, device=device)
    if n == 0:
        return acc, out_state, out_live
    seed = int(seed) & 0xFFFFFFFF
    tri = trace_tiers._aligned(tri)
    if cull_tables is None:
        # three list lengths (zero), two lists of columns, two scratch
        # planes, a done row a column
        work = (torch.zeros(3, dtype=torch.int32, device=device),
                torch.empty((2, n), dtype=torch.int32, device=device),
                torch.empty((2, BOUNCE_SCRATCH_ROWS, n), dtype=f32, device=device),
                torch.empty((n, BOUNCE_DONE_ROWS), dtype=f32, device=device))
        work_ptrs = tuple(t.data_ptr() for t in work)
    else:
        work_ptrs = (None,) * 4
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _bounce_fn()(
        tri.data_ptr(), attr.data_ptr(), sph.data_ptr(), ecr.data_ptr(),
        state.data_ptr(), live.data_ptr(), out_state.data_ptr(),
        out_live.data_ptr(), acc.data_ptr(),
        n_tri, n_sph, n_emitters, n, n_bounces,
        seed - (1 << 32) if seed >= 1 << 31 else seed, float(p_rr), *cull_args,
        *work_ptrs, tally_ptr, 0 if tally is None else tally.shape[0],
        None if timeline is None else timeline.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"path_bounce kernel launch failed: cudaError {rc}")
    if cull_tables is None:
        LAUNCHES_BOUNCE += 1
    else:
        LAUNCHES_BOUNCE_CULLED += 1
    return acc, out_state, out_live


def fused_bounce_group(scene: RTScene, state: torch.Tensor,
                       live: torch.Tensor, seed: int, n_bounces: int,
                       p_rr: float = 0.8, cull: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run up to `n_bounces` fused bounces. state: (18,N) float32 rows
    [pos, nrm, kd, emit, color, throughput] (component-major); live: (N,)
    bool; seed: a 32-bit word. Returns (acc (3,N), new state, new live).
    `cull` names the tier (None: `use_cull`); both give the same result.
    CUDA scenes run the kernel; CPU scenes run `fused_bounce_group_plain`."""
    device = scene.device
    if device.type == "cpu":
        return nan_check("fused_bounce_group", fused_bounce_group_plain(
            scene, state, live, seed, n_bounces, p_rr, cull=cull))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    attr, sph, n_sph = pack_scene_tables(scene)
    return nan_check("fused_bounce_group", launch_path_bounce(
        scene.tri_table.float().contiguous(), attr, sph,
        scene.emitter_cr.float().contiguous(), state.contiguous(),
        live.contiguous(), n_tri=scene.n_tri, n_sph=n_sph,
        n_emitters=scene.n_emitters, seed=seed, n_bounces=n_bounces, p_rr=p_rr,
        cull_tables=pack_cull_tables(scene) if use_cull(scene, cull) else None))


def _bounce_plain(tabs: _Tables, ecr: torch.Tensor, n_e: int, p_rr: float,
                  seed: int, lane: torch.Tensor, b: int, st: tuple, active,
                  tally: Optional[dict], slice_rows: Optional[int] = None):
    """Bounce b of the lanes `lane` ((M,) columns: the draws' keys) in
    state `st` ((pos, nrm, kd, emit, col, tp), each three (M,) rows):
    sampleLight, roulette, the hemisphere, both traces (`_dual_trace` with
    `active`, `tally` and `slice_rows`), the NEE term. Returns the term a
    live lane adds to its sum (three (M,) rows), its state after the
    bounce and whether it lives on, for every lane: the caller keeps what
    the lanes that were live take."""
    pos, nrm, kd, emit, col, tp = st
    any_e = n_e > 0
    n_e_f = float(max(n_e, 1))

    def gauss3(c):
        u1, u2, u3, u4 = (bounce_uniform(seed, lane, c + k) for k in range(4))
        r1 = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
        r2 = torch.sqrt(-2.0 * torch.log(torch.clamp(u3, min=1e-12)))
        a2 = TWO_PI * u2
        return r1 * torch.cos(a2), r1 * torch.sin(a2), r2 * torch.cos(TWO_PI * u4)

    c0 = 12 * b
    nn = _norm3(*nrm)

    # ---- sampleLight (Scene.cpp:429-476): draws 1-9
    u_pick = bounce_uniform(seed, lane, c0 + 1)
    k_e = torch.clamp(torch.floor(u_pick * n_e_f).to(torch.int64),
                      max=max(n_e - 1, 0))
    row = ecr[k_e]
    cc = (row[:, 0], row[:, 1], row[:, 2])
    crad = row[:, 3]
    bl = _norm3(cc[0] - pos[0], cc[1] - pos[1], cc[2] - pos[2])
    sx, sy, sz = _norm3(*gauss3(c0 + 2), 1e-20)
    flip = sx * bl[0] + sy * bl[1] + sz * bl[2] < 0
    sx, sy, sz = _where3(flip, (-sx, -sy, -sz), (sx, sy, sz))
    hx, hy, hz = _norm3(*gauss3(c0 + 6), 1e-20)
    sx, sy, sz = _norm3(sx + 1e-6 * hx, sy + 1e-6 * hy, sz + 1e-6 * hz)
    spx, spy, spz = cc[0] + sx * crad, cc[1] + sy * crad, cc[2] + sz * crad
    ll = _norm3(spx - pos[0], spy - pos[1], spz - pos[2])
    cos_t = ll[0] * bl[0] + ll[1] * bl[1] + ll[2] * bl[2]
    pdf_l = cos_t * INV_2PI if any_e else torch.zeros_like(cos_t)

    # ---- RR + uniform hemisphere (Material.cpp:14-34): draws 10-12
    survive = bounce_uniform(seed, lane, c0 + 10) <= p_rr
    x1 = bounce_uniform(seed, lane, c0 + 11)
    x2 = bounce_uniform(seed, lane, c0 + 12)
    zl = (1.0 - 2.0 * x1).abs()
    rl = torch.sqrt(torch.clamp(1.0 - zl * zl, min=0.0))
    phi = TWO_PI * x2
    w = _norm3(*_to_world(rl * torch.cos(phi), rl * torch.sin(phi), zl, *nn))
    wdn = w[0] * nn[0] + w[1] * nn[1] + w[2] * nn[2]
    cos_o = torch.clamp(wdn, min=0.0)
    pdf_b = torch.where(wdn > 0, INV_2PI, 0.0)
    fr = tuple(torch.where(wdn > 0, kd[k] * INV_PI, 0.0) for k in range(3))

    # ---- both traces, one primitive loop
    o = tuple(pos[k] + 1e-6 * nn[k] for k in range(3))
    (tA, nA, eA), (tB, nB, kB, eB, sB) = _dual_trace(
        tabs, o, ll, w, active, tally, slice_rows)

    # ---- NEE evaluation (Scene.cpp:671-717)
    hit_a = tA < BIG
    d3 = tuple(pos[k] - (o[k] + ll[k] * tA) for k in range(3))
    dist2 = d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]
    not_shadow = (tA * tA - dist2).abs() <= 1e-4
    lit = hit_a & (torch.sqrt(eA[0] * eA[0] + eA[1] * eA[1]
                              + eA[2] * eA[2]) > EPS)
    if not any_e:
        lit = torch.zeros_like(lit)
    sn = _norm3(*nA, 1e-20)
    cos_on = torch.clamp(nn[0] * ll[0] + nn[1] * ll[1] + nn[2] * ll[2],
                         min=0.0)
    cos_ln = torch.clamp(-(sn[0] * ll[0] + sn[1] * ll[1] + sn[2] * ll[2]),
                         min=0.0)
    ldn = ll[0] * nn[0] + ll[1] * nn[1] + ll[2] * nn[2]
    pdf_ok_l = (pdf_l >= EPS) & (pdf_l < BIG) & (pdf_l == pdf_l)
    denom = torch.where(pdf_ok_l, pdf_l, 1.0) * torch.clamp(dist2, min=1e-30)
    scale = torch.where(lit & not_shadow & pdf_ok_l,
                        cos_on * cos_ln / denom, 0.0)
    cur_emissive = torch.sqrt(emit[0] * emit[0] + emit[1] * emit[1]
                              + emit[2] * emit[2]) > EPS
    term = []
    for k in range(3):
        nee = eA[k] * torch.where(ldn > 0, kd[k] * INV_PI, 0.0) * scale
        term.append(tp[k] * torch.where(cur_emissive, col[k], nee))

    # ---- state update
    emis_b = torch.sqrt(eB[0] * eB[0] + eB[1] * eB[1] + eB[2] * eB[2]) > EPS
    lives = survive & (pdf_b >= EPS) & (tB < BIG) & ~emis_b
    wgt = cos_o / torch.clamp(pdf_b * p_rr, min=1e-30)
    after = (tuple(o[k] + w[k] * tB for k in range(3)), _norm3(*nB, 1e-20), kB, eB,
             tuple(torch.where(sB, 0.0, kB[k]) for k in range(3)),
             tuple(tp[k] * fr[k] * wgt for k in range(3)))
    return term, after, lives


def _bounce_inputs(scene: RTScene, state: torch.Tensor, live: torch.Tensor,
                   p_rr: float):
    state, live = state.contiguous(), live.contiguous()
    n = _check_state(state, live, scene.device)
    return (state, live, n, scene.emitter_cr.float(), scene.n_emitters,
            float(torch.tensor(p_rr, dtype=torch.float32)))


def _state_rows(state: torch.Tensor) -> tuple:
    rows = [state[i] for i in range(STATE_ROWS)]
    return tuple(tuple(rows[3 * g:3 * g + 3]) for g in range(6))


def fused_bounce_group_plain(scene: RTScene, state: torch.Tensor,
                             live: torch.Tensor, seed: int, n_bounces: int,
                             p_rr: float = 0.8, stats: Optional[dict] = None,
                             cull: Optional[bool] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `fused_bounce_group` (same signature and
    semantics), on the scene's device. A `stats` dict gets
    "lane_bounces": the bounces summed over the lanes live at their start
    (the kernel's unit of work), "per_lane": those bounces lane by lane
    ((N,) int64), and "row_tests" / "slab_tests" as in
    `path_camera_render_plain`."""
    state, live, n, ecr, n_e, p_rr = _bounce_inputs(scene, state, live, p_rr)
    dev = scene.device
    tabs = _plain_tables(scene, cull)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    st = _state_rows(state)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    acc = [zero, zero, zero]
    per_lane = torch.zeros(n, dtype=torch.int64, device=dev)
    tally = {} if stats is not None else None

    for b in range(n_bounces):
        if not bool(live.any()):
            break
        per_lane += live.long()
        term, after, lives = _bounce_plain(tabs, ecr, n_e, p_rr, seed, lane, b,
                                           st, live, tally)
        for k in range(3):
            acc[k] = acc[k] + torch.where(live, term[k], 0.0)
        # the lanes live at the start of the bounce take its state
        st = tuple(_where3(live, a, old) for a, old in zip(after, st))
        live = live & lives

    if stats is not None:
        stats["lane_bounces"] = stats.get("lane_bounces", 0) + int(per_lane.sum())
        stats["per_lane"] = stats.get("per_lane", 0) + per_lane
        _add_tally(stats, tally)
    return torch.stack(acc), torch.stack([x for g in st for x in g]), live


def bounce_major_plain(scene: RTScene, state: torch.Tensor, live: torch.Tensor,
                       seed: int, n_bounces: int, p_rr: float = 0.8,
                       order_seed: int = 0, stats: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A CPU model of the full sweep's bounce-major schedule
    (csrc/path_bounce.cu path_bounce_major), for the tests and the chip
    smoke test: for b in [0, n_bounces) the list of the lanes live at the
    start of bounce b, in an order shuffled by a `torch.Generator` seeded
    with `order_seed`, runs bounce b, each lane with its column's draws and
    the staged sweep's triangle search (`staged_sweep_plain`); a lane adds
    the bounce's term to its sum and takes its state, and the lanes that
    live on form the next list. Returns what `fused_bounce_group_plain`
    returns, bit for bit. A `stats` dict gets "lane_bounces" and "slots":
    the lane-slots of warps of `WARP` over each bounce's list."""
    state, live, n, ecr, n_e, p_rr = _bounce_inputs(scene, state, live, p_rr)
    dev = scene.device
    tabs = _plain_tables(scene, False)
    gen = torch.Generator()
    gen.manual_seed(order_seed)
    out = state.clone()
    out_live = live.clone()
    acc = torch.zeros((3, n), dtype=torch.float32, device=dev)
    cur = torch.nonzero(live).flatten()
    lane_bounces = slots = 0
    for b in range(n_bounces):
        if cur.numel() == 0:
            break
        m = cur.numel()
        cur = cur[torch.randperm(m, generator=gen).to(dev)]
        lane_bounces += m
        slots += WARP * -(-m // WARP)
        term, after, lives = _bounce_plain(
            tabs, ecr, n_e, p_rr, seed, cur, b, _state_rows(out[:, cur]), None, None,
            STAGE_ROWS)
        acc[:, cur] = torch.stack([acc[k, cur] + term[k] for k in range(3)])
        out[:, cur] = torch.stack([x for g in after for x in g])
        out_live[cur] = lives
        cur = cur[lives]
    if stats is not None:
        stats["lane_bounces"] = stats.get("lane_bounces", 0) + lane_bounces
        stats["slots"] = stats.get("slots", 0) + slots
    return acc, out, out_live


def loop_slots(per_lane: torch.Tensor) -> Tuple[int, int]:
    """Lane-slots a loop costs warps of `WARP` lanes (in launch order),
    given the iterations each lane is active in (`per_lane`, (N,) ints; a
    lane active in k iterations is active in the first k), under two
    schedules: the static one, each lane running its own loop, so a warp
    issues 32 slots an iteration until its longest lane is done (the
    camera kernel, and the per-lane bounce loop); and the bounce-major
    one, iteration b running the list of the lanes still active, 32 slots
    for every 32 of them or part. Their SIMT efficiency is
    per_lane.sum() / slots."""
    c = per_lane.long().flatten()
    c = torch.nn.functional.pad(c, (0, -c.numel() % WARP))
    static = WARP * int(c.reshape(-1, WARP).amax(dim=1).sum()) if c.numel() else 0
    top = int(c.max()) if c.numel() else 0
    alive = c.numel() - torch.cumsum(torch.bincount(c, minlength=top + 1), 0)[:top]
    major = WARP * int(torch.div(alive + WARP - 1, WARP, rounding_mode="floor").sum())
    return static, major
