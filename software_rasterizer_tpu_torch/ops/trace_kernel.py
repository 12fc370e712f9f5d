"""Nearest-triangle trace kernel (the port of the JAX package's
`ops/pallas_trace.trace_nearest_vpu` / `_vpu_trace_kernel`).

For every ray, exact Moller-Trumbore against every row of the
`[v0|e1|e2|pad]` triangle table: the nearest accepted t and its index.
Rejects |det| < 1e-6, u or v outside [0,1], u + v > 1 and t < 1e-6; a
strict `<` keeps the lowest index on a tie; invalid rows are zero and
rejected by det = 0; NaN comparisons are false, so a NaN ray misses.

  * `trace_nearest_vpu`: the entry point. On CUDA tensors it launches
    the hand-written kernel (csrc/trace_nearest.cu) and counts the launch
    in `LAUNCHES`; on CPU tensors it runs the plain version.
  * `trace_nearest_vpu_plain`: the same computation in plain PyTorch,
    vectorized over rays, looping over triangles, in the kernel's
    operation order.

`nearest_hit` takes this kernel for scenes of up to 1024 triangles and
the chunk-culled tiers of `ops/trace_tiers.py` above; the kernel itself
takes any triangle count (the loop runs n_tri times) and is what those
tiers are held against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

BIG = 1e30

# kernel launches made by trace_nearest_vpu (the plain version is not
# counted); a caller may reset it to 0 to count one run
LAUNCHES = 0


def _check(name: str, t: torch.Tensor, dtype, cols: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (*, {cols})")


def _check_operands(tri_table, n_tri, orig, d) -> int:
    f32 = torch.float32
    _check("tri_table", tri_table, f32, 12, orig.device)
    _check("orig", orig, f32, 3, orig.device)
    _check("d", d, f32, 3, orig.device)
    if d.shape != orig.shape:
        raise ValueError(f"rays must be (N,3); got {tuple(orig.shape)} and "
                         f"{tuple(d.shape)}")
    if not 0 <= n_tri <= tri_table.shape[0]:
        raise ValueError(f"n_tri={n_tri} is outside the table's "
                         f"{tri_table.shape[0]} rows")
    if orig.shape[0] >= 2 ** 31:
        raise ValueError("too many rays: ray ids must fit int32")
    return orig.shape[0]


# ---------------------------------------------------------------- CUDA


def _cuda_fn():
    from software_rasterizer_tpu_torch.utils.cuda_build import load_library

    lib = load_library("trace_nearest", ["trace_nearest.cu"])
    fn = lib.srt_trace_nearest
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def build_kernel() -> None:
    """Compile (or reuse) and load the CUDA library."""
    _cuda_fn()


def launch_trace_nearest(tri_table: torch.Tensor, n_tri: int,
                         orig: torch.Tensor, d: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/trace_nearest.cu on the current stream. Checks every
    operand and raises on a launch error."""
    global LAUNCHES
    device = orig.device
    if device.type != "cuda":
        raise ValueError(f"launch_trace_nearest needs CUDA tensors, got {device}")
    n = _check_operands(tri_table, n_tri, orig, d)
    tri_table, orig, d = tri_table.contiguous(), orig.contiguous(), d.contiguous()
    hit = torch.empty(n, dtype=torch.bool, device=device)
    idx = torch.empty(n, dtype=torch.int64, device=device)
    t = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return hit, idx, t
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _cuda_fn()(tri_table.data_ptr(), n_tri, orig.data_ptr(), d.data_ptr(),
                    n, hit.data_ptr(), idx.data_ptr(), t.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"trace_nearest kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return hit, idx, t


def trace_nearest_vpu(tri_table: torch.Tensor, n_tri: int, orig: torch.Tensor,
                      d: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest triangle of the (N,3) float32 rays `orig`, `d` over the
    first `n_tri` rows of `tri_table` (F,12). Returns (hit (N,) bool, idx
    (N,) int64 with -1 on a miss, t (N,) float32 with 1e30 on a miss).
    CUDA rays run the kernel; CPU rays run `trace_nearest_vpu_plain`."""
    device = orig.device
    if device.type == "cpu":
        return trace_nearest_vpu_plain(tri_table, n_tri, orig, d)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return launch_trace_nearest(tri_table, n_tri, orig, d)


# --------------------------------------------------------- plain version


def trace_nearest_vpu_plain(tri_table: torch.Tensor, n_tri: int,
                            orig: torch.Tensor, d: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `trace_nearest_vpu` (same signature and
    semantics), on the rays' device."""
    n = _check_operands(tri_table, n_tri, orig, d)
    rows = tri_table[:n_tri].float().cpu().tolist()
    ox, oy, oz = orig[:, 0], orig[:, 1], orig[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=orig.device)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=orig.device)
    for f, (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, *_) in enumerate(rows):
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
        tm = torch.where(ok, t, BIG)
        better = tm < best_t   # strict <: the lowest index wins a tie
        best_t = torch.where(better, tm, best_t)
        best_f = torch.where(better, f, best_f)
    hit = best_t < BIG
    return hit, torch.where(hit, best_f, -1), best_t


def mt_plane(orig: torch.Tensor, d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(N, C) t of the rays `orig`, `d` (N,3) against the table rows
    `rows` (C,12), BIG where rejected: the test of
    `trace_nearest_vpu_plain`, expression for expression, on whole planes.
    What the chunked plain sweeps share."""
    ox, oy, oz = orig[:, 0:1], orig[:, 1:2], orig[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (rows[None, :, k] for k in range(9))
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
    return torch.where(ok, t, BIG)


def plane_winner(tm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Of an (N, C) plane of t: each ray's smallest t (N,) and the lowest
    column that holds it (N,) int64."""
    ct = tm.amin(dim=1)
    cols = torch.arange(tm.shape[1], device=tm.device)[None]
    never = torch.iinfo(torch.int64).max
    return ct, torch.where(tm == ct[:, None], cols, never).amin(dim=1)
