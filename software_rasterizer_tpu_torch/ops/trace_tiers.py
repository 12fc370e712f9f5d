"""Chunked nearest-triangle tiers for large scenes (the ports of the JAX
package's `ops/pallas_trace.py` kernels `_trace_kernel2c`,
`_cull_prepass_kernel`, `_trace_kernel3`, `_trace_kernel2` and the
unculled `_trace_kernel`), and the per-ray culled walk of the path and
Whitted kernels' plain versions.

The triangles are the `[v0|e1|e2|pad]` rows of `RTScene.tri_table` in BVH
leaf order, cut into chunks of `chunk` rows with one box a chunk
(`chunk_bounds`); the rays are cut into blocks of `block` consecutive
rays. A ray block visits a chunk iff at least one of its rays passes the
slab test of the chunk's box (`ops/bvh.slab_test`). The test is
conservative, so every tier returns what `trace_nearest_vpu` returns over
the whole table, bit for bit: (hit (N,) bool, idx (N,) int64 with -1 on a
miss, t (N,) float32 with 1e30 on a miss), the lowest index among equal
t. `block` and `chunk` change the work, never a result.

  * `trace_nearest_mm2c`: the two-level cull (super-chunks of
    `MM2C_SUPER` chunks, then chunks) fused into the sweep; no mask, no
    lists. The tier of 1K-16K triangles. Its kernel votes per warp, and
    streams the rows of the chunks a warp enters as the streamed tier
    does (`fused_warp_plain` models it).
  * `cull_prepass` + `chunk_lists` + `trace_nearest_mm2`: the (nb, nc)
    mask as a tensor, its ascending lists of surviving chunks, and the
    sweep over each block's list, each warp of a ray block sweeping every
    listed chunk with its rows streamed as below (`listed_warp_plain(vote=
    False)` models it); `cull=False` lists every chunk. The
    prepass kernel votes per warp on the super-chunk boxes first and skips
    a super's chunks only where that is proven exact (`ray_proven`,
    `super_proven`; `cull_prepass_warp_plain` models it), so its mask is
    the flat test's bit for bit.
  * `trace_nearest_mm2_stream`: the same lists, each warp of a ray
    block voting on each listed chunk's box and sweeping only the chunks
    some ray of it enters, its rows streamed while the last slice is
    swept. The tier above 16K triangles.
  * `trace_nearest_mm`: no boxes and no lists, every chunk of the table
    staged in turn for every ray block (`nearest_hit(backend="mm")`).

The fused, listed, streamed and unculled kernels test each (ray, row) pair
in two stages with a warp vote (`trace_kernel.mt_plane_two_stage`), as
kernel #2 does, and take a `tally`: an (`TALLY_ENTRIES`,) int64 tensor
that gets the work they did (`TALLY_NAMES`). `fused_warp_plain`,
`listed_warp_plain`, `unculled_tally_plain` and, for kernel #2,
`nearest_tally_plain` are the plain models of that work, and of the
per-warp sweeps' results. The prepass kernel's tally has
`CULL_TALLY_ENTRIES` entries (`CULL_TALLY_NAMES`).

`walk_nearest_plain` is the per-ray form of the cull: each ray tests the
rows of the leaves (runs of `LEAF` rows) whose boxes it enters, under the
super-chunk and chunk boxes it enters, itself: the tests the culled
instances of the path and Whitted kernels make (`CullTables`,
`cull_tables`). `warp_walk_plain` models how those kernels' warps
schedule the tests (csrc/trace_common.cuh warp_walk_chunks) and counts the
slots they issue.

On CUDA tensors each entry point launches its hand-written kernel
(csrc/trace_culled.cu) and counts the launch; on CPU tensors it runs its
`*_plain` version. The JAX package's 13-feature bilinear matmul, its
coefficient layouts and its mask bit plane (with its 8192-chunk cap) are
TPU form: here every (ray, row) test is the exact Moller-Trumbore of
`trace_nearest_vpu`, and the mask has no cap. The cumsum and scatter that
turn the mask into lists are plain tensor code in both packages.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from software_rasterizer_tpu_torch.ops.bvh import _inv_dir, _slab, slab_test
from software_rasterizer_tpu_torch.ops.trace_kernel import (
    BIG,
    NEAREST_RAYS,
    NEAREST_THREADS,
    TALLY_ENTRIES,
    TALLY_NAMES,
    _aligned,
    _check,
    _check_operands,
    check_tally,
    mt_plane,
    mt_stage1_plane,
    plane_winner,
)

MM2C_SUPER = 8      # chunks a super-chunk of the fused cull's first level
MAX_CHUNK = 256     # rows of a chunk the kernels stage in shared memory
MAX_BLOCK = 2048    # rays of a ray block (8 a thread, 256 threads)
MM_MAX_CHUNK = 512  # rows of a chunk the unculled kernel stages
# rays a ray block of the unculled kernel, a tuning value that changes no
# result: of 256, 512, 1024 and 2048, 1,048,576 camera rays and as many
# bounce rays against the 9,216-triangle tessellated Cornell box took the
# least time at 1024 on an H100, with the two-stage test as before it
# (chip_smoke.py phase 25 measures it anew)
MM_BLOCK = 1024
# rays a ray block. A tuning value that changes no result: of 32, 64, 128,
# 512, 1024 and 2048, 1,048,576 camera rays in image order against the
# tessellated Cornell box took the least time at 64 on an H100, both at
# 9,216 triangles (fused cull) and at 147,456 (prepass, lists and streamed
# sweep together); chip_smoke.py phase 24 measures it anew
DEFAULT_BLOCK = 64
# (ray, row) tests of one step of the plain sweep (bounds its memory)
_PLAIN_STEP = 1 << 22
# the path kernels' warp walk: threads a warp, rows of a leaf box (one a
# thread of a warp, csrc/trace_common.cuh kLeaf) and leaves of a staged
# slice (kSliceLeaves)
WARP = 32
LEAF = 32
SLICE_LEAVES = 4
# rays of a warp at most whose (ray, child box) pairs the warp tests one a
# thread (csrc/trace_common.cuh kCoopRays, `box_steps`)
COOP_RAYS = 24
# the leaf boxes' outward margin, a share of the scene's extent (8 float32
# ulps at it): a ray through an edge that two coplanar triangles of
# different leaves share meets both flat boxes only at a face, where the
# slab test's rounding dropped both for some rays of the tessellated
# Cornell box (tests/test_torch_warp_walk.py). A wider box adds tests and
# changes no winner.
LEAF_PAD = 2.0 ** -20
# threads of a CUDA block of the tier kernels (csrc/trace_culled.cu
# kMaxThreads)
MAX_THREADS = 256
# The tally of the two-stage kernels, TALLY_NAMES and TALLY_ENTRIES, is
# trace_kernel.py's (kernel #2 counts the same entries).
# The tally of the prepass kernel #5 (csrc/trace_culled.cu CullTally), in
# order: the active rays' slab tests on super boxes and on chunk boxes, the
# (warp, super) pairs, those whose vote no ray passed (the super's chunks
# skipped), those taken child by child because condition (a) or (b)
# failed, and the warp votes on chunk boxes.
CULL_TALLY_NAMES = ("super_tests", "chunk_tests", "warp_supers", "warp_supers_skipped",
                    "warp_supers_unproven", "warp_chunk_votes")
CULL_TALLY_ENTRIES = len(CULL_TALLY_NAMES)

# kernel launches (the plain versions are not counted); a caller may
# reset them to 0 to count one run
LAUNCHES_MM2C = 0   # trace_fused_cull_kernel
LAUNCHES_CULL = 0   # cull_prepass_kernel
LAUNCHES_MM2 = 0    # trace_listed_all_kernel
LAUNCHES_MM2S = 0   # trace_listed_stream_kernel
LAUNCHES_MM = 0     # trace_unculled_kernel

Trace = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ------------------------------------------------------------ the tables


def chunk_bounds(v0, v1, v2, valid, chunk: int):
    """Per-chunk boxes over (leaf-ordered) triangles: (lo (nc,3), hi
    (nc,3)) float32 with nc = ceil(F / chunk). Invalid rows contribute
    nothing; a chunk with no valid row gets the inverted box (1e30,
    -1e30), and its rows are zero rows that no ray hits."""
    f = v0.shape[0]
    nc = -(-f // chunk)
    m = valid[:, None]
    lo = torch.where(m, torch.minimum(torch.minimum(v0, v1), v2), BIG)
    hi = torch.where(m, torch.maximum(torch.maximum(v0, v1), v2), -BIG)
    pad = nc * chunk - f
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, 3), BIG)])
        hi = torch.cat([hi, hi.new_full((pad, 3), -BIG)])
    return (lo.reshape(nc, chunk, 3).amin(dim=1).float(),
            hi.reshape(nc, chunk, 3).amax(dim=1).float())


def super_bounds(chunk_lo, chunk_hi):
    """Boxes of the super-chunks of `MM2C_SUPER` chunks: (lo2 (nsc,3), hi2
    (nsc,3)), nsc = ceil(nc / MM2C_SUPER); the tail super-chunk is short."""
    nc = chunk_lo.shape[0]
    nsc = -(-nc // MM2C_SUPER)
    pad = nsc * MM2C_SUPER - nc
    if pad:
        chunk_lo = torch.cat([chunk_lo, chunk_lo.new_full((pad, 3), BIG)])
        chunk_hi = torch.cat([chunk_hi, chunk_hi.new_full((pad, 3), -BIG)])
    return (chunk_lo.reshape(nsc, MM2C_SUPER, 3).amin(dim=1),
            chunk_hi.reshape(nsc, MM2C_SUPER, 3).amax(dim=1))


def leaf_bounds(v0, v1, v2, valid, origin=None):
    """Boxes of the leaves, runs of `LEAF` rows: `chunk_bounds` at
    `LEAF`, (lo3 (nl,3), hi3 (nl,3)), nl = ceil(F / LEAF), each box of a
    valid row widened outward on every axis by `LEAF_PAD` x the scene's
    extent: the largest |coordinate| of the valid triangles and of
    `origin` (the eye), on the device, with no sync."""
    lo, hi = chunk_bounds(v0, v1, v2, valid, LEAF)
    ok = (lo <= hi).all(dim=1, keepdim=True)
    extent = torch.where(ok, torch.maximum(lo.abs(), hi.abs()), 0.0).amax()
    if origin is not None:
        extent = torch.maximum(extent, origin.abs().amax())
    pad = LEAF_PAD * extent
    return torch.where(ok, lo - pad, lo), torch.where(ok, hi + pad, hi)


class CullTables(NamedTuple):
    """The boxes a per-ray walk reads: chunks of `chunk` rows of the
    triangle table (lo, hi (nc,3)), super-chunks of `MM2C_SUPER` chunks
    (lo2, hi2 (nsc,3)) and leaves of `LEAF` rows (lo3, hi3 (nl,3)),
    `chunk // LEAF` a chunk."""

    lo: torch.Tensor
    hi: torch.Tensor
    lo2: torch.Tensor
    hi2: torch.Tensor
    lo3: torch.Tensor
    hi3: torch.Tensor
    chunk: int


def cull_tables(chunk_lo, chunk_hi, chunk: int, leaf_lo, leaf_hi) -> CullTables:
    """`CullTables` of the chunk boxes `chunk_lo/hi` of `chunk` rows (a
    multiple of `LEAF`) and the leaf boxes `leaf_lo/hi` of the same rows
    (`leaf_bounds`)."""
    lo2, hi2 = super_bounds(chunk_lo, chunk_hi)
    return CullTables(*(x.float().contiguous() for x in (chunk_lo, chunk_hi, lo2, hi2,
                                                          leaf_lo, leaf_hi)), int(chunk))


def chunk_lists(mask: torch.Tensor):
    """(counts (nb,) int32, lists (nb, nc) int32) of a (nb, nc) mask:
    row b of `lists` starts with the `counts[b]` chunks whose mask is
    set, in ascending order (the rest is 0)."""
    nb, nc = mask.shape
    m = mask.bool()
    pos = torch.cumsum(m, dim=1, dtype=torch.int32) - 1
    counts = m.sum(dim=1, dtype=torch.int32)
    tgt = torch.where(m, pos, nc).long()
    src = torch.arange(nc, dtype=torch.int32, device=mask.device).expand(nb, nc)
    lists = torch.zeros((nb, nc + 1), dtype=torch.int32, device=mask.device)
    lists.scatter_(1, tgt, src)
    return counts, lists[:, :nc].contiguous()


def _all_chunks(nb: int, nc: int, device):
    """The lists of `cull=False`: every block visits every chunk. One
    shared row (1, nc), not nb copies."""
    return (torch.full((nb,), nc, dtype=torch.int32, device=device),
            torch.arange(nc, dtype=torch.int32, device=device)[None])


# ----------------------------------------------------------- the checks


def _check_rays(orig, d) -> int:
    f32 = torch.float32
    _check("orig", orig, f32, 3, orig.device)
    _check("d", d, f32, 3, orig.device)
    if d.shape != orig.shape:
        raise ValueError(f"rays must be (N,3); got {tuple(orig.shape)} and "
                         f"{tuple(d.shape)}")
    if orig.shape[0] >= 2 ** 31:
        raise ValueError("too many rays: ray ids must fit int32")
    return orig.shape[0]


def _check_block(block: int) -> None:
    if block < 32 or block % 32 or block > MAX_BLOCK:
        raise ValueError(f"block={block} must be a multiple of 32 in "
                         f"32..{MAX_BLOCK}")


def _check_boxes(chunk_lo, chunk_hi, device) -> int:
    f32 = torch.float32
    _check("chunk_lo", chunk_lo, f32, 3, device)
    _check("chunk_hi", chunk_hi, f32, 3, device)
    if chunk_lo.shape != chunk_hi.shape:
        raise ValueError(f"chunk_lo {tuple(chunk_lo.shape)} and chunk_hi "
                         f"{tuple(chunk_hi.shape)} differ")
    return chunk_lo.shape[0]


def _check_table(tri_table, chunk: int, nc: int, device,
                 max_chunk: int = MAX_CHUNK) -> None:
    _check("tri_table", tri_table, torch.float32, 12, device)
    if not 1 <= chunk <= max_chunk:
        raise ValueError(f"chunk={chunk} must be in 1..{max_chunk}")
    if nc != -(-tri_table.shape[0] // chunk):
        raise ValueError(f"{nc} chunk boxes for a table of "
                         f"{tri_table.shape[0]} rows at chunk={chunk}")


def _check_lists(counts, lists, nb: int, nc: int, device) -> None:
    for name, t in (("counts", counts), ("lists", lists)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if counts.shape != (nb,):
        raise ValueError(f"counts has shape {tuple(counts.shape)}, expected ({nb},)")
    if lists.dim() != 2 or lists.shape[0] not in (1, nb) or lists.shape[1] < nc:
        raise ValueError(f"lists has shape {tuple(lists.shape)}, expected "
                         f"({nb}, {nc}) or (1, {nc})")


# ---------------------------------------------------------------- CUDA


def _cuda_lib():
    from software_rasterizer_tpu_torch.utils.cuda_build import load_library

    lib = load_library("trace_culled", ["trace_culled.cu"])
    if lib.srt_cull_prepass.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.srt_cull_prepass.argtypes = [vp, vp, ci, vp, vp, ci, vp, vp, ci, ci, vp, vp,
                                         vp]
        lib.srt_trace_listed.argtypes = [vp, ci, ci, vp, vp, vp, vp, cl, vp, vp,
                                         ci, ci, ci, vp, vp, vp, vp, vp]
        lib.srt_trace_fused_cull.argtypes = [vp, ci, ci, vp, vp, ci, vp, vp, ci,
                                             vp, vp, ci, ci, vp, vp, vp, vp, vp]
        lib.srt_trace_unculled.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp, vp,
                                           vp, vp]
        lib.srt_trace_tally_entries.argtypes = []
        lib.srt_cull_tally_entries.argtypes = []
        for fn in (lib.srt_cull_prepass, lib.srt_trace_listed,
                   lib.srt_trace_fused_cull, lib.srt_trace_unculled,
                   lib.srt_trace_tally_entries, lib.srt_cull_tally_entries):
            fn.restype = ci
        for fn, want in ((lib.srt_trace_tally_entries, TALLY_ENTRIES),
                         (lib.srt_cull_tally_entries, CULL_TALLY_ENTRIES)):
            if fn() != want:
                raise RuntimeError(f"trace_culled.cu counts {fn()} entries of a tally that "
                                   f"trace_tiers.py counts {want} of")
    return lib


def build_kernel() -> None:
    """Compile (or reuse) and load the CUDA library."""
    _cuda_lib()


def _need_cuda(name: str, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")


def _outputs(n: int, device):
    return (torch.empty(n, dtype=torch.bool, device=device),
            torch.empty(n, dtype=torch.int64, device=device),
            torch.empty(n, dtype=torch.float32, device=device))


def _check_supers(lo2, hi2, nc: int, device) -> None:
    if _check_boxes(lo2, hi2, device) != -(-nc // MM2C_SUPER):
        raise ValueError(f"{lo2.shape[0]} super-chunk boxes for {nc} chunks")


def launch_cull_prepass(chunk_lo, chunk_hi, orig, d, block: int, supers=None,
                        tally=None) -> torch.Tensor:
    """Launch `cull_prepass_kernel` on the current stream: the (nb, nc)
    uint8 mask. `supers` (lo2, hi2) are the super-chunk boxes the warps
    vote on first, `super_bounds(chunk_lo, chunk_hi)` if None; the kernel
    skips a super's chunks only where conditions (a) and (b) hold
    (`ray_proven`, `super_proven`), so they change no bit. `tally`
    ((CULL_TALLY_ENTRIES,) int64) gets its work if given. Checks every
    operand and raises on a launch error."""
    global LAUNCHES_CULL
    device = orig.device
    _need_cuda("launch_cull_prepass", device)
    n = _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, device)
    lo2, hi2 = super_bounds(chunk_lo, chunk_hi) if supers is None else supers
    _check_supers(lo2, hi2, nc, device)
    check_tally(tally, device, CULL_TALLY_ENTRIES)
    mask = torch.empty((-(-n // block), nc), dtype=torch.uint8, device=device)
    if mask.numel() == 0:
        return mask
    lo, hi, lo2, hi2, orig, d = (x.contiguous() for x in (chunk_lo, chunk_hi, lo2, hi2,
                                                          orig, d))
    rc = _cuda_lib().srt_cull_prepass(
        lo.data_ptr(), hi.data_ptr(), nc, lo2.data_ptr(), hi2.data_ptr(), lo2.shape[0],
        orig.data_ptr(), d.data_ptr(), n, block, mask.data_ptr(),
        None if tally is None else tally.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cull_prepass kernel launch failed: cudaError {rc}")
    LAUNCHES_CULL += 1
    return mask


def launch_trace_listed(tri_table, counts, lists, orig, d, chunk: int,
                        block: int, stream: bool = False, chunk_lo=None,
                        chunk_hi=None, tally=None) -> Trace:
    """Launch `trace_listed_all_kernel` or, with `stream`,
    `trace_listed_stream_kernel` on the current stream. `lists` is (nb, nc)
    or one shared row (1, nc). The streamed kernel also takes the chunk
    boxes `chunk_lo/hi` (nc,3), on which each warp votes. Either adds its
    work to `tally` ((TALLY_ENTRIES,) int64) if given. Checks every operand
    and raises on a launch error."""
    global LAUNCHES_MM2, LAUNCHES_MM2S
    device = orig.device
    _need_cuda("launch_trace_listed", device)
    n = _check_rays(orig, d)
    _check_block(block)
    nc = -(-tri_table.shape[0] // chunk) if chunk >= 1 else 0
    _check_table(tri_table, chunk, nc, device)
    nb = -(-n // block)
    _check_lists(counts, lists, nb, nc, device)
    if stream:
        if chunk_lo is None or chunk_hi is None:
            raise ValueError("the streamed kernel needs the chunk boxes chunk_lo / chunk_hi")
        if _check_boxes(chunk_lo, chunk_hi, device) != nc:
            raise ValueError(f"{chunk_lo.shape[0]} chunk boxes for {nc} chunks")
    elif chunk_lo is not None or chunk_hi is not None:
        raise ValueError("chunk boxes are the streamed kernel's")
    check_tally(tally, device)
    hit, idx, t = _outputs(n, device)
    if n == 0:
        return hit, idx, t
    tri_table = _aligned(tri_table)
    counts, lists, orig, d = (x.contiguous() for x in (counts, lists, orig, d))
    lo = hi = None
    if stream:
        lo, hi = chunk_lo.contiguous(), chunk_hi.contiguous()
    stride = 0 if lists.shape[0] == 1 else lists.shape[1]
    rc = _cuda_lib().srt_trace_listed(
        tri_table.data_ptr(), tri_table.shape[0], chunk,
        None if lo is None else lo.data_ptr(), None if hi is None else hi.data_ptr(),
        counts.data_ptr(), lists.data_ptr(), stride, orig.data_ptr(), d.data_ptr(), n,
        block, int(stream), hit.data_ptr(), idx.data_ptr(), t.data_ptr(),
        None if tally is None else tally.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace_listed kernel launch failed: cudaError {rc}")
    if stream:
        LAUNCHES_MM2S += 1
    else:
        LAUNCHES_MM2 += 1
    return hit, idx, t


def launch_trace_fused_cull(tri_table, chunk_lo, chunk_hi, lo2, hi2, orig, d,
                            chunk: int, block: int, tally=None) -> Trace:
    """Launch `trace_fused_cull_kernel` on the current stream; its work
    goes into `tally` ((TALLY_ENTRIES,) int64) if given. Checks every
    operand and raises on a launch error."""
    global LAUNCHES_MM2C
    device = orig.device
    _need_cuda("launch_trace_fused_cull", device)
    n = _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, device)
    _check_table(tri_table, chunk, nc, device)
    _check_supers(lo2, hi2, nc, device)
    nsc = lo2.shape[0]
    check_tally(tally, device)
    hit, idx, t = _outputs(n, device)
    if n == 0:
        return hit, idx, t
    tri_table = _aligned(tri_table)
    lo, hi, lo2, hi2, orig, d = (
        x.contiguous() for x in (chunk_lo, chunk_hi, lo2, hi2, orig, d))
    rc = _cuda_lib().srt_trace_fused_cull(
        tri_table.data_ptr(), tri_table.shape[0], chunk, lo.data_ptr(),
        hi.data_ptr(), nc, lo2.data_ptr(), hi2.data_ptr(), nsc, orig.data_ptr(),
        d.data_ptr(), n, block, hit.data_ptr(), idx.data_ptr(), t.data_ptr(),
        None if tally is None else tally.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace_fused_cull kernel launch failed: cudaError {rc}")
    LAUNCHES_MM2C += 1
    return hit, idx, t


def launch_trace_unculled(tri_table, orig, d, block: int, tally=None) -> Trace:
    """Launch `trace_unculled_kernel` on the current stream: every ray
    block sweeps every row, staged in the kernel's own slices; its work
    goes into `tally` ((TALLY_ENTRIES,) int64) if given. Checks every
    operand and raises on a launch error."""
    global LAUNCHES_MM
    device = orig.device
    _need_cuda("launch_trace_unculled", device)
    n = _check_rays(orig, d)
    _check_block(block)
    _check("tri_table", tri_table, torch.float32, 12, device)
    check_tally(tally, device)
    hit, idx, t = _outputs(n, device)
    if n == 0:
        return hit, idx, t
    tri_table = _aligned(tri_table)
    orig, d = orig.contiguous(), d.contiguous()
    rc = _cuda_lib().srt_trace_unculled(
        tri_table.data_ptr(), tri_table.shape[0], orig.data_ptr(),
        d.data_ptr(), n, block, hit.data_ptr(), idx.data_ptr(), t.data_ptr(),
        None if tally is None else tally.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace_unculled kernel launch failed: cudaError {rc}")
    LAUNCHES_MM += 1
    return hit, idx, t


# -------------------------------------------------------- entry points


def _on_cpu(device) -> bool:
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return False


def cull_prepass(chunk_lo, chunk_hi, orig, d, block: int = DEFAULT_BLOCK):
    """(nb, nc) uint8 mask: 1 where any ray of ray block b passes the slab
    test of chunk c's box; nb = ceil(N / block), and the rays a short last
    block lacks do not vote. CUDA rays run the kernel (a two-level warp
    vote, `cull_prepass_warp_plain`, the same mask), CPU rays
    `cull_prepass_plain`."""
    if _on_cpu(orig.device):
        return cull_prepass_plain(chunk_lo, chunk_hi, orig, d, block)
    return launch_cull_prepass(chunk_lo, chunk_hi, orig, d, block)


def trace_nearest_mm2c(tri_table, chunk_lo, chunk_hi, orig, d, chunk: int = 128,
                       block: int = DEFAULT_BLOCK) -> Trace:
    """Nearest triangle with the two-level box cull fused into the sweep.
    `chunk_lo/hi` (nc,3) from `chunk_bounds` at the same `chunk`."""
    if _on_cpu(orig.device):
        return trace_nearest_mm2c_plain(tri_table, chunk_lo, chunk_hi, orig, d,
                                        chunk, block)
    lo2, hi2 = super_bounds(chunk_lo, chunk_hi)
    return launch_trace_fused_cull(tri_table, chunk_lo, chunk_hi, lo2, hi2,
                                   orig, d, chunk, block)


def _mm_chunk(tri_table, chunk: int) -> int:
    """The JAX wrapper's `min(chunk, F)`: no chunk is longer than the
    table (one row for an empty table)."""
    return min(chunk, max(tri_table.shape[0], 1))


def _check_mm_table(tri_table, chunk: int, device) -> None:
    """The checks of the JAX wrapper's chunk on the (F,12) table."""
    chunk = _mm_chunk(tri_table, chunk)
    _check_table(tri_table, chunk, -(-tri_table.shape[0] // chunk), device, MM_MAX_CHUNK)


def trace_nearest_mm(tri_table, orig, d, chunk: int = MM_MAX_CHUNK,
                     block: int = MM_BLOCK, tally=None) -> Trace:
    """Nearest triangle over every row of `tri_table` (F,12): no boxes,
    no lists; each ray block sweeps every row. `chunk` (the JAX kernel's,
    at most `MM_MAX_CHUNK`) is checked and changes no result: the kernel
    stages its own slices. Equal to `trace_nearest_vpu` over the table's
    rows bit for bit. CUDA rays run the kernel, CPU rays
    `trace_nearest_mm_plain`; `tally` ((TALLY_ENTRIES,) int64) gets the
    kernel's work, or on the CPU its model's (`unculled_tally_plain`)."""
    if _on_cpu(orig.device):
        out = trace_nearest_mm_plain(tri_table, orig, d, chunk, block)
        if tally is not None:
            check_tally(tally, orig.device)
            tally += torch.tensor(unculled_tally_plain(tri_table, orig, d, block),
                                  dtype=torch.int64)
        return out
    _check_mm_table(tri_table, chunk, orig.device)
    return launch_trace_unculled(tri_table, orig, d, block, tally=tally)


def _listed(tri_table, chunk_lo, chunk_hi, orig, d, chunk, block, cull, stream,
            tally=None):
    n = _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, orig.device)
    _check_table(tri_table, chunk, nc, orig.device)
    if cull:
        counts, lists = chunk_lists(cull_prepass(chunk_lo, chunk_hi, orig, d, block))
    else:
        counts, lists = _all_chunks(-(-n // block), nc, orig.device)
    if _on_cpu(orig.device):
        if tally is None:
            return trace_listed_plain(tri_table, counts, lists, orig, d, chunk, block)
        check_tally(tally, orig.device)
        out, work = listed_warp_plain(tri_table, chunk_lo, chunk_hi, counts, lists,
                                      orig, d, chunk, block, vote=stream)
        tally += torch.tensor(work, dtype=torch.int64)
        return out
    if stream:
        return launch_trace_listed(tri_table, counts, lists, orig, d, chunk, block,
                                   stream=True, chunk_lo=chunk_lo, chunk_hi=chunk_hi,
                                   tally=tally)
    return launch_trace_listed(tri_table, counts, lists, orig, d, chunk, block, tally=tally)


def trace_nearest_mm2(tri_table, chunk_lo, chunk_hi, orig, d, chunk: int = 128,
                      block: int = DEFAULT_BLOCK, cull: bool = True, tally=None) -> Trace:
    """Nearest triangle over each ray block's list of surviving chunks
    (`cull_prepass` + `chunk_lists`); `cull=False` visits every chunk.
    `tally` ((TALLY_ENTRIES,) int64) gets the kernel's work, or on the CPU
    its model's (`listed_warp_plain(vote=False)`)."""
    return _listed(tri_table, chunk_lo, chunk_hi, orig, d, chunk, block, cull,
                   stream=False, tally=tally)


def trace_nearest_mm2_stream(tri_table, chunk_lo, chunk_hi, orig, d,
                             chunk: int = 256, block: int = DEFAULT_BLOCK,
                             cull: bool = True, tally=None) -> Trace:
    """`trace_nearest_mm2`'s lists, each warp sweeping only the listed
    chunks some ray of it enters, the rows of the next slice fetched while
    the current one is swept. `tally` ((TALLY_ENTRIES,) int64) gets the
    kernel's work, or on the CPU its model's (`listed_warp_plain`)."""
    return _listed(tri_table, chunk_lo, chunk_hi, orig, d, chunk, block, cull,
                   stream=True, tally=tally)


# ------------------------------------------------------- plain versions


def _block_any(enter: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """(nb, B) bool: any over each block of `block` rows of the (N, B)
    bool `enter`; the rows a short last block lacks count as False."""
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        enter = torch.cat([enter, enter.new_zeros((pad, enter.shape[1]))])
    return enter.reshape(nb, block, -1).any(dim=1)


def _block_enters(lo, hi, orig, d, block: int) -> torch.Tensor:
    """(nb, B) bool: any ray of ray block b passes the slab test of box
    B. Steps over whole ray blocks to bound the (rays, boxes) planes."""
    n, nbox = orig.shape[0], lo.shape[0]
    step = max(1, _PLAIN_STEP // max(nbox * block, 1)) * block
    parts = [_block_any(slab_test(orig[s:s + step], d[s:s + step], lo, hi),
                        min(step, n - s), block) for s in range(0, n, step)]
    if not parts:
        return torch.zeros((0, nbox), dtype=torch.bool, device=orig.device)
    return torch.cat(parts)


def cull_prepass_plain(chunk_lo, chunk_hi, orig, d, block: int = DEFAULT_BLOCK):
    """Plain PyTorch version of `cull_prepass` (same signature and
    result), on the rays' device."""
    _check_rays(orig, d)
    _check_block(block)
    _check_boxes(chunk_lo, chunk_hi, orig.device)
    return _block_enters(chunk_lo, chunk_hi, orig, d, block).to(torch.uint8)


def _sweep_visited(tri_table, visit, orig, d, chunk: int, block: int) -> Trace:
    """The sweep every plain tier shares: ray block b tests the rows of
    chunk c iff visit[b, c]. Chunks in ascending order, rows in ascending
    order, a strict `<`: the lowest index wins a tie. Every (ray, row)
    test is `trace_nearest_vpu_plain`'s, on planes of rays x rows."""
    n, dev = orig.shape[0], orig.device
    n_rows = tri_table.shape[0]
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(block, device=dev)
    for c in torch.nonzero(visit.any(dim=0)).flatten().tolist():
        g = tri_table[c * chunk:min((c + 1) * chunk, n_rows)]
        if g.shape[0] == 0:
            continue
        blocks = torch.nonzero(visit[:, c]).flatten()
        rays = (blocks[:, None] * block + lane[None]).flatten()
        rays = rays[rays < n]
        step = max(1, _PLAIN_STEP // g.shape[0])
        for s in range(0, rays.shape[0], step):
            r = rays[s:s + step]
            ct, cf = plane_winner(mt_plane(orig[r], d[r], g))
            better = ct < best_t[r]
            best_t[r] = torch.where(better, ct, best_t[r])
            best_f[r] = torch.where(better, cf + c * chunk, best_f[r])
    hit = best_t < BIG
    return hit, torch.where(hit, best_f, -1), best_t


def trace_listed_plain(tri_table, counts, lists, orig, d, chunk: int,
                       block: int) -> Trace:
    """Plain PyTorch version of `launch_trace_listed` (both kernels): ray
    block b sweeps the chunks lists[b, :counts[b]], which must ascend."""
    n = _check_rays(orig, d)
    _check_block(block)
    nc = -(-tri_table.shape[0] // chunk) if chunk >= 1 else 0
    _check_table(tri_table, chunk, nc, orig.device)
    nb = -(-n // block)
    _check_lists(counts, lists, nb, nc, orig.device)
    listed = (torch.arange(lists.shape[1], device=orig.device)[None]
              < counts[:, None])
    visit = torch.zeros((nb, nc + 1), dtype=torch.bool, device=orig.device)
    visit.scatter_(1, torch.where(listed, lists.expand(nb, -1), nc).long(),
                   listed)
    return _sweep_visited(tri_table, visit[:, :nc], orig, d, chunk, block)


def trace_nearest_mm2c_plain(tri_table, chunk_lo, chunk_hi, orig, d,
                             chunk: int = 128,
                             block: int = DEFAULT_BLOCK) -> Trace:
    """Plain PyTorch version of `trace_nearest_mm2c`: a chunk is swept iff
    the block's vote passes on its super-chunk's box and on its own."""
    _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, orig.device)
    _check_table(tri_table, chunk, nc, orig.device)
    lo2, hi2 = super_bounds(chunk_lo, chunk_hi)
    enter2 = _block_enters(lo2, hi2, orig, d, block)
    visit = (_block_enters(chunk_lo, chunk_hi, orig, d, block)
             & enter2.repeat_interleave(MM2C_SUPER, dim=1)[:, :nc])
    return _sweep_visited(tri_table, visit, orig, d, chunk, block)


def trace_nearest_mm_plain(tri_table, orig, d, chunk: int = MM_MAX_CHUNK,
                           block: int = MM_BLOCK) -> Trace:
    """Plain PyTorch version of `trace_nearest_mm`: every ray against
    every row (`chunk` and `block` change no result)."""
    _check_rays(orig, d)
    _check_block(block)
    _check_mm_table(tri_table, chunk, orig.device)
    t, idx, _, _ = walk_nearest_plain(tri_table, tri_table.shape[0], orig, d)
    return idx >= 0, idx, t


# ------------------------------- the two-stage kernels' warps and tallies


def launch_shape(block: int) -> Tuple[int, int]:
    """(threads, rays a thread) of a CUDA block of the tier kernels for a
    ray block of `block` rays (csrc/trace_culled.cu launch_shape): thread
    k of the block holds rays k + j * threads of it, j < rays."""
    _check_block(block)
    threads = min(block, MAX_THREADS)
    r = -(-block // threads)
    return threads, 1 if r <= 1 else 2 if r <= 2 else 4 if r <= 4 else 8


def _block_lanes(n: int, block: int, threads: int, rays: int, device) -> torch.Tensor:
    """(nb, warps, rays, WARP) int64: the ray each lane of each warp holds
    in slot j when thread k of a CUDA block holds rays k + j * threads of
    its `block` rays (block b's warp w, lane l: ray b * block + w * WARP +
    l + j * threads), -1 where the lane holds no ray (past the block or
    N)."""
    nb = -(-n // block)
    local = (torch.arange(threads // WARP, device=device)[:, None, None] * WARP
             + torch.arange(rays, device=device)[None, :, None] * threads
             + torch.arange(WARP, device=device)[None, None, :])
    ids = torch.arange(nb, device=device)[:, None, None, None] * block + local[None]
    return torch.where((local[None] < block) & (ids < n), ids, -1)


def warp_rays(n: int, block: int, device) -> torch.Tensor:
    """`_block_lanes` of the tier kernels' ray blocks of `block` rays
    (`launch_shape`)."""
    return _block_lanes(n, block, *launch_shape(block), device)


def _lane_rays(orig, d, ids):
    """The rays of the lanes `ids` (any shape, -1: none) flattened, a lane
    without a ray holding the zero ray the kernels load for it."""
    flat = ids.reshape(-1)
    valid = flat >= 0
    safe = flat.clamp(min=0)
    zero = torch.zeros((), dtype=orig.dtype, device=orig.device)
    return (torch.where(valid[:, None], orig[safe], zero),
            torch.where(valid[:, None], d[safe], zero), valid)


def _vote_counts(o_, d_, valid, rows) -> Tuple[int, int, int, int, int]:
    """(steps, voted steps, tests, full tests, stage-1 passes) of warps
    sweeping `rows`: the lanes' rays `o_`, `d_` in (warp, slot j, lane)
    order, `valid` the lanes that hold a ray. Steps over lanes to bound
    the planes."""
    n_rows = rows.shape[0]
    n_slots = o_.shape[0] // WARP
    active = valid.reshape(n_slots, WARP).sum(dim=1)
    voted = full = passes = 0
    step = max(1, _PLAIN_STEP // max(n_rows * WARP, 1)) * WARP
    for s0 in range(0, o_.shape[0], step):
        ok1 = mt_stage1_plane(o_[s0:s0 + step], d_[s0:s0 + step], rows)
        anyp = ok1.reshape(-1, WARP, n_rows).any(dim=1)       # (slots, rows)
        voted += int(anyp.sum())
        full += int((anyp.sum(dim=1) * active[s0 // WARP:(s0 + step) // WARP]).sum())
        passes += int((ok1 & valid[s0:s0 + step, None]).sum())
    return n_slots * n_rows, voted, int(active.sum()) * n_rows, full, passes


def _rows_tally(orig, d, ids, rows) -> Tuple[int, ...]:
    """The tally (`TALLY_NAMES` order) of the warps of the lanes `ids`
    each sweeping every row of `rows` with every slot: each (row, slot) a
    warp-step, voted when some lane's ray passes stage 1
    (`mt_stage1_plane`); a lane without a ray holds the zero ray and never
    passes. No slab tests, no chunk votes. Steps over rows to bound the
    planes."""
    o_, d_, valid = _lane_rays(orig, d, ids)
    work = [0] * TALLY_ENTRIES
    span = max(1, _PLAIN_STEP // max(o_.shape[0], 1))
    for r0 in range(0, rows.shape[0], span):
        steps, voted, tests, full, passes = _vote_counts(o_, d_, valid, rows[r0:r0 + span])
        for k, x in ((0, steps), (1, voted), (2, tests), (3, full), (7, passes)):
            work[k] += x
    return tuple(work)


def unculled_tally_plain(tri_table, orig, d, block: int = MM_BLOCK) -> Tuple[int, ...]:
    """The work kernel #8 adds to its tally on these rays: every warp of
    every ray block sweeps every row of the table (`_rows_tally`)."""
    n = _check_rays(orig, d)
    return _rows_tally(orig, d, warp_rays(n, block, orig.device), tri_table)


def nearest_warp_rays(n: int, rays: int, device) -> torch.Tensor:
    """(warps, rays, WARP) int64: the ray each lane of each warp of kernel
    #2 holds in slot j when a thread holds `rays` slots (`_block_lanes` of
    blocks of NEAREST_THREADS threads and NEAREST_THREADS * rays rays), -1
    at or past N: an absent ray, which the warp sweeps with all the same."""
    return _block_lanes(n, NEAREST_THREADS * rays, NEAREST_THREADS, rays,
                        device).reshape(-1, rays, WARP)


def nearest_tally_plain(tri_table, n_tri: int, orig, d,
                        rays: int = NEAREST_RAYS) -> Tuple[int, ...]:
    """The work kernel #2 adds to its tally on these rays when a thread
    holds `rays` ray slots: every warp of the grid (`nearest_warp_rays`)
    sweeps the first `n_tri` rows (`_rows_tally`)."""
    n = _check_operands(tri_table, n_tri, orig, d)
    return _rows_tally(orig, d, nearest_warp_rays(n, rays, orig.device), tri_table[:n_tri])


def listed_warp_plain(tri_table, chunk_lo, chunk_hi, counts, lists, orig, d,
                      chunk: int, block: int, vote: bool = True):
    """A plain model of kernel #6 (trace_listed_stream_kernel): ray block b's
    listed chunks lists[b, :counts[b]] (ascending), each warp of the block
    voting on each one's box (`slab_test` of each of its rays) and sweeping
    its rows only if some ray of the warp enters it. Returns (hit, idx, t),
    equal to `trace_listed_plain` bit for bit (a warp skips only chunks
    none of its rays can hit), and the work the kernel adds to its tally,
    in `TALLY_NAMES` order. Without `vote`, kernel #7
    (trace_listed_all_kernel): every warp sweeps every listed chunk, no
    slab test and no chunk vote is made, and the boxes are only checked."""
    n = _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, orig.device)
    _check_table(tri_table, chunk, nc, orig.device)
    nb = -(-n // block)
    _check_lists(counts, lists, nb, nc, orig.device)
    dev, n_rows = orig.device, tri_table.shape[0]
    _, rays = launch_shape(block)
    listed = torch.arange(lists.shape[1], device=dev)[None] < counts[:, None]
    visit = torch.zeros((nb, nc + 1), dtype=torch.bool, device=dev)
    visit.scatter_(1, torch.where(listed, lists.expand(nb, -1), nc).long(), listed)
    visit = visit[:, :nc]
    lanes = warp_rays(n, block, dev)                          # (nb, W, R, 32)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=dev)
    work = [0] * TALLY_ENTRIES
    for c in torch.nonzero(visit.any(dim=0)).flatten().tolist():
        ids = lanes[torch.nonzero(visit[:, c]).flatten()].reshape(-1, rays, WARP)
        if vote:
            o_, d_, valid = _lane_rays(orig, d, ids)
            enter = torch.zeros_like(valid)
            enter[valid] = slab_test(o_[valid], d_[valid], chunk_lo[c:c + 1],
                                     chunk_hi[c:c + 1])[:, 0]
            warp_in = enter.reshape(-1, rays * WARP).any(dim=1)
            work[4] += int(valid.sum())
            work[5] += ids.shape[0]
            work[6] += int((~warp_in).sum())
        else:
            warp_in = torch.ones(ids.shape[0], dtype=torch.bool, device=dev)
        g = tri_table[c * chunk:min((c + 1) * chunk, n_rows)]
        if g.shape[0] == 0 or not bool(warp_in.any()):
            continue
        ids = ids[warp_in]
        o_, d_, valid = _lane_rays(orig, d, ids)
        steps, voted, tests, full, passes = _vote_counts(o_, d_, valid, g)
        for k, x in ((0, steps), (1, voted), (2, tests), (3, full), (7, passes)):
            work[k] += x
        r = ids.reshape(-1)[valid]
        step = max(1, _PLAIN_STEP // g.shape[0])
        for s0 in range(0, r.shape[0], step):
            rr = r[s0:s0 + step]
            ct, cf = plane_winner(mt_plane(orig[rr], d[rr], g))
            better = ct < best_t[rr]
            best_t[rr] = torch.where(better, ct, best_t[rr])
            best_f[rr] = torch.where(better, cf + c * chunk, best_f[rr])
    hit = best_t < BIG
    return (hit, torch.where(hit, best_f, -1), best_t), tuple(work)


def _warp_boxes(orig, d, ids, lo, hi):
    """(warps, B) bool: any active ray of each warp of the lanes `ids`
    ((warps, lanes) ray ids, -1: none) passes the slab test of box B."""
    o_, d_, valid = _lane_rays(orig, d, ids)
    return (slab_test(o_, d_, lo, hi) & valid[:, None]).reshape(ids.shape[0], -1,
                                                                lo.shape[0]).any(dim=1)


def _per_super(nc: int, device) -> torch.Tensor:
    """(nsc,) int64: the chunks of each super-chunk (the tail one short)."""
    nsc = -(-nc // MM2C_SUPER)
    return torch.clamp(nc - MM2C_SUPER * torch.arange(nsc, device=device), max=MM2C_SUPER)


def ray_proven(orig, d) -> torch.Tensor:
    """(N,) bool: condition (a) of the prepass's super-chunk skip
    (csrc/trace_culled.cu, where the proof is written): |o| <= 1e30 on
    every axis (so not NaN) and a finite 1 / d on every axis (a zero
    component counted as 1e-30, as the slab test does). A denormal or NaN
    direction component breaks it; an infinite one gives 1 / d = 0, which
    keeps it."""
    return (orig.abs() <= BIG).all(dim=1) & torch.isfinite(_inv_dir(d)).all(dim=1)


def super_proven(chunk_lo, chunk_hi, lo2, hi2) -> torch.Tensor:
    """(nsc,) bool: condition (b) of the prepass's super-chunk skip for
    each super box (lo2, hi2 (nsc,3)) and its chunk boxes: every child box
    well formed and inside it, the super box finite (lo <= hi, |lo|, |hi|,
    |lo2|, |hi2| <= 1e30, lo2 <= lo and hi <= hi2 on every axis). An empty
    chunk's inverted box (1e30, -1e30) breaks it."""
    nc, nsc = chunk_lo.shape[0], lo2.shape[0]
    sup = torch.arange(nc, device=chunk_lo.device) // MM2C_SUPER
    p_lo, p_hi = lo2[sup], hi2[sup]
    ok = ((chunk_lo <= chunk_hi) & (chunk_lo.abs() <= BIG) & (chunk_hi.abs() <= BIG)
          & (p_lo.abs() <= BIG) & (p_hi.abs() <= BIG) & (p_lo <= chunk_lo)
          & (chunk_hi <= p_hi)).all(dim=1)
    ok = torch.cat([ok, ok.new_ones(nsc * MM2C_SUPER - nc)])
    return ok.reshape(nsc, MM2C_SUPER).all(dim=1)


def cull_prepass_warp_plain(chunk_lo, chunk_hi, orig, d, block: int = DEFAULT_BLOCK,
                            supers=None):
    """A plain model of kernel #5 (cull_prepass_kernel): each warp of a
    ray block (`warp_rays`) votes on each super box (`supers` (lo2, hi2),
    `super_bounds` if None) where the skip is proven, i.e. every active ray
    of the warp meets condition (a) (`ray_proven`) and the super (b)
    (`super_proven`); a warp that enters no proven super box skips its
    chunks, otherwise (or where unproven) it votes on each chunk box, and a
    ray block's bit is the OR of its warps' chunk votes. Returns (the (nb,
    nc) uint8 mask, equal to `cull_prepass_plain` bit for bit, and the work
    the kernel adds to its tally, in `CULL_TALLY_NAMES` order)."""
    n = _check_rays(orig, d)
    _check_block(block)
    dev = orig.device
    nc = _check_boxes(chunk_lo, chunk_hi, dev)
    lo2, hi2 = super_bounds(chunk_lo, chunk_hi) if supers is None else supers
    _check_supers(lo2, hi2, nc, dev)
    nsc = lo2.shape[0]
    per_super = _per_super(nc, dev)
    sup_ok = super_proven(chunk_lo, chunk_hi, lo2, hi2)
    lanes = warp_rays(n, block, dev)                          # (nb, W, R, 32)
    nb, n_w = lanes.shape[:2]
    mask = torch.zeros((nb, nc), dtype=torch.uint8, device=dev)
    work = [0] * CULL_TALLY_ENTRIES
    step = max(1, _PLAIN_STEP // max((nc + nsc) * lanes[0].numel(), 1))
    for b0 in range(0, nb, step):
        ids = lanes[b0:b0 + step]
        k = ids.shape[0]
        ids = ids.reshape(k * n_w, -1)
        o_, d_, valid = _lane_rays(orig, d, ids)
        act = valid.reshape(k * n_w, -1).sum(dim=1)
        warp_ok = (ray_proven(o_, d_) | ~valid).reshape(k * n_w, -1).all(dim=1)
        enter2 = _warp_boxes(orig, d, ids, lo2, hi2)            # (warps, nsc)
        enter = _warp_boxes(orig, d, ids, chunk_lo, chunk_hi)   # (warps, nc)
        proven = warp_ok[:, None] & sup_ok[None]
        go = ~proven | enter2
        votes = enter & go.repeat_interleave(MM2C_SUPER, dim=1)[:, :nc]
        mask[b0:b0 + k] = votes.reshape(k, n_w, nc).any(dim=1).to(torch.uint8)
        chunk_votes = (go.long() * per_super[None]).sum(dim=1)
        work[0] += int((act * proven.sum(dim=1)).sum())
        work[1] += int((act * chunk_votes).sum())
        work[2] += k * n_w * nsc
        work[3] += int((proven & ~enter2).sum())
        work[4] += int((~proven).sum())
        work[5] += int(chunk_votes.sum())
    return mask, tuple(work)


def fused_warp_plain(tri_table, chunk_lo, chunk_hi, orig, d, chunk: int = 128,
                     block: int = DEFAULT_BLOCK):
    """A plain model of kernel #4 (trace_fused_cull_kernel): each warp of a
    ray block (`warp_rays`) votes on each super box (`super_bounds`; a
    `slab_test` of each of its active rays), in each super it enters on each
    chunk box, and sweeps the rows of the chunks it enters with the
    two-stage test, chunks and rows ascending. Returns (hit, idx, t), equal
    to `trace_nearest_mm2c_plain` (the block vote) bit for bit but where a
    ray's own slab test of its winner's chunk fails on a knife edge, and
    the work the kernel adds to its tally, in `TALLY_NAMES` order
    (slab_tests counts the super and the chunk tests, warp_chunks the chunk
    votes)."""
    n = _check_rays(orig, d)
    _check_block(block)
    dev = orig.device
    nc = _check_boxes(chunk_lo, chunk_hi, dev)
    _check_table(tri_table, chunk, nc, dev)
    n_rows = tri_table.shape[0]
    _, rays = launch_shape(block)
    lo2, hi2 = super_bounds(chunk_lo, chunk_hi)
    nsc = lo2.shape[0]
    per_super = _per_super(nc, dev)
    lanes = warp_rays(n, block, dev).reshape(-1, rays * WARP)  # (warps, lanes)
    n_w = lanes.shape[0]
    act = (lanes >= 0).sum(dim=1)
    step = max(1, _PLAIN_STEP // max((nc + nsc) * rays * WARP, 1))
    enter2 = torch.cat([_warp_boxes(orig, d, lanes[w:w + step], lo2, hi2)
                        for w in range(0, n_w, step)]) if n_w else \
        torch.zeros((0, nsc), dtype=torch.bool, device=dev)
    enter = torch.cat([_warp_boxes(orig, d, lanes[w:w + step], chunk_lo, chunk_hi)
                       for w in range(0, n_w, step)]) if n_w else \
        torch.zeros((0, nc), dtype=torch.bool, device=dev)
    visit = enter & enter2.repeat_interleave(MM2C_SUPER, dim=1)[:, :nc]
    chunk_votes = (enter2.long() * per_super[None]).sum(dim=1)
    work = [0] * TALLY_ENTRIES
    work[4] = int((act * (nsc + chunk_votes)).sum())
    work[5] = int(chunk_votes.sum())
    work[6] = work[5] - int(visit.sum())
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for c in torch.nonzero(visit.any(dim=0)).flatten().tolist():
        ids = lanes[visit[:, c]]
        o_, d_, valid = _lane_rays(orig, d, ids)
        g = tri_table[c * chunk:min((c + 1) * chunk, n_rows)]
        steps, voted, tests, full, passes = _vote_counts(o_, d_, valid, g)
        for k, x in ((0, steps), (1, voted), (2, tests), (3, full), (7, passes)):
            work[k] += x
        r = ids.reshape(-1)[valid]
        span = max(1, _PLAIN_STEP // g.shape[0])
        for s0 in range(0, r.shape[0], span):
            rr = r[s0:s0 + span]
            ct, cf = plane_winner(mt_plane(orig[rr], d[rr], g))
            better = ct < best_t[rr]
            best_t[rr] = torch.where(better, ct, best_t[rr])
            best_f[rr] = torch.where(better, cf + c * chunk, best_f[rr])
    hit = best_t < BIG
    return (hit, torch.where(hit, best_f, -1), best_t), tuple(work)


# ---------------------------------------------------- the per-ray leaf walk


def box_steps(k: torch.Tensor, n: int, per: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """Slab-test steps each warp issues on the `n` child boxes (of at most
    `per`) of a box that `k` ((W,) int64, one a warp; 0: the warp skips
    the box) of its rays enter (csrc/trace_common.cuh child_boxes): (the
    steps under the kernels' choice, the steps of the own-thread loop,
    whether the warp tests the pairs cooperatively). The own-thread loop
    takes `n` steps; the cooperative form, where `per` divides `WARP`,
    k <= `COOP_RAYS` and it takes fewer, one step a pass of `WARP // per`
    rays."""
    own = torch.where(k > 0, n, 0)
    if per & (per - 1) or not 0 < per <= WARP:
        return own, own, torch.zeros_like(k, dtype=torch.bool)
    passes = -(-k // (WARP // per))
    coop = (k > 0) & (k <= COOP_RAYS) & (passes < n)
    return torch.where(coop, passes, own), own, coop


def coop_children(orig, inv, enter_parent, lo, hi, per: int, ok=None):
    """The child boxes `lo` / `hi` ((n, 3), n <= `per`, `per` dividing
    `WARP`) that each ray enters, found as the kernels' cooperative form
    finds them (csrc/trace_common.cuh child_boxes): ((N, n) bool, the slab
    tests made). The rays of `enter_parent` ((N,) bool) are ranked in lane
    order within their warp (`WARP` lanes in launch order); pass p of a
    warp gives thread i the ray of rank p * (WARP // per) + i // per, by
    its lane, and child i % per; each thread's test goes into the pass's
    ballot, and a ray's thread takes its `per` bits of it. `inv` is each
    ray's `_inv_dir`; `ok` ((n,) bool) marks the children that may be
    entered (a chunk past the table's rows may not). A lane outside
    `enter_parent` enters nothing."""
    n_rays, n, dev = enter_parent.shape[0], lo.shape[0], enter_parent.device
    n_warps = -(-n_rays // WARP)
    ballot = torch.zeros(n_warps * WARP, dtype=torch.bool, device=dev)
    ballot[:n_rays] = enter_parent
    ballot = ballot.view(n_warps, WARP)
    k = ballot.sum(dim=1)
    # lane of each rank: the entering lanes first, in lane order
    lane_of = torch.argsort((~ballot).to(torch.uint8), dim=1, stable=True)
    rays = WARP // per
    thread = torch.arange(WARP, device=dev)
    child = thread % per
    base = WARP * torch.arange(n_warps, device=dev)[:, None]
    bits = torch.zeros((n_warps, WARP, n), dtype=torch.bool, device=dev)
    tests = 0
    for p in range(-(-int(k.max()) // rays) if n_rays else 0):
        rank = p * rays + thread // per                                   # (WARP,)
        use = (rank[None] < k[:, None]) & (child[None] < n)              # (W, WARP)
        src = lane_of.gather(1, rank.clamp(max=WARP - 1).expand(n_warps, -1))
        ray = (base + src).clamp(max=n_rays - 1)
        box = child.clamp(max=n - 1)
        tmin, tmax = _slab(orig[ray], inv[ray], lo[box], hi[box])
        hit = use & (tmax >= torch.clamp(tmin, min=0.0))
        if ok is not None:
            hit &= ok[box]
        tests += int(use.sum())
        for q in range(rays):
            has = (p * rays + q < k)[:, None]                             # (W, 1)
            lane = lane_of[:, min(p * rays + q, WARP - 1)]
            mine = hit[:, q * per:q * per + n]
            cur = bits[torch.arange(n_warps, device=dev), lane]
            bits[torch.arange(n_warps, device=dev), lane] = torch.where(has, mine, cur)
    return bits.view(n_warps * WARP, n)[:n_rays] & enter_parent[:, None], tests


def _walk_spans(cull: Optional[CullTables], n_rows: int, orig, d, active,
                tally: Optional[dict], coop: bool = False):
    """(lanes, r0, r1) spans of a nearest-row search in ascending row
    order: with `cull`, the rows [r0, r1) of each leaf and the lanes (a
    (k,) index) whose rays pass the slab test of its super-chunk's box, of
    its chunk's box and of its own box; without, every row for every lane,
    in spans that keep a (lanes, rows) plane near `_PLAIN_STEP`. Only the
    `active` lanes ((N,) bool; None: all, and lanes None) are walked;
    `tally` gets their (ray, row) and slab tests, as the kernels count
    them, and with `cull` the row-test slots of both warp schedules
    (`warp_slots`), the slab tests of the chunk and leaf levels
    ("box_tests", a part of "slab_tests") and their slots under the
    kernels' choice ("box_slots") and under the own-thread loop alone
    ("box_slots_thread", `box_steps`; lanes form warps of `WARP` in
    launch order), and the rows of the chunks they enter ("chunk_rows",
    what a walk without leaf boxes would test). With `coop`, the warps
    that the kernels' choice sends to the cooperative form find their
    chunks and leaves, and count their slab tests, through
    `coop_children`: the same spans and counts."""
    n = orig.shape[0]
    n_act = n if active is None else int(active.sum())
    if cull is None:
        if tally is not None:
            tally["row_tests"] = tally.get("row_tests", 0) + n_act * n_rows
        lanes = None if active is None else torch.nonzero(active).flatten()
        step = max(1, _PLAIN_STEP // max(n_act, 1))
        for r0 in range(0, n_rows if n_act else 0, step):
            yield lanes, r0, min(r0 + step, n_rows)
        return
    nc, nsc = cull.lo.shape[0], cull.lo2.shape[0]
    per_chunk, n_leaves = cull.chunk // LEAF, -(-n_rows // LEAF)
    warp = torch.div(torch.arange(n, device=orig.device), WARP, rounding_mode="floor")
    n_warps = -(-n // WARP)
    inv = _inv_dir(d)
    enter2 = slab_test(orig, d, cull.lo2, cull.hi2)            # (N, nsc)
    if active is not None:
        enter2 &= active[:, None]
    if tally is not None:
        for k in ("slab_tests", "box_tests", "box_slots", "box_slots_thread"):
            tally.setdefault(k, 0)
        tally["slab_tests"] += n_act * nsc

    def children(enter_parent, lo, hi, per, ok=None):
        """(N, n) bool: the children each ray enters, and the tally of the
        box tests of one level under one entered box."""
        k = torch.bincount(warp[enter_parent], minlength=n_warps)
        steps, own, use_coop = box_steps(k, lo.shape[0], per)
        enter = slab_test(orig, d, lo, hi) & enter_parent[:, None]
        if ok is not None:
            enter &= ok[None]
        tests = int(k.sum()) * lo.shape[0]
        if coop and bool(use_coop.any()):
            by_coop = use_coop[warp]
            together, t_coop = coop_children(orig, inv, enter_parent & by_coop, lo, hi, per, ok)
            enter = torch.where(by_coop[:, None], together, enter)
            tests = int(k[~use_coop].sum()) * lo.shape[0] + t_coop
        if tally is not None:
            tally["slab_tests"] += tests
            tally["box_tests"] += tests
            tally["box_slots"] += WARP * int(steps.sum())
            tally["box_slots_thread"] += WARP * int(own.sum())
        return enter

    for sc in torch.nonzero(enter2.any(dim=0)).flatten().tolist():
        c0, c1 = sc * MM2C_SUPER, min((sc + 1) * MM2C_SUPER, nc)
        # a chunk past the table's rows is not entered
        enter = children(enter2[:, sc], cull.lo[c0:c1], cull.hi[c0:c1], MM2C_SUPER,
                         torch.arange(c0, c1, device=orig.device) * cull.chunk < n_rows)
        for j in torch.nonzero(enter.any(dim=0)).flatten().tolist():
            l0, l1 = (c0 + j) * per_chunk, min((c0 + j + 1) * per_chunk, n_leaves)
            in_chunk = torch.nonzero(enter[:, j]).flatten()
            enter3 = children(enter[:, j], cull.lo3[l0:l1], cull.hi3[l0:l1],
                              per_chunk)[in_chunk]
            if tally is not None:
                tally["chunk_rows"] = (tally.get("chunk_rows", 0) + in_chunk.numel()
                                       * (min(l1 * LEAF, n_rows) - l0 * LEAF))
            for i in torch.nonzero(enter3.any(dim=0)).flatten().tolist():
                r0, r1 = (l0 + i) * LEAF, min((l0 + i + 1) * LEAF, n_rows)
                lanes = in_chunk[enter3[:, i]]
                if tally is not None:
                    tally["row_tests"] = (tally.get("row_tests", 0)
                                          + lanes.numel() * (r1 - r0))
                    warp_, thread = warp_slots(lanes, r0, r1)
                    tally["slots"] = tally.get("slots", 0) + warp_
                    tally["slots_thread"] = tally.get("slots_thread", 0) + thread
                yield lanes, r0, r1


def walk_nearest_plain(tri_table, n_rows: int, orig, d,
                       cull: Optional[CullTables] = None, active=None,
                       tally: Optional[dict] = None):
    """Each ray's nearest row among the first `n_rows` rows of
    `tri_table`: (t (N,) float32 with BIG on a miss, row (N,) int64 with
    -1 on a miss, u (N,), v (N,) of the winner, 0 on a miss). With `cull`
    a ray tests only the rows of the leaves whose boxes it enters (the
    path and Whitted kernels' culled walk); without, every row. Rows in
    ascending order under a strict `<`, every test `mt_plane`'s: the two
    give the same four tensors lane for lane. With `active` ((N,) bool),
    the lanes outside it are not walked (their result is a miss) in either
    form; `tally` counts the tests as in `_walk_spans`."""
    n, dev = orig.shape[0], orig.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    for lanes, r0, r1 in _walk_spans(cull, n_rows, orig, d, active, tally):
        o_, d_ = (orig, d) if lanes is None else (orig[lanes], d[lanes])
        tm, u, v = mt_plane(o_, d_, tri_table[r0:r1], uv=True)
        ct, cf = plane_winner(tm)
        sel = (slice(None),) if lanes is None else (lanes,)
        better = ct < best_t[sel]
        best_t[sel] = torch.where(better, ct, best_t[sel])
        best_f[sel] = torch.where(better, cf + r0, best_f[sel])
        best_u[sel] = torch.where(better, u.gather(1, cf[:, None])[:, 0], best_u[sel])
        best_v[sel] = torch.where(better, v.gather(1, cf[:, None])[:, 0], best_v[sel])
    return best_t, best_f, best_u, best_v


# ------------------------------------------- the warp walk's schedule


def warp_slots(lanes: torch.Tensor, r0: int, r1: int) -> Tuple[int, int]:
    """Row-test slots a leaf's rows [r0, r1) (within one run of `LEAF`
    rows) cost the warps of the lanes `lanes` ((k,) lane ids; a warp is
    `WARP` lanes in launch order) that enter it, under two schedules,
    `WARP` slots a row-step of a warp: the warp walk's (`warp_walk_plain`:
    one row-step for each (lane, leaf) pair, a row a thread) and the
    per-thread walk's (every thread walks its own leaves, so a warp in
    which any lane enters the leaf steps through all its rows, one row a
    step)."""
    if not 0 <= r0 < r1 <= (r0 // LEAF + 1) * LEAF:
        raise ValueError(f"rows [{r0}, {r1}) are not within one leaf of {LEAF} rows")
    n_warps = torch.unique(torch.div(lanes, WARP, rounding_mode="floor")).numel()
    return WARP * lanes.numel(), WARP * (r1 - r0) * n_warps


def warp_walk_plain(tri_table, n_rows: int, orig, d, cull: CullTables,
                    active=None, tally: Optional[dict] = None):
    """A CPU model of the culled path kernels' warp walk
    (csrc/trace_common.cuh warp_walk_chunks): what `walk_nearest_plain`
    returns with `cull`, (t, row, u, v), found in the order the kernels'
    warps find it. Lanes form warps of `WARP` in launch order; a leaf's
    ballot in a warp is the set of its lanes that enter the leaf's box
    (and its chunk's and super-chunk's); a warp's slices are the leaves
    some lane of it enters, in row order, `SLICE_LEAVES` a slice. For each
    lane and slice, row r of each of the lane's leaves goes to slot r %
    WARP, which keeps its least t under a strict `<` over the ascending
    leaves; the warp takes the lexicographic minimum of (t, row) over its
    slots, and the lane merges it with a strict `<`, slices ascending.
    (u, v) are the winning slot's. A warp finds the chunks and leaves its
    rays enter as the kernels do: own-thread, or one (ray, child box) pair
    a thread where the kernels' choice (`box_steps`) takes that form
    (`coop_children`). `tally` gets what `walk_nearest_plain`'s gets, the
    slots of both schedules included (`warp_slots`, `box_steps`). A model
    that shows the ordering and the tie rule of the schedule, not a second
    reference."""
    n, dev = orig.shape[0], orig.device
    no_row = torch.iinfo(torch.int64).max
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    spans = list(_walk_spans(cull, n_rows, orig, d, active, tally, coop=True))
    # the slice of each (warp, leaf) pair: the rank of the leaf among the
    # leaves some lane of the warp enters, over SLICE_LEAVES
    warp = torch.div(torch.arange(n, device=dev), WARP, rounding_mode="floor")
    seen = torch.zeros((-(-n // WARP), len(spans)), dtype=torch.bool, device=dev)
    for j, (lanes, _, _) in enumerate(spans):
        seen[warp[lanes], j] = True
    slice_of = torch.div(torch.cumsum(seen.long(), dim=1) - 1, SLICE_LEAVES,
                         rounding_mode="floor")
    # each lane's slots over its leaves of its current slice
    cur = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot_t = torch.full((n, WARP), BIG, dtype=torch.float32, device=dev)
    slot_row = torch.full((n, WARP), no_row, dtype=torch.int64, device=dev)
    slot_u, slot_v = torch.zeros_like(slot_t), torch.zeros_like(slot_t)

    def merge(ls):
        """The warp's reductions over the slots of lanes `ls` and each
        lane's strict `<`; the slots start afresh."""
        st, sr = slot_t[ls], slot_row[ls]
        wt = st.amin(dim=1)
        wrow = torch.where(st == wt[:, None], sr, no_row).amin(dim=1)
        better = wt < best_t[ls]
        col = torch.where(better, wrow % WARP, 0)[:, None]
        best_t[ls] = torch.where(better, wt, best_t[ls])
        best_f[ls] = torch.where(better, wrow, best_f[ls])
        best_u[ls] = torch.where(better, slot_u[ls].gather(1, col)[:, 0], best_u[ls])
        best_v[ls] = torch.where(better, slot_v[ls].gather(1, col)[:, 0], best_v[ls])
        slot_t[ls], slot_row[ls] = BIG, no_row

    for j, (lanes, r0, r1) in enumerate(spans):
        s = slice_of[warp[lanes], j]
        moved = s != cur[lanes]
        merge(lanes[moved])
        cur[lanes] = s
        cnt = r1 - r0
        tm, u, v = mt_plane(orig[lanes], d[lanes], tri_table[r0:r1], uv=True)
        st = slot_t[lanes, :cnt]
        better = tm < st
        slot_t[lanes, :cnt] = torch.where(better, tm, st)
        rows = torch.arange(r0, r1, device=dev).expand(lanes.numel(), cnt)
        slot_row[lanes, :cnt] = torch.where(better, rows, slot_row[lanes, :cnt])
        slot_u[lanes, :cnt] = torch.where(better, u, slot_u[lanes, :cnt])
        slot_v[lanes, :cnt] = torch.where(better, v, slot_v[lanes, :cnt])
    merge(torch.nonzero(cur >= 0).flatten())
    return best_t, best_f, best_u, best_v
