"""Chunk-culled nearest-triangle tiers for large scenes (the ports of the
JAX package's `ops/pallas_trace.py` kernels `_trace_kernel2c`,
`_cull_prepass_kernel`, `_trace_kernel3` and `_trace_kernel2`).

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
    lists. The tier of 1K-16K triangles.
  * `cull_prepass` + `chunk_lists` + `trace_nearest_mm2`: the (nb, nc)
    mask as a tensor, its ascending lists of surviving chunks, and the
    sweep over each block's list; `cull=False` lists every chunk.
  * `trace_nearest_mm2_stream`: the same sweep with the next chunk's rows
    fetched asynchronously while the current chunk is swept. The tier
    above 16K triangles.

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
from typing import Tuple

import torch

from software_rasterizer_tpu_torch.ops.bvh import slab_test
from software_rasterizer_tpu_torch.ops.trace_kernel import (
    BIG,
    _check,
    mt_plane,
    plane_winner,
)

MM2C_SUPER = 8      # chunks a super-chunk of the fused cull's first level
MAX_CHUNK = 256     # rows of a chunk the kernels stage in shared memory
MAX_BLOCK = 2048    # rays of a ray block (8 a thread, 256 threads)
# rays a ray block. A tuning value that changes no result: of 32, 64, 128,
# 512, 1024 and 2048, 1,048,576 camera rays in image order against the
# tessellated Cornell box took the least time at 64 on an H100, both at
# 9,216 triangles (fused cull) and at 147,456 (prepass, lists and streamed
# sweep together); chip_smoke.py phase 24 measures it anew
DEFAULT_BLOCK = 64
# (ray, row) tests of one step of the plain sweep (bounds its memory)
_PLAIN_STEP = 1 << 22

# kernel launches (the plain versions are not counted); a caller may
# reset them to 0 to count one run
LAUNCHES_MM2C = 0   # trace_fused_cull_kernel
LAUNCHES_CULL = 0   # cull_prepass_kernel
LAUNCHES_MM2 = 0    # trace_listed_kernel
LAUNCHES_MM2S = 0   # trace_listed_stream_kernel

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


def _check_table(tri_table, chunk: int, nc: int, device) -> None:
    _check("tri_table", tri_table, torch.float32, 12, device)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} must be in 1..{MAX_CHUNK}")
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
        lib.srt_cull_prepass.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp, vp]
        lib.srt_trace_listed.argtypes = [vp, ci, ci, vp, vp, cl, vp, vp, ci, ci,
                                         ci, vp, vp, vp, vp]
        lib.srt_trace_fused_cull.argtypes = [vp, ci, ci, vp, vp, ci, vp, vp, ci,
                                             vp, vp, ci, ci, vp, vp, vp, vp]
        for fn in (lib.srt_cull_prepass, lib.srt_trace_listed,
                   lib.srt_trace_fused_cull):
            fn.restype = ci
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


def _aligned(tri_table: torch.Tensor) -> torch.Tensor:
    """The table contiguous and on a 16-byte boundary (rows are copied as
    float4)."""
    tri_table = tri_table.contiguous()
    return tri_table if tri_table.data_ptr() % 16 == 0 else tri_table.clone()


def launch_cull_prepass(chunk_lo, chunk_hi, orig, d, block: int) -> torch.Tensor:
    """Launch `cull_prepass_kernel` on the current stream: the (nb, nc)
    uint8 mask. Checks every operand and raises on a launch error."""
    global LAUNCHES_CULL
    device = orig.device
    _need_cuda("launch_cull_prepass", device)
    n = _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, device)
    mask = torch.empty((-(-n // block), nc), dtype=torch.uint8, device=device)
    if mask.numel() == 0:
        return mask
    lo, hi, orig, d = (x.contiguous() for x in (chunk_lo, chunk_hi, orig, d))
    rc = _cuda_lib().srt_cull_prepass(
        lo.data_ptr(), hi.data_ptr(), nc, orig.data_ptr(), d.data_ptr(), n,
        block, mask.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cull_prepass kernel launch failed: cudaError {rc}")
    LAUNCHES_CULL += 1
    return mask


def launch_trace_listed(tri_table, counts, lists, orig, d, chunk: int,
                        block: int, stream: bool = False) -> Trace:
    """Launch `trace_listed_kernel` (or, with `stream`, the double-buffered
    `trace_listed_stream_kernel`) on the current stream. `lists` is
    (nb, nc) or one shared row (1, nc). Checks every operand and raises on
    a launch error."""
    global LAUNCHES_MM2, LAUNCHES_MM2S
    device = orig.device
    _need_cuda("launch_trace_listed", device)
    n = _check_rays(orig, d)
    _check_block(block)
    nc = -(-tri_table.shape[0] // chunk) if chunk >= 1 else 0
    _check_table(tri_table, chunk, nc, device)
    nb = -(-n // block)
    _check_lists(counts, lists, nb, nc, device)
    hit, idx, t = _outputs(n, device)
    if n == 0:
        return hit, idx, t
    tri_table = _aligned(tri_table)
    counts, lists, orig, d = (x.contiguous() for x in (counts, lists, orig, d))
    stride = 0 if lists.shape[0] == 1 else lists.shape[1]
    rc = _cuda_lib().srt_trace_listed(
        tri_table.data_ptr(), tri_table.shape[0], chunk, counts.data_ptr(),
        lists.data_ptr(), stride, orig.data_ptr(), d.data_ptr(), n, block,
        int(stream), hit.data_ptr(), idx.data_ptr(), t.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace_listed kernel launch failed: cudaError {rc}")
    if stream:
        LAUNCHES_MM2S += 1
    else:
        LAUNCHES_MM2 += 1
    return hit, idx, t


def launch_trace_fused_cull(tri_table, chunk_lo, chunk_hi, lo2, hi2, orig, d,
                            chunk: int, block: int) -> Trace:
    """Launch `trace_fused_cull_kernel` on the current stream. Checks
    every operand and raises on a launch error."""
    global LAUNCHES_MM2C
    device = orig.device
    _need_cuda("launch_trace_fused_cull", device)
    n = _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, device)
    _check_table(tri_table, chunk, nc, device)
    nsc = _check_boxes(lo2, hi2, device)
    if nsc != -(-nc // MM2C_SUPER):
        raise ValueError(f"{nsc} super-chunk boxes for {nc} chunks")
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
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace_fused_cull kernel launch failed: cudaError {rc}")
    LAUNCHES_MM2C += 1
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
    block lacks do not vote. CUDA rays run the kernel, CPU rays
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


def _listed(tri_table, chunk_lo, chunk_hi, orig, d, chunk, block, cull, stream):
    n = _check_rays(orig, d)
    _check_block(block)
    nc = _check_boxes(chunk_lo, chunk_hi, orig.device)
    _check_table(tri_table, chunk, nc, orig.device)
    if cull:
        counts, lists = chunk_lists(cull_prepass(chunk_lo, chunk_hi, orig, d, block))
    else:
        counts, lists = _all_chunks(-(-n // block), nc, orig.device)
    if _on_cpu(orig.device):
        return trace_listed_plain(tri_table, counts, lists, orig, d, chunk, block)
    return launch_trace_listed(tri_table, counts, lists, orig, d, chunk, block,
                               stream=stream)


def trace_nearest_mm2(tri_table, chunk_lo, chunk_hi, orig, d, chunk: int = 128,
                      block: int = DEFAULT_BLOCK, cull: bool = True) -> Trace:
    """Nearest triangle over each ray block's list of surviving chunks
    (`cull_prepass` + `chunk_lists`); `cull=False` visits every chunk."""
    return _listed(tri_table, chunk_lo, chunk_hi, orig, d, chunk, block, cull,
                   stream=False)


def trace_nearest_mm2_stream(tri_table, chunk_lo, chunk_hi, orig, d,
                             chunk: int = 256, block: int = DEFAULT_BLOCK,
                             cull: bool = True) -> Trace:
    """`trace_nearest_mm2` with the listed chunks' rows double-buffered:
    the next chunk is fetched while the current one is swept."""
    return _listed(tri_table, chunk_lo, chunk_hi, orig, d, chunk, block, cull,
                   stream=True)


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
