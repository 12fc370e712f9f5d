"""Binned tile rasterization kernels (the port of the JAX package's
`ops/pallas_raster.py`: `raster_tiles_fused` / `_tile_kernel` and
`raster_tiles_shaded` / `_tile_kernel_shaded`).

The screen is cut into tiles. `bin_triangles` builds, in plain PyTorch,
each tile's ascending list of the kept triangles whose screen bounding
box overlaps it. One kernel launch then resolves every pixel: the affine
coverage test with strict (0,1) bounds, the min-z winner with the lowest
triangle index on a tie, and the winner's interpolated normal / uv /
color and shader / texture ids (`raster_tiles_fused`); the shaded
variant also evaluates Blinn-Phong for the NORMAL / TEXTURE / PHONG
shaders in the kernel and returns the terms of
`rgb = direct + tex_a * texel + tex_b * texel^2` (`raster_tiles_shaded`).

  * `raster_tiles_fused`, `raster_tiles_shaded`: the entry points. On
    CUDA tensors they launch the hand-written kernels
    (csrc/raster_tiles.cu) and count the launch in `LAUNCHES` /
    `LAUNCHES_SHADED`; on CPU tensors they run the plain versions.
  * `raster_tiles_fused_plain`, `raster_tiles_shaded_plain`: the same
    computation in plain PyTorch over the same tile lists, in the
    kernels' operation order.

Triangles beyond a tile's list capacity `cap` are counted in
`bin_dropped`, never lost silently. No output depends on the tile size
as long as nothing is dropped.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from software_rasterizer_tpu_torch.ops.path_kernel import _check_table

BIG = 3.0e38        # the running best z starts here, not at +inf
GEO_COLS = 12
ATTR_COLS = 28
# the kernels' tile: one thread per pixel, one block per tile, a warp per
# tile row
TILE_H, TILE_W = 16, 32
MAX_TILE_PIXELS = 1024  # threads of a block

# kernel launches made by raster_tiles_fused and raster_tiles_shaded (the
# plain versions are not counted); a caller may reset them to 0
LAUNCHES = 0
LAUNCHES_SHADED = 0


def pack_raster_tables(coef, zrow, tri_nrm, tri_uv, tri_col, shader_type_f,
                       tex_id_f) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F,12) geometry [row_a(3) | row_b(3) | zrow(3) | pad] and (F,28)
    attribute [n0 n1 n2 (9) | uv0 uv1 uv2 (6) | c0 c1 c2 (9) | shader_id |
    tex_id | pad(2)] operand tables of the tile kernels."""
    f = coef.shape[0]
    geo = torch.cat([
        coef.reshape(f, 6),
        zrow,
        torch.zeros((f, 3), dtype=coef.dtype, device=coef.device),
    ], dim=1)
    attr = torch.cat([
        tri_nrm.reshape(f, 9),
        tri_uv.reshape(f, 6),
        tri_col.reshape(f, 9),
        shader_type_f[:, None],
        tex_id_f[:, None],
        torch.zeros((f, 2), dtype=coef.dtype, device=coef.device),
    ], dim=1)
    return geo.contiguous(), attr.contiguous()


def bin_triangles(tri_bbox: torch.Tensor, keep: torch.Tensor, gh: int,
                  gw: int, tile_h: int, tile_w: int, cap: int, row0: int = 0):
    """Per-tile triangle lists from screen bboxes.

    tri_bbox: (F,4) [min_x, min_y, max_x, max_y]; keep: (F,) bool.
    Returns (lists (T,cap) i32 ascending per row, counts (T,) i32 clamped
    to cap, dropped () i32 total overflow). `row0` places the tile grid
    at absolute screen row row0 (framebuffer row-sharding). The (T,F)
    overlap matrix, a row-wise cumsum and one flat scatter keep every
    list in ascending triangle order, which the kernels' tie rule needs.
    """
    dev = tri_bbox.device
    f = tri_bbox.shape[0]
    t = gh * gw
    ar = torch.arange(t, dtype=torch.int32, device=dev)
    ty = (torch.div(ar, gw, rounding_mode="floor") * tile_h + int(row0)).float()
    tx = (ar % gw).float() * tile_w
    ov = (
        (tri_bbox[None, :, 0] <= tx[:, None] + (tile_w - 1))
        & (tri_bbox[None, :, 1] <= ty[:, None] + (tile_h - 1))
        & (tri_bbox[None, :, 2] >= tx[:, None])
        & (tri_bbox[None, :, 3] >= ty[:, None])
        & keep[None, :]
    )
    pos = torch.cumsum(ov, dim=1, dtype=torch.int32) - 1     # slot per hit
    n_ov = pos[:, -1] + 1 if f else torch.zeros(t, dtype=torch.int32, device=dev)
    # overflow and dead slots land on one extra tail slot and drop
    tgt = torch.where(ov & (pos < cap), ar[:, None] * cap + pos, t * cap)
    src = torch.arange(f, dtype=torch.int32, device=dev).expand(t, f)
    lists = torch.zeros(t * cap + 1, dtype=torch.int32, device=dev)
    lists[tgt.reshape(-1).long()] = src.reshape(-1)
    counts = torch.clamp(n_ov, max=cap)
    dropped = torch.clamp(n_ov - cap, min=0).sum().to(torch.int32)
    return lists[:-1].reshape(t, cap), counts, dropped


# ---------------------------------------------------------------- CUDA


def _cuda_fn():
    from software_rasterizer_tpu_torch.utils.cuda_build import load_library

    lib = load_library("raster_tiles", ["raster_tiles.cu"])
    fn = lib.srt_raster_tiles
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [ci] * 11 + [vp]
        fn.restype = ci
    return fn


def build_kernel() -> None:
    """Compile (or reuse) and load the CUDA library."""
    _cuda_fn()


def launch_raster_tiles(geo: torch.Tensor, attr: torch.Tensor,
                        lists: torch.Tensor, counts: torch.Tensor,
                        lights: Optional[torch.Tensor], *, height: int,
                        width: int, gh: int, gw: int, tile_h: int,
                        tile_w: int, row0: int = 0):
    """Launch csrc/raster_tiles.cu on the current stream: the shaded
    kernel when `lights` ((3 + 6L,) float32) is given, else the fused
    one. Returns best_z (H,W) f32, best_idx (H,W) i32, planes (8 or
    12,H,W) f32 and ids (2,H,W) i32. Checks every operand and raises on a
    launch error."""
    global LAUNCHES, LAUNCHES_SHADED
    device = geo.device
    if device.type != "cuda":
        raise ValueError(f"launch_raster_tiles needs CUDA tensors, got {device}")
    f32, i32 = torch.float32, torch.int32
    _check_table("geo", geo, f32, GEO_COLS, device)
    _check_table("attr", attr, f32, ATTR_COLS, device)
    _check_table("lists", lists, i32, None, device)
    _check_table("counts", counts, i32, None, device)
    if attr.shape[0] != geo.shape[0]:
        raise ValueError("geo and attr disagree on the triangle count")
    if lists.dim() != 2 or lists.shape[0] != gh * gw or counts.shape != (gh * gw,):
        raise ValueError(f"lists {tuple(lists.shape)} / counts "
                         f"{tuple(counts.shape)} disagree with {gh}x{gw} tiles")
    if tile_h < 1 or tile_w < 1 or tile_h * tile_w > MAX_TILE_PIXELS:
        raise ValueError(f"tile {tile_h}x{tile_w} exceeds {MAX_TILE_PIXELS} "
                         f"pixels, one thread each")
    if height < 1 or width < 1 or gh * tile_h < height or gw * tile_w < width:
        raise ValueError(f"{gh}x{gw} tiles of {tile_h}x{tile_w} do not cover "
                         f"{height}x{width}")
    shaded = lights is not None
    n_lights = 0
    if shaded:
        _check_table("lights", lights, f32, None, device)
        if lights.dim() != 1 or lights.numel() < 3 or (lights.numel() - 3) % 6:
            raise ValueError("lights must be (3 + 6L,)")
        n_lights = (lights.numel() - 3) // 6
    n_planes = 12 if shaded else 8
    bz = torch.empty((height, width), dtype=f32, device=device)
    bi = torch.empty((height, width), dtype=i32, device=device)
    planes = torch.empty((n_planes, height, width), dtype=f32, device=device)
    ids = torch.empty((2, height, width), dtype=i32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _cuda_fn()(
        geo.data_ptr(), attr.data_ptr(), lists.data_ptr(), counts.data_ptr(),
        lights.data_ptr() if shaded else None,
        bz.data_ptr(), bi.data_ptr(), planes.data_ptr(), ids.data_ptr(),
        geo.shape[0], lists.shape[1], gh, gw, tile_h, tile_w, height, width,
        int(row0), n_lights, int(shaded), stream,
    )
    if rc != 0:
        raise RuntimeError(f"raster_tiles kernel launch failed: cudaError {rc}")
    if shaded:
        LAUNCHES_SHADED += 1
    else:
        LAUNCHES += 1
    return bz, bi, planes, ids


# --------------------------------------------------------- plain version


def _pixel_grid(height: int, width: int, row0: int, device):
    """Integer pixel coordinates (reference quirk: fragments are sampled
    at INTEGER pixel coords, Rasterizer.cpp:285-287) as float32 (H,W);
    `row0` offsets y to absolute screen rows before the conversion."""
    yy = (torch.arange(height, dtype=torch.int32, device=device) + int(row0)).float()
    xx = torch.arange(width, dtype=torch.int32, device=device).float()
    return xx[None, :].expand(height, width), yy[:, None].expand(height, width)


def _bary(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """alpha, beta, gamma of the geometry rows `g` (...,>=6) at (x, y)."""
    alpha = x * g[..., 0] + y * g[..., 1] + g[..., 2]
    beta = x * g[..., 3] + y * g[..., 4] + g[..., 5]
    return alpha, beta, 1.0 - alpha - beta


def _tiles_plain(geo, attr, lists, counts, lights, height, width, gw, tile_h,
                 tile_w, row0):
    """The tile kernels in plain PyTorch: every pixel walks its tile's
    list entry by entry (one vectorized step per list slot), then reads
    its winner's rows once."""
    dev = geo.device
    x, y = _pixel_grid(height, width, row0, dev)
    rows = torch.arange(height, device=dev) // tile_h
    cols = torch.arange(width, device=dev) // tile_w
    tile_id = rows[:, None] * gw + cols[None, :]              # (H,W)
    cnt = counts.long()[tile_id]
    bz = torch.full((height, width), BIG, dtype=torch.float32, device=dev)
    bi = torch.full((height, width), -1, dtype=torch.int64, device=dev)
    lists_l = lists.long()
    n_steps = int(counts.max()) if counts.numel() else 0
    for j in range(n_steps):
        f = lists_l[:, j][tile_id]
        g = geo[f]
        alpha, beta, gamma = _bary(g, x, y)
        inside = ((alpha > 0) & (alpha < 1) & (beta > 0) & (beta < 1)
                  & (gamma > 0) & (gamma < 1) & (j < cnt))
        z = x * g[..., 6] + y * g[..., 7] + g[..., 8]
        score = torch.where(inside, z, BIG)
        better = score < bz          # strict <: the lowest index wins a tie
        bz = torch.where(better, score, bz)
        bi = torch.where(better, f, bi)

    covered = bi >= 0
    win = torch.clamp(bi, min=0)
    alpha, beta, gamma = _bary(geo[win], x, y)
    a = attr[win]                                             # (H,W,28)
    # channel k of [nx ny nz u v r g b]: corner columns in attr
    cols3 = [(k, k + 3, k + 6) for k in range(3)]
    cols3 += [(9 + k, 11 + k, 13 + k) for k in range(2)]
    cols3 += [(15 + k, 18 + k, 21 + k) for k in range(3)]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pl = [torch.where(covered, alpha * a[..., c0] + beta * a[..., c1]
                      + gamma * a[..., c2], zero) for c0, c1, c2 in cols3]
    sid = torch.where(covered, a[..., 24].to(torch.int32), 0)
    tid = torch.where(covered, a[..., 25].to(torch.int32), -1)
    best_z = torch.where(covered, bz, float("inf"))
    best_idx = bi.to(torch.int32)
    if lights is None:
        return best_z, best_idx, torch.stack(pl), torch.stack([sid, tid])

    # in-kernel Blinn-Phong terms (ops/pallas_raster.py:291-357)
    nx, ny, nz = pl[0], pl[1], pl[2]
    nn = torch.sqrt(nx * nx + ny * ny + nz * nz)
    ninv = torch.where(nn > 0, 1.0 / torch.where(nn > 0, nn, 1.0), zero)
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    lg = [float(v) for v in lights.cpu()]
    vx, vy, vz = lg[0] - x, lg[1] - y, lg[2] - bz
    amb = [torch.zeros_like(bz) for _ in range(3)]
    dif = [torch.zeros_like(bz) for _ in range(3)]
    for li in range((len(lg) - 3) // 6):
        lpx, lpy, lpz, *lint = lg[3 + 6 * li: 9 + 6 * li]
        ldx, ldy, ldz = lpx - x, lpy - y, lpz - bz
        att = torch.sqrt(ldx * ldx + ldy * ldy)
        inv_att = 1.0 / torch.clamp(att, min=1e-12)
        ln = torch.sqrt(ldx * ldx + ldy * ldy + ldz * ldz)
        linv = torch.where(ln > 0, 1.0 / torch.where(ln > 0, ln, 1.0), zero)
        cos_t = torch.clamp((nx * ldx + ny * ldy + nz * ldz) * linv, min=0.0)
        hx, hy, hz = ldx + vx, ldy + vy, ldz + vz
        hn = torch.sqrt(hx * hx + hy * hy + hz * hz)
        hinv = torch.where(hn > 0, 1.0 / torch.where(hn > 0, hn, 1.0), zero)
        cos_a = torch.clamp((nx * hx + ny * hy + nz * hz) * hinv, min=0.0)
        spec = torch.where(
            cos_a > 0.0,
            torch.exp(150.0 * torch.log(torch.clamp(cos_a, min=1e-30))), zero)
        for k in range(3):
            amb[k] = amb[k] + (0.005 + 0.7937 * spec * inv_att) * lint[k]
            dif[k] = dif[k] + cos_t * inv_att * lint[k]
    is_norm = sid == 0
    is_tex = sid == 1
    nrm = (nx, ny, nz)
    out = [None] * 12
    for k in range(3):
        c = pl[5 + k]
        direct = torch.where(is_norm, (nrm[k] + 1.0) * 0.5,
                             amb[k] * c + dif[k] * c * c)
        out[k] = torch.where(covered & ~is_tex, direct, zero)
        out[3 + k] = torch.where(covered & is_tex, amb[k], zero)
        out[8 + k] = torch.where(covered & is_tex, dif[k], zero)
    out[6], out[7] = pl[3], pl[4]
    out[11] = torch.zeros_like(bz)
    ids = torch.stack([torch.where(is_tex, tid, -1), sid])
    return best_z, best_idx, torch.stack(out), ids


# ------------------------------------------------------------ entry points


def _raster_tiles(geo, attr, tri_bbox, keep, lights, height, width, tile_h,
                  tile_w, cap, row0, plain: bool):
    device = geo.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    gh = -(-height // tile_h)
    gw = -(-width // tile_w)
    cap = min(cap, max(256, ((geo.shape[0] + 127) // 128) * 128))
    lists, counts, dropped = bin_triangles(
        tri_bbox, keep, gh, gw, tile_h, tile_w, cap, row0=row0)
    if plain or device.type == "cpu":
        out = _tiles_plain(geo, attr, lists, counts, lights, height, width,
                           gw, tile_h, tile_w, row0)
    else:
        out = launch_raster_tiles(
            geo, attr, lists, counts, lights, height=height, width=width,
            gh=gh, gw=gw, tile_h=tile_h, tile_w=tile_w, row0=row0)
    return out, dropped


def _fused_dict(out, dropped) -> Dict[str, torch.Tensor]:
    bz, bi, pa, ids = out
    return {
        "best_z": bz,
        "best_idx": bi,
        "normal": pa[0:3].permute(1, 2, 0),
        "uv": pa[3:5].permute(1, 2, 0),
        "color": pa[5:8].permute(1, 2, 0),
        "shader_type": ids[0],
        "tex_id": ids[1],
        "bin_dropped": dropped,
    }


def _shaded_dict(out, dropped) -> Dict[str, torch.Tensor]:
    bz, bi, pa, ids = out
    return {
        "best_z": bz,
        "best_idx": bi,
        "direct": pa[0:3].permute(1, 2, 0),
        "tex_a": pa[3:6].permute(1, 2, 0),
        "uv": pa[6:8].permute(1, 2, 0),
        "tex_b": pa[8:11].permute(1, 2, 0),
        "tex_id": ids[0],
        "bin_dropped": dropped,
    }


def raster_tiles_fused(geo, attr, tri_bbox, keep, height: int, width: int,
                       tile_h: int = TILE_H, tile_w: int = TILE_W,
                       cap: int = 2048, row0: int = 0):
    """Binned + fused tile rasterization.

    geo (F,12), attr (F,28): see `pack_raster_tables`; tri_bbox (F,4);
    keep (F,) bool. Returns dict: best_z (H,W) f32 (inf uncovered),
    best_idx (H,W) i32 (-1 uncovered), normal/uv/color (H,W,3|2) f32,
    shader_type/tex_id (H,W) i32, bin_dropped () i32. `row0` rasterizes
    the absolute screen rows [row0, row0+height): bit-exact row-sharding.
    CUDA tensors run the kernel; CPU tensors run the plain version."""
    return _fused_dict(*_raster_tiles(geo, attr, tri_bbox, keep, None, height,
                                      width, tile_h, tile_w, cap, row0, False))


def raster_tiles_fused_plain(geo, attr, tri_bbox, keep, height: int,
                             width: int, tile_h: int = TILE_H,
                             tile_w: int = TILE_W, cap: int = 2048,
                             row0: int = 0):
    """Plain PyTorch version of `raster_tiles_fused` (same signature and
    semantics), on the tensors' device."""
    return _fused_dict(*_raster_tiles(geo, attr, tri_bbox, keep, None, height,
                                      width, tile_h, tile_w, cap, row0, True))


def raster_tiles_shaded(geo, attr, tri_bbox, keep, lights, height: int,
                        width: int, tile_h: int = TILE_H, tile_w: int = TILE_W,
                        cap: int = 2048, row0: int = 0):
    """Binned + fused tile rasterization with in-kernel Blinn-Phong for
    the NORMAL / TEXTURE / PHONG shaders. `lights`: (3 + 6L,) f32 [eye |
    pos(3) int(3) per light]. Returns dict: best_z,
    best_idx, direct (H,W,3), tex_a (H,W,3), tex_b (H,W,3), uv (H,W,2),
    tex_id (H,W; -1 for non-texture pixels), bin_dropped. The final image
    is direct + tex_a*texel + tex_b*texel^2, the texel fetched by the
    caller. CUDA tensors run the kernel; CPU tensors the plain version."""
    return _shaded_dict(*_raster_tiles(geo, attr, tri_bbox, keep, lights,
                                       height, width, tile_h, tile_w, cap,
                                       row0, False))


def raster_tiles_shaded_plain(geo, attr, tri_bbox, keep, lights, height: int,
                              width: int, tile_h: int = TILE_H,
                              tile_w: int = TILE_W, cap: int = 2048,
                              row0: int = 0):
    """Plain PyTorch version of `raster_tiles_shaded` (same signature and
    semantics), on the tensors' device."""
    return _shaded_dict(*_raster_tiles(geo, attr, tri_bbox, keep, lights,
                                       height, width, tile_h, tile_w, cap,
                                       row0, True))
