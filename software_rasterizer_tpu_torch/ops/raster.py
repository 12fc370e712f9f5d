"""Triangle rasterization (the port of the JAX package's ops/raster.py).

Reference behavior (src/Rasterizer.cpp): screen-space bbox scan,
barycentric inside-test with strict (0,1) bounds, z-buffer `<` test,
interpolate N/uv/color, shade, masked write-back.

As in the JAX package, barycentrics and depth are AFFINE in (x, y), so
each triangle is three coefficient rows (`triangle_setup`); the z-buffer
is a deterministic per-pixel argmin over candidate fragments (the lowest
triangle index wins equal z); and shading is DEFERRED to the winning
fragment of each pixel.

`render_raster_frame` is the pipeline: vertex stage -> setup and cull ->
the binned tile kernel (ops/raster_kernel.py; the hand-written CUDA
kernel on the card, its plain version on the CPU) -> fragment shading.
With `shaded=True` and only NORMAL / TEXTURE / PHONG shaders the
Blinn-Phong sum runs inside the tile kernel and only the texel quadratic
`direct + tex_a*texel + tex_b*texel^2` is applied here.

Not carried over from the JAX package: the (8,128)-block compaction of
the deferred shading and of the texel quadratic. Both are exact at every
tier and exist only because a TPU gather costs per row; here every pixel
is shaded in place and uncovered ones are masked. The environment flags
that picked the backend and the shaded kernel at trace time are the
explicit argument `shaded`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from software_rasterizer_tpu_torch.ops import shading as sh
from software_rasterizer_tpu_torch.ops.intersect import check_device, hom_transform
from software_rasterizer_tpu_torch.ops.raster_kernel import (
    TILE_H,
    TILE_W,
    _pixel_grid,
    pack_raster_tables,
    raster_tiles_fused,
    raster_tiles_shaded,
)
from software_rasterizer_tpu_torch.ops.texture_ops import fetch_nearest

INF = float("inf")
# the shaders whose Blinn-Phong sum the shaded tile kernel evaluates
_SHADED_TYPES = {int(sh.ShaderType.NORMAL), int(sh.ShaderType.TEXTURE),
                 int(sh.ShaderType.PHONG)}
# pixel x triangle pairs evaluated at once by `rasterize_tiles`
_PAIR_BUDGET = 1 << 22


@dataclasses.dataclass
class DeviceRasterGeometry:
    """`models.scene.RasterGeometry` on one device, plus the per-face
    tables that do not change between frames."""

    positions: torch.Tensor    # (V,3) f32 untransformed
    normals: torch.Tensor      # (V,3) f32
    vertex_mesh: torch.Tensor  # (V,) i64
    faces: torch.Tensor        # (F,3) i64
    face_valid: torch.Tensor   # (F,) bool
    tri_uv: torch.Tensor       # (F,3,2) f32 per-corner uvs
    tri_col: torch.Tensor      # (F,3,3) f32 per-corner colors
    shader_type_f: torch.Tensor  # (F,) f32 per-face shader id
    tex_id_f: torch.Tensor     # (F,) f32 per-face texture id (-1 none)
    textures: torch.Tensor     # (K,Hm,Wm,3) u8 atlas
    tex_wh: torch.Tensor       # (K,2) i32 (width, height)

    @property
    def device(self) -> torch.device:
        return self.positions.device


@dataclasses.dataclass
class DeviceRasterFrame:
    """`models.scene.RasterFrame` on one device; every field is a view
    of one uploaded buffer."""

    ndc_mvp: torch.Tensor      # (M,4,4)
    normal_mat: torch.Tensor   # (M,4,4)
    z_scale: torch.Tensor      # ()
    z_offset: torch.Tensor     # ()
    eye: torch.Tensor          # (3,)
    light_pos: torch.Tensor    # (L,3)
    light_int: torch.Tensor    # (L,3)
    lights: torch.Tensor       # (3 + 6L,) [eye | pos int per light]


def prepare_raster_geometry(geom, device) -> DeviceRasterGeometry:
    """Carry a `RasterGeometry` (host NumPy arrays; either package's
    NamedTuple) onto `device`."""
    device = check_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32 = torch.float32
    faces = t(geom.faces, torch.int64)
    face_mesh = t(geom.face_mesh, torch.int64)
    return DeviceRasterGeometry(
        positions=t(geom.positions, f32), normals=t(geom.normals, f32),
        vertex_mesh=t(geom.vertex_mesh, torch.int64), faces=faces,
        face_valid=t(geom.face_valid, torch.bool),
        tri_uv=t(geom.uvs, f32)[faces], tri_col=t(geom.colors, f32)[faces],
        shader_type_f=t(geom.shader_type, f32)[face_mesh],
        tex_id_f=t(geom.tex_id, f32)[face_mesh],
        textures=t(geom.textures, torch.uint8),
        tex_wh=t(geom.tex_wh, torch.int32),
    )


def _pack_frame(frame) -> np.ndarray:
    m = np.asarray(frame.ndc_mvp, np.float32).reshape(-1)
    lights = np.concatenate(
        [np.asarray(frame.light_pos, np.float32),
         np.asarray(frame.light_int, np.float32)], axis=1).reshape(-1)
    return np.concatenate([
        m, np.asarray(frame.normal_mat, np.float32).reshape(-1),
        np.asarray([frame.z_scale, frame.z_offset], np.float32),
        np.asarray(frame.eye, np.float32).reshape(3), lights])


def _frame_views(buf: torch.Tensor, n_mesh: int) -> DeviceRasterFrame:
    m = 16 * n_mesh
    lights = buf[2 * m + 2:]
    pi = lights[3:].reshape(-1, 6)
    return DeviceRasterFrame(
        ndc_mvp=buf[:m].reshape(n_mesh, 4, 4),
        normal_mat=buf[m:2 * m].reshape(n_mesh, 4, 4),
        z_scale=buf[2 * m], z_offset=buf[2 * m + 1], eye=lights[:3],
        light_pos=pi[:, :3], light_int=pi[:, 3:], lights=lights)


def prepare_raster_frame(frame, device) -> DeviceRasterFrame:
    """Carry a `RasterFrame` (host NumPy) onto `device` in one upload."""
    buf = torch.as_tensor(_pack_frame(frame), device=check_device(device))
    return _frame_views(buf, np.asarray(frame.ndc_mvp).shape[0])


def prepare_raster_frames(frames, device):
    """K frames of one scene in one upload: a list of DeviceRasterFrame."""
    n_mesh = np.asarray(frames[0].ndc_mvp).shape[0]
    buf = torch.as_tensor(np.stack([_pack_frame(f) for f in frames]),
                          device=check_device(device))
    return [_frame_views(buf[k], n_mesh) for k in range(len(frames))]


def raster_vertex_stage(positions, normals, vertex_mesh, ndc_mvp, normal_mat,
                        z_scale, z_offset):
    """Scene::loadTriangleStream vertex math (Scene.cpp:937-947) on device:
    NDC*P*V*M with divide, z remap, transpose(inverse(M)) normals with the
    vec4(n,1)/w quirk. Returns (positions', normals')."""
    pos = hom_transform(ndc_mvp[vertex_mesh], positions)
    pos = torch.cat([pos[:, :2], (pos[:, 2] * z_scale + z_offset)[:, None]],
                    dim=1)
    nrm = hom_transform(normal_mat[vertex_mesh], normals)
    return pos, nrm


def triangle_setup(tri_xy: torch.Tensor, tri_z: torch.Tensor):
    """Per-triangle affine coefficients.

    tri_xy: (F,3,2) screen xy; tri_z: (F,3).
    Returns (coef, zrow): coef (F,2,3) with rows alpha,beta as affine
    functions of (x,y,1); zrow (F,3) affine depth. Degenerate triangles
    (zero area) produce inf/nan coefficients which the strict (0,1)
    inside test rejects naturally.
    """
    ax, ay = tri_xy[:, 0, 0], tri_xy[:, 0, 1]
    bx, by = tri_xy[:, 1, 0], tri_xy[:, 1, 1]
    cx, cy = tri_xy[:, 2, 0], tri_xy[:, 2, 1]
    # areaABC = AB x AC (Rasterizer.cpp:61)
    d = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    inv_d = 1.0 / d
    # alpha = areaPBC/areaABC, expanded to affine form in (x, y, 1)
    row_a = torch.stack([(by - cy), (cx - bx), bx * cy - cx * by], dim=-1) * inv_d[:, None]
    row_b = torch.stack([(cy - ay), (ax - cx), cx * ay - ax * cy], dim=-1) * inv_d[:, None]
    coef = torch.stack([row_a, row_b], dim=1)  # (F,2,3)
    row_g = -row_a - row_b + torch.tensor([0.0, 0.0, 1.0], dtype=coef.dtype,
                                          device=coef.device)
    zrow = tri_z[:, 0:1] * row_a + tri_z[:, 1:2] * row_b + tri_z[:, 2:3] * row_g
    return coef, zrow


def face_cull_mask(tri_pos, eye, face_valid):
    """Backface cull: skip when dot(geometric_normal, eye) > 0
    (Rasterizer.cpp:203; getFaceNormal PerGeometry, Triangle.cpp:148-150)."""
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    fn = torch.linalg.cross(e1, e2)
    fn = fn / torch.clamp(torch.sqrt((fn * fn).sum(dim=-1, keepdim=True)),
                          min=1e-20)
    return face_valid & ((fn * eye).sum(dim=-1) <= 0)


def rasterize_tiles(coef, zrow, keep, height: int, width: int,
                    chunk: int = 512, row0: int = 0):
    """Deterministic min-z coverage resolve in plain tensors.

    coef: (F,2,3), zrow: (F,3), keep: (F,) bool (valid & front-facing).
    Returns best_idx (H,W) i32 (-1 where uncovered), best_z (H,W) f32.
    `row0` renders rows [row0, row0+height) of the absolute screen.

    Triangles stream through in chunks over bands of pixel rows; per
    chunk the exact two-step resolve of the JAX package: min z, then the
    lowest index among the slots that hold it.
    """
    dev = coef.device
    f = coef.shape[0]
    chunk = max(1, min(chunk, f))
    band = max(1, _PAIR_BUDGET // (chunk * width))
    xx, yy = _pixel_grid(height, width, row0, dev)
    best_z = torch.full((height, width), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((height, width), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(chunk, device=dev)
    for r0 in range(0, height, band):
        px = xx[r0:r0 + band].reshape(-1, 1)
        py = yy[r0:r0 + band].reshape(-1, 1)
        bz = best_z[r0:r0 + band].reshape(-1)
        bi = best_i[r0:r0 + band].reshape(-1)
        for sl in range(0, f, chunk):
            c = coef[sl:sl + chunk]
            zc = zrow[sl:sl + chunk]
            n = c.shape[0]
            alpha = px * c[None, :, 0, 0] + py * c[None, :, 0, 1] + c[None, :, 0, 2]
            beta = px * c[None, :, 1, 0] + py * c[None, :, 1, 1] + c[None, :, 1, 2]
            gamma = 1.0 - alpha - beta
            inside = ((alpha > 0) & (alpha < 1) & (beta > 0) & (beta < 1)
                      & (gamma > 0) & (gamma < 1) & keep[None, sl:sl + chunk])
            z = px * zc[None, :, 0] + py * zc[None, :, 1] + zc[None, :, 2]
            score = torch.where(inside, z, INF)
            c_best = score.min(dim=1).values
            c_arg = torch.where(score == c_best[:, None], lane[None, :n],
                                chunk).min(dim=1).values + sl
            better = c_best < bz                          # strict `<` z test
            bz = torch.where(better, c_best, bz)
            bi = torch.where(better, c_arg, bi)
        rows = bz.numel() // width
        best_z[r0:r0 + rows] = bz.reshape(rows, width)
        best_i[r0:r0 + rows] = bi.reshape(rows, width)
    best_i = torch.where(best_z < INF, best_i, -1)
    return best_i.to(torch.int32), best_z


def interpolate_fragments(best_idx, coef, tri_attrs):
    """Recompute barycentrics for the winning triangle per pixel and
    interpolate vertex attributes.

    tri_attrs: dict name -> (F,3,K) per-corner attributes.
    Returns dict name -> (H,W,K), plus (alpha,beta,gamma).
    """
    h, w = best_idx.shape
    t = torch.clamp(best_idx.long(), min=0)
    xx, yy = _pixel_grid(h, w, 0, best_idx.device)
    c = coef[t]  # (H,W,2,3)
    alpha = c[..., 0, 0] * xx + c[..., 0, 1] * yy + c[..., 0, 2]
    beta = c[..., 1, 0] * xx + c[..., 1, 1] * yy + c[..., 1, 2]
    gamma = 1.0 - alpha - beta
    out = {}
    for name, a in tri_attrs.items():
        av = a[t]  # (H,W,3,K)
        out[name] = (alpha[..., None] * av[..., 0, :]
                     + beta[..., None] * av[..., 1, :]
                     + gamma[..., None] * av[..., 2, :])
    return out, (alpha, beta, gamma)


def shaded_kernel_applies(shaded: bool, active_types) -> bool:
    """The dispatch rule of the JAX package: the shaded tile kernel runs
    only when asked for and every active shader is NORMAL, TEXTURE or
    PHONG (BUMP and DISPLACEMENT perturb normals through texels)."""
    return (bool(shaded) and active_types is not None
            and set(int(t) for t in active_types) <= _SHADED_TYPES)


def raster_tables(geom: DeviceRasterGeometry, frame: DeviceRasterFrame,
                  cull: bool = True):
    """The frame's front half: vertex stage, cull mask, triangle setup
    and the tile kernels' operands. Returns (geo (F,12), attr (F,28),
    tri_bbox (F,4), keep (F,) bool)."""
    pos, nrm = raster_vertex_stage(
        geom.positions, geom.normals, geom.vertex_mesh,
        frame.ndc_mvp, frame.normal_mat, frame.z_scale, frame.z_offset)
    tri_pos = pos[geom.faces]      # (F,3,3)
    keep = (face_cull_mask(tri_pos, frame.eye, geom.face_valid) if cull
            else geom.face_valid)
    xy = tri_pos[..., :2]
    coef, zrow = triangle_setup(xy, tri_pos[..., 2])
    tri_bbox = torch.cat([xy.amin(dim=1), xy.amax(dim=1)], dim=1)
    geo_t, attr_t = pack_raster_tables(
        coef, zrow, nrm[geom.faces], geom.tri_uv, geom.tri_col,
        geom.shader_type_f, geom.tex_id_f)
    return geo_t, attr_t, tri_bbox, keep


def shade_deferred(r, geom, frame, row0: int = 0, active_types=None):
    """Deferred shading of `raster_tiles_fused`'s result `r`: every pixel
    is shaded from its winner's planes at its screen position (x, y, z)
    and uncovered pixels are set to 0."""
    height, width = r["best_idx"].shape
    xx, yy = _pixel_grid(height, width, row0, geom.device)
    rgb = sh.shade_fragments(
        r["shader_type"], frame.eye,
        torch.stack([xx, yy, r["best_z"]], dim=-1),
        r["normal"], r["uv"], r["color"], r["tex_id"],
        geom.textures, geom.tex_wh, frame.light_pos, frame.light_int,
        active_types=active_types)
    return torch.where((r["best_idx"] >= 0)[..., None], rgb, 0.0)


def apply_tex_quadratic(r, geom):
    """The texel terms of `raster_tiles_shaded`'s result `r`:
    image = direct + tex_a * texel + tex_b * texel^2 on pixels with
    tex_id >= 0."""
    tex_id = r["tex_id"]
    texel = fetch_nearest(geom.textures, geom.tex_wh,
                          torch.clamp(tex_id, min=0), r["uv"])
    return r["direct"] + torch.where(
        (tex_id >= 0)[..., None],
        r["tex_a"] * texel + r["tex_b"] * texel * texel, 0.0)


def render_raster_frame(
    geom: DeviceRasterGeometry,
    frame,
    height: int,
    width: int,
    tile: Tuple[int, int] = (TILE_H, TILE_W),
    cull: bool = True,
    active_types=None,
    with_stats: bool = False,
    row0: int = 0,
    shaded: bool = False,
):
    """Full raster pipeline: vertex stage -> coverage/z resolve -> fragment
    shading. Returns (image (H,W,3) f32 in [0,1] pre-clamp, zbuf), or
    (image, zbuf, stats) when `with_stats`: stats["bin_dropped"] (a 0-d
    i32 tensor) counts triangles dropped by the per-tile binning cap, so
    a scene that exceeds it is DETECTED, never silently missing
    geometry, and stats["kernel"] names the tile kernel that ran.

    geom: `prepare_raster_geometry`'s result; frame: a host
    `models.scene.RasterFrame` or `prepare_raster_frame`'s result. The
    frame is computed on geom's device: through the CUDA tile kernels on
    the card, through their plain versions on the CPU.

    `row0` renders the absolute screen rows [row0, row0+height): every
    per-pixel op sees the same float32 operands as the monolithic frame,
    so a row-sharded render reassembles BIT-EXACTLY.
    `active_types`: tuple of the ShaderType values used by the scene's
    meshes (None evaluates all five). `shaded` asks for the in-kernel
    Blinn-Phong tile kernel; see `shaded_kernel_applies`. `tile` is the
    kernels' (rows, cols) tile; no output depends on it.
    """
    if not isinstance(frame, DeviceRasterFrame):
        frame = prepare_raster_frame(frame, geom.device)
    geo_t, attr_t, tri_bbox, keep = raster_tables(geom, frame, cull)
    tile_h, tile_w = tile
    if shaded_kernel_applies(shaded, active_types):
        r = raster_tiles_shaded(
            geo_t, attr_t, tri_bbox, keep, frame.lights.contiguous(), height,
            width, tile_h=tile_h, tile_w=tile_w, row0=row0)
        image = apply_tex_quadratic(r, geom)
        kernel = "raster_tiles_shaded"
    else:
        r = raster_tiles_fused(
            geo_t, attr_t, tri_bbox, keep, height, width, tile_h=tile_h,
            tile_w=tile_w, row0=row0)
        image = shade_deferred(r, geom, frame, row0, active_types)
        kernel = "raster_tiles"
    zbuf = r["best_z"]                 # +inf where nothing covers
    if with_stats:
        return image, zbuf, {"bin_dropped": r["bin_dropped"], "kernel": kernel}
    return image, zbuf


def render_colored_triangles(tri_pos, tri_col, face_valid, height: int,
                             width: int, chunk: int = 128):
    """Raw-coordinates demo path (README 0x02): screen-space triangles with
    interpolated vertex colors and a z-buffer, no lighting, in plain
    tensors on the inputs' device.

    tri_pos: (F,3,3) screen xyz; tri_col: (F,3,3).
    """
    coef, zrow = triangle_setup(tri_pos[..., :2], tri_pos[..., 2])
    best_idx, best_z = rasterize_tiles(coef, zrow, face_valid, height, width,
                                       chunk)
    covered = best_idx >= 0
    attrs, _ = interpolate_fragments(best_idx, coef, {"color": tri_col})
    image = torch.where(covered[..., None], attrs["color"], 0.0)
    return image, torch.where(covered, best_z, INF)
