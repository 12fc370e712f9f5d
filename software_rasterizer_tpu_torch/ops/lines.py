"""Wireframe / line rasterization (reference: Bresenham drawLine,
Render.cpp:112-186; rasterizeWireframe edge colors, Rasterizer.cpp:4-9).

As in the JAX package, instead of the sequential Bresenham walk each
edge is sampled at S = max(H, W) parametric points and scattered: every
pixel Bresenham would touch is hit (sampling density >= 1 px per step).

Where several edges touch one pixel, the z-buffer takes the smallest z
and the colour is that of the edge with the lowest index. (The JAX
package's scatter leaves the colour of such a pixel to the order its
backend applies duplicates in; the z plane is defined in both.)
"""

from __future__ import annotations

import torch

from software_rasterizer_tpu_torch.ops.raster import (
    DeviceRasterFrame,
    prepare_raster_frame,
    raster_vertex_stage,
)


def draw_lines(p0, p1, colors, valid, height: int, width: int):
    """Scatter line segments into an (H,W,3) image.

    p0/p1: (E,3) screen-space endpoints; colors: (E,3); valid: (E,).
    Returns (image, zbuf) with z from linear interpolation along the edge.
    """
    dev = p0.device
    e = p0.shape[0]
    s = max(height, width)
    t = (torch.arange(s, dtype=torch.float32, device=dev)
         / float(max(s - 1, 1)))[None, :, None]               # (1,S,1)
    pts = p0[:, None, :] * (1.0 - t) + p1[:, None, :] * t    # (E,S,3)
    xi = torch.round(pts[..., 0]).to(torch.int64)
    yi = torch.round(pts[..., 1]).to(torch.int64)
    ok = (valid[:, None] & (xi >= 0) & (xi < width)
          & (yi >= 0) & (yi < height))
    n = height * width
    flat = torch.where(ok, yi * width + xi, n).reshape(-1)    # clip bucket
    edge = torch.arange(e, device=dev)[:, None].expand(e, s).reshape(-1)
    first = torch.full((n + 1,), e, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, flat, edge, reduce="amin")
    first = first[:-1]
    hit = first < e
    img = torch.where(hit[:, None], colors[torch.clamp(first, max=max(e - 1, 0))],
                      0.0) if e else torch.zeros((n, 3), device=dev)
    zb = torch.full((n + 1,), float("inf"), dtype=torch.float32, device=dev)
    zb.scatter_reduce_(
        0, flat, torch.where(ok, pts[..., 2], float("inf")).reshape(-1),
        reduce="amin")
    return img.reshape(height, width, 3), zb[:-1].reshape(height, width)


def rasterize_wireframe(geom, frame, height: int, width: int):
    """LINES primitive for a scene: all triangle edges, colored by vertex
    color per edge (Rasterizer.cpp:4-9 passes m_color[k] per edge).

    geom: `ops.raster.prepare_raster_geometry`'s result; frame: a host
    RasterFrame or `prepare_raster_frame`'s result."""
    if not isinstance(frame, DeviceRasterFrame):
        frame = prepare_raster_frame(frame, geom.device)
    pos, _ = raster_vertex_stage(
        geom.positions, geom.normals, geom.vertex_mesh,
        frame.ndc_mvp, frame.normal_mat, frame.z_scale, frame.z_offset)
    tri = pos[geom.faces]          # (F,3,3)
    col = geom.tri_col             # (F,3,3)
    # edges: (b,a), (b,c), (a,c) with colors m_color[0..2]
    p0 = torch.cat([tri[:, 1], tri[:, 1], tri[:, 0]])
    p1 = torch.cat([tri[:, 0], tri[:, 2], tri[:, 2]])
    c = torch.cat([col[:, 0], col[:, 1], col[:, 2]])
    v = torch.cat([geom.face_valid] * 3)
    return draw_lines(p0, p1, c, v, height, width)
