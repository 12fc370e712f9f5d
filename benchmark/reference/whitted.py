"""Whitted ray tracing of chosen pixels of a camera frame
(SoftRasterizer's Scene::whittedRayTracing, Scene.cpp:478-617), for
scenes of diffuse meshes with one emitter: a camera ray per pixel, a miss
adds the background, a diffuse hit adds the Phong term toward the
emitter's centre behind a shadow ray (lifted off the surface by 1e-4 of
the hit's largest coordinate, at least 1e-4; lit only where its nearest
hit is emissive; ambient and diffuse dropped where |t^2 - d^2| > 1e-6).
Mirror and glass materials, textures and several emitters are outside
this reference's scope and raise."""

from __future__ import annotations

import torch

from reference.scene import BIG, camera_scale, nearest, norm3

EPS = 1e-5
SHADOW_BIAS = 1e-4


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def camera_rays(eye, fovy: float, width: int, height: int, pixels, dtype):
    """Origins and unit directions (P,3) of the camera rays of `pixels`."""
    scale = camera_scale(fovy)
    aspect = width / float(height)
    yy = (pixels // width).to(dtype)
    xx = (pixels % width).to(dtype)
    x = (2.0 * (xx + 0.5) / width - 1.0) * aspect * scale
    y = (1.0 - 2.0 * (yy + 0.5) / height) * scale
    e = torch.tensor(eye, dtype=dtype, device=pixels.device)
    d = torch.stack([x, y, torch.zeros_like(x)], dim=-1) - e
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return e.expand_as(d), d


def render_pixels(ts, width: int, height: int, fovy: float, pixels: torch.Tensor,
                  max_depth: int = 5) -> torch.Tensor:
    """Colour (P,3) of `pixels` (P,) int64 in the dtype of `ts`. A
    diffuse hit is shaded at every depth and only mirror and glass rays
    recurse, so `max_depth` changes nothing in this scope."""
    if ts.n_emitters != 1 or ts.textured or bool((ts.mtype != 0).any()):
        raise NotImplementedError("diffuse meshes, one emitter, no texture")
    if max_depth < 0:
        raise ValueError(f"bad max_depth {max_depth}")
    dt = ts.dtype
    orig, d = camera_rays(ts.eye, fovy, width, height, pixels.to(ts.device), dt)
    o = tuple(orig[:, k] for k in range(3))
    dd = tuple(d[:, k] for k in range(3))
    tt, row, _, _ = nearest(ts.tri, orig.contiguous(), d)
    hit = tt < BIG
    f = torch.clamp(row, min=0)
    g = ts.tri[f]
    # the winner's u, v and t again, from its own row
    tm, u, v = _winner_mt(g, o, dd)
    c = tuple(o[k] + dd[k] * tm for k in range(3))
    wb = 1.0 - u - v
    nrm = norm3(*(wb * ts.n0[f, k] + u * ts.n1[f, k] + v * ts.n2[f, k] for k in range(3)),
                eps=1e-20)
    kd = tuple(ts.kd[f, k] for k in range(3))
    ka = tuple(ts.ka[f, k] for k in range(3))
    ks = tuple(ts.ks[f, k] for k in range(3))
    sexp = ts.spec[f]

    # Phong toward the emitter's centre, behind a shadow ray
    ec = ts.emitters[0, :3]
    ll = norm3(ec[0] - c[0], ec[1] - c[1], ec[2] - c[2])
    ndl = _dot(nrm, ll)
    side = torch.where(ndl >= 0.0, 1.0, -1.0).to(dt)
    bias = SHADOW_BIAS * torch.maximum(torch.maximum(
        c[0].abs(), torch.maximum(c[1].abs(), c[2].abs())), torch.ones_like(c[0]))
    so = torch.stack([c[k] + nrm[k] * (side * bias) for k in range(3)], dim=1)
    diff = torch.clamp(ndl, min=0.0)
    mldn = (-ll[0]) * nrm[0] + (-ll[1]) * nrm[1] + (-ll[2]) * nrm[2]
    rl = norm3(*(-ll[k] - 2.0 * mldn * nrm[k] for k in range(3)))
    sdot = torch.clamp(-_dot(dd, rl), min=0.0)
    spec = torch.where(sdot > 0.0,
                       torch.exp(sexp * torch.log(torch.clamp(sdot, min=1e-30))),
                       torch.where(sexp == 0.0, 1.0, 0.0).to(dt))
    t_sh, row2, _, _ = nearest(ts.tri, so, torch.stack(ll, dim=1))
    f2 = torch.clamp(row2, min=0)
    em = tuple(torch.where(t_sh < BIG, ts.emit[f2, k], 0.0) for k in range(3))
    lit = (t_sh < BIG) & (torch.sqrt(_dot(em, em)) >= EPS)
    dl = tuple(ll[k] * t_sh for k in range(3))
    in_shadow = (t_sh * t_sh - _dot(dl, dl)).abs() > 1e-6
    amb = torch.where(in_shadow, 0.0, 1.0).to(dt)
    out = []
    for k in range(3):
        term = amb * (ka[k] + diff * kd[k]) * em[k] + spec * ks[k] * em[k]
        shaded = torch.where(lit, term, 0.0)
        out.append(torch.where(hit, shaded, ts.background[k]))
    return torch.stack(out, dim=1)


def _winner_mt(g, o, dd):
    """(t, u, v) of each ray against its own row `g` (P,12), t unmasked."""
    ox, oy, oz = o
    dx, dy, dz = dd
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (g[:, k] for k in range(9))
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
    return t, u, v
