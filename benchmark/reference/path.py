"""Monte-Carlo path tracing of chosen pixels of a camera frame
(SoftRasterizer's Scene::pathTracing, Scene.cpp:671-866), each pixel
rendering its samples back to back, brute force over every triangle.

Per sample: the camera ray aims at the z = 0 plane; a primary miss adds
the background once; at each live hit, next-event estimation toward a
point on an emitter's bounding sphere (sampleLight) accepted when the
shadow ray's nearest hit is emissive at |t^2 - d^2| <= 1e-4; Russian
roulette before a uniform hemisphere sample; an emissive shading point
adds its diffuse colour; an indirect hit on an emitter ends the path.
The draws are lowbias32 hashes keyed by (sample seed, pixel, depth * 8 +
slot) with one threefry seed per sample, so a pixel's samples are the
same numbers whichever pixels are rendered beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import rng
from reference.scene import BIG, camera_scale, nearest, norm3

INV_2PI = 0.15915494309189535
INV_PI = 0.3183098861837907
TWO_PI = 6.283185307179586
EPS = 1e-5


def _to_world(lx, ly, lz, nx, ny, nz):
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


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _surface(ts, t, row, u, v, want_kd: bool):
    """Interpolated normal, emission and (`want_kd`) diffuse colour of
    the nearest hits, zero on a miss."""
    hit = row >= 0
    f = torch.clamp(row, min=0)
    w = 1.0 - u - v
    n0, n1, n2 = ts.n0[f], ts.n1[f], ts.n2[f]
    nrm = tuple(torch.where(hit, w * n0[:, k] + u * n1[:, k] + v * n2[:, k], 0.0)
                for k in range(3))
    emit = tuple(torch.where(hit, ts.emit[f, k], 0.0) for k in range(3))
    kd = tuple(torch.where(hit, ts.kd[f, k], 0.0) for k in range(3)) if want_kd else None
    return t, nrm, kd, emit


def render_pixels(ts, seed: int, width: int, height: int, fovy: float, spp: int,
                  p_rr: float, max_bounces: int, pixels: torch.Tensor,
                  counts: dict = None) -> torch.Tensor:
    """Mean radiance (P,3) over `spp` samples of the pixels (P,) int64
    (row-major ids) of the frame rendered under the integer `seed`, in
    the dtype of `ts` (`reference.scene.trace_space`). `counts` gets the
    ray segments the frame needs at these pixels ("segments": camera
    rays, the shadow rays of next-event estimation where it can add
    light, and the bounce rays of the paths that go on), the (segment,
    triangle) tests of a brute-force tracer and the stage-1 passes
    among them."""
    if ts.n_emitters > 1 or ts.textured:
        raise NotImplementedError("one emitter and no texture in this reference")
    dev, dt = ts.device, ts.dtype
    n = pixels.shape[0]
    seeds = torch.as_tensor(rng.sample_seeds(seed, spp), device=dev)
    eye, bg = ts.eye, ts.background
    scale = camera_scale(fovy)
    aspect = float(np.float32(width / float(height)))
    n_e = ts.n_emitters
    any_e = n_e > 0
    n_e_f = float(max(n_e, 1))
    p_rr = float(np.float32(p_rr))
    ecr = ts.emitters

    lane = pixels.to(dev)
    py_i = lane // width
    px_i = lane - py_i * width
    cxp = (2.0 * (px_i.to(dt) + 0.5) / width - 1.0) * aspect * scale
    cyp = (1.0 - 2.0 * (py_i.to(dt) + 0.5) / height) * scale
    cd = norm3(cxp - eye[0], cyp - eye[1], 0.0 * cxp - eye[2])

    zero = torch.zeros(n, dtype=dt, device=dev)
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    next_s = torch.zeros(n, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    pos = nrm = kd = emit = col = tp = (zero, zero, zero)
    acc = [zero, zero, zero]
    segments = torch.zeros((), dtype=torch.int64, device=dev)

    def uniform(sseed, base, i):
        return rng.lowbias32_uniform(sseed, lane, base + i, dt)

    def sphere(sseed, base, i):
        z = 1.0 - 2.0 * uniform(sseed, base, i)
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = TWO_PI * uniform(sseed, base, i + 1)
        return r * torch.cos(phi), r * torch.sin(phi), z

    while bool((live | (next_s < spp)).any()):
        restart = ~live & (next_s < spp)
        local_s = torch.clamp(next_s - 1, min=0)
        sseed = seeds[torch.clamp(local_s, max=max(spp - 1, 0))]
        base = depth * 8
        nn = norm3(*nrm)

        # sampleLight (Scene.cpp:429-476): draws 0-4
        k_e = torch.clamp(torch.floor(uniform(sseed, base, 0) * n_e_f).to(torch.int64),
                          max=max(n_e - 1, 0))
        row = ecr[k_e]
        cc = (row[:, 0], row[:, 1], row[:, 2])
        crad = row[:, 3]
        bl = norm3(cc[0] - pos[0], cc[1] - pos[1], cc[2] - pos[2])
        sx, sy, sz = sphere(sseed, base, 1)
        flip = sx * bl[0] + sy * bl[1] + sz * bl[2] < 0
        sx, sy, sz = _where3(flip, (-sx, -sy, -sz), (sx, sy, sz))
        hx, hy, hz = sphere(sseed, base, 3)
        sx, sy, sz = norm3(sx + 1e-6 * hx, sy + 1e-6 * hy, sz + 1e-6 * hz)
        spx, spy, spz = cc[0] + sx * crad, cc[1] + sy * crad, cc[2] + sz * crad
        ll = norm3(spx - pos[0], spy - pos[1], spz - pos[2])
        cos_t = ll[0] * bl[0] + ll[1] * bl[1] + ll[2] * bl[2]
        pdf_l = cos_t * INV_2PI if any_e else torch.zeros_like(cos_t)

        # Russian roulette, then a uniform hemisphere direction: draws 5-7
        survive = uniform(sseed, base, 5) <= p_rr
        x1 = uniform(sseed, base, 6)
        x2 = uniform(sseed, base, 7)
        zl = (1.0 - 2.0 * x1).abs()
        rl = torch.sqrt(torch.clamp(1.0 - zl * zl, min=0.0))
        phi = TWO_PI * x2
        w = norm3(*_to_world(rl * torch.cos(phi), rl * torch.sin(phi), zl, *nn))
        wdn = w[0] * nn[0] + w[1] * nn[1] + w[2] * nn[2]
        cos_o = torch.clamp(wdn, min=0.0)
        pdf_b = torch.where(wdn > 0, INV_2PI, 0.0).to(dt)

        # the rays: the shadow ray of a live lane, and the bounce ray of a
        # live lane or the camera ray of a lane starting a sample
        cur_emissive = torch.sqrt(emit[0] * emit[0] + emit[1] * emit[1]
                                  + emit[2] * emit[2]) > EPS
        ldn = ll[0] * nn[0] + ll[1] * nn[1] + ll[2] * nn[2]
        pdf_ok_l = (pdf_l >= EPS) & (pdf_l < BIG) & (pdf_l == pdf_l)
        depth_n = depth + 1
        need_a = live & ~cur_emissive & pdf_ok_l & (ldn > 0) & any_e
        need_b = restart | (live & survive & (pdf_b >= EPS) & (depth_n < max_bounces))
        segments = segments + need_a.sum() + need_b.sum()
        o = tuple(torch.where(restart, eye[k], pos[k] + 1e-6 * nn[k]) for k in range(3))
        bd = _where3(restart, cd, w)
        orig = torch.stack(o, dim=1)
        tA, nA, _, eA = _surface(ts, *nearest(ts.tri, orig, torch.stack(ll, dim=1),
                                              counts=counts, need=need_a), False)
        tB, nB, kB, eB = _surface(ts, *nearest(ts.tri, orig, torch.stack(bd, dim=1),
                                               counts=counts, need=need_b), True)

        # next-event estimation (Scene.cpp:671-717)
        hit_a = tA < BIG
        sc = tuple(o[k] + ll[k] * tA for k in range(3))
        d3 = tuple(pos[k] - sc[k] for k in range(3))
        dist2 = d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]
        not_shadow = (tA * tA - dist2).abs() <= 1e-4
        lit = hit_a & (torch.sqrt(eA[0] * eA[0] + eA[1] * eA[1] + eA[2] * eA[2]) > EPS)
        if not any_e:
            lit = torch.zeros_like(lit)
        sn = norm3(*nA, 1e-20)
        cos_on = torch.clamp(nn[0] * ll[0] + nn[1] * ll[1] + nn[2] * ll[2], min=0.0)
        cos_ln = torch.clamp(-(sn[0] * ll[0] + sn[1] * ll[1] + sn[2] * ll[2]), min=0.0)
        denom = torch.where(pdf_ok_l, pdf_l, 1.0) * torch.clamp(dist2, min=1e-30)
        nee_s = torch.where(lit & not_shadow & pdf_ok_l & (ldn > 0),
                            cos_on * cos_ln / denom * INV_PI, 0.0)
        for k in range(3):
            direct = torch.where(cur_emissive, col[k], eA[k] * kd[k] * nee_s)
            acc[k] = acc[k] + torch.where(live, tp[k] * direct, 0.0)

        # a primary miss adds the background, once a sample
        hit_b = tB < BIG
        p_miss = restart & ~hit_b
        for k in range(3):
            acc[k] = acc[k] + torch.where(p_miss, bg[k], 0.0).to(dt)

        # the path goes on, or the lane starts its next sample
        emis_b = torch.sqrt(eB[0] * eB[0] + eB[1] * eB[1] + eB[2] * eB[2]) > EPS
        live_b = (live & survive & (pdf_b >= EPS) & hit_b & ~emis_b
                  & (depth_n < max_bounces))
        new_live = live_b | (restart & hit_b)
        wgt = torch.where(wdn > 0, cos_o / torch.clamp(pdf_b * p_rr, min=1e-30),
                          0.0) * INV_PI
        tp_n = tuple(torch.where(restart, 1.0, tp[k] * kd[k] * wgt) for k in range(3))
        pos_n = tuple(o[k] + bd[k] * tB for k in range(3))
        nrm_n = norm3(*nB, 1e-20)
        pos = _where3(new_live, pos_n, pos)
        nrm = _where3(new_live, nrm_n, nrm)
        kd = _where3(new_live, kB, kd)
        emit = _where3(new_live, eB, emit)
        col = _where3(new_live, kB, col)
        tp = _where3(new_live, tp_n, tp)
        live = new_live
        next_s = torch.where(restart, next_s + 1, next_s)
        depth = torch.where(restart, 0, depth_n)

    if counts is not None:
        counts["segments"] = counts.get("segments", 0) + segments
    return torch.stack(acc, dim=1) / float(spp)
