"""Rasterization of chosen pixels of a frame (SoftRasterizer's
Rasterizer.cpp with the deferred shading of Shader.cpp), brute force over
every triangle.

Vertex stage: screen * projection * view * model with the divide, z
remapped by (far - near) / 2 and (far + near) / 2, normals through the
inverse transpose of the model with vec4(n, 1) and the divide. Faces
whose screen-space normal points along the eye position are culled. A
pixel at integer (x, y) is inside a triangle where its three barycentrics
lie strictly in (0, 1); the least z wins, the lowest triangle on a tie.
The winner's normal, uv and colour are interpolated by the barycentrics
and the pixel is shaded by its mesh's shader (NORMAL: (n + 1) / 2;
TEXTURE and PHONG: Blinn-Phong summed over the lights with the static
ka / ks / exponent, the 2-D light distance and the texel or vertex
colour as kd and payload); uncovered pixels are 0. BUMP and DISPLACEMENT
shaders are outside this reference's scope and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.scene import check_scope, hom_transform

NORMAL, TEXTURE, PHONG = 0, 1, 2
KA, KS, P_EXP = 0.005, 0.7937, 150.0


def raster_tables(inputs: dict, dtype=torch.float32, device="cpu"):
    """Per-face (F,) setup of the frame: coefficient rows of alpha, beta
    and z as affine functions of (x, y, 1), the cull mask, per-corner
    normals, uvs, colours, the shader and texture of each face."""
    check_scope(inputs)
    meshes = inputs["meshes"]

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    screen = inputs["ndc"] @ inputs["projection"] @ inputs["view"]
    mvp = np.stack([screen @ m["model"] for m in meshes])
    nmat = np.stack([np.linalg.inv(m["model"]).T.astype(np.float32) for m in meshes])
    vmesh = t(np.concatenate([np.full(m["vertices"].shape[0], i)
                              for i, m in enumerate(meshes)]), torch.int64)
    pos = hom_transform(t(mvp)[vmesh], t(np.concatenate([m["vertices"] for m in meshes])))
    near, far = inputs["near"], inputs["far"]
    z_scale = float(np.float32((far - near) / 2.0))
    z_offset = float(np.float32((far + near) / 2.0))
    pos = torch.cat([pos[:, :2], (pos[:, 2] * z_scale + z_offset)[:, None]], dim=1)
    nrm = hom_transform(t(nmat)[vmesh], t(np.concatenate([m["normals"] for m in meshes])))

    offs = np.cumsum([0] + [m["vertices"].shape[0] for m in meshes])
    faces = t(np.concatenate([m["faces"].astype(np.int64) + offs[i]
                              for i, m in enumerate(meshes)]), torch.int64)
    face_mesh = np.concatenate([np.full(m["faces"].shape[0], i)
                                for i, m in enumerate(meshes)])
    tri = pos[faces]
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    fn = torch.linalg.cross(e1, e2)
    fn = fn / torch.clamp(torch.sqrt((fn * fn).sum(dim=-1, keepdim=True)), min=1e-20)
    eye = t(np.asarray(inputs["eye"], np.float32))
    keep = (fn * eye).sum(dim=-1) <= 0

    ax, ay, bx, by, cx, cy = (tri[:, i, j] for i in range(3) for j in range(2))
    inv_d = 1.0 / ((bx - ax) * (cy - ay) - (by - ay) * (cx - ax))
    row_a = torch.stack([by - cy, cx - bx, bx * cy - cx * by], dim=-1) * inv_d[:, None]
    row_b = torch.stack([cy - ay, ax - cx, cx * ay - ax * cy], dim=-1) * inv_d[:, None]
    row_g = -row_a - row_b + t(np.asarray([0.0, 0.0, 1.0], np.float32))
    z = tri[:, :, 2]
    zrow = z[:, 0:1] * row_a + z[:, 1:2] * row_b + z[:, 2:3] * row_g

    shaders = [m["shader"] if m["shader"] is not None else PHONG for m in meshes]
    if set(shaders) - {NORMAL, TEXTURE, PHONG}:
        raise NotImplementedError("NORMAL, TEXTURE and PHONG shaders only")
    textures = [m["texture"] for m in meshes]
    return {
        "row_a": row_a, "row_b": row_b, "zrow": zrow, "keep": keep,
        "nrm": nrm[faces], "uv": t(np.concatenate([m["uvs"] for m in meshes]))[faces],
        "col": t(np.concatenate([m["colors"] for m in meshes]))[faces],
        "shader": t(np.asarray(shaders)[face_mesh], torch.int64),
        "face_mesh": torch.as_tensor(face_mesh, device=device),
        "textures": textures, "eye": eye,
        "light_pos": t(inputs["lights"]["pos"]), "light_int": t(inputs["lights"]["int"]),
    }


def _normalize(v):
    n = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
    return torch.where(n > 0, v / torch.where(n > 0, n, 1.0), 0.0)


def _blinn_phong(eye, position, normal, kd, light_pos, light_int):
    n = _normalize(normal)
    pos = position[:, None, :]
    light_dir = light_pos - pos
    dxy = light_pos[..., :2] - pos[..., :2]
    att = torch.sqrt((dxy * dxy).sum(dim=-1))
    distribution = light_int / torch.clamp(att, min=1e-12)[..., None]
    la = KA * light_int
    cos_t = torch.clamp((n[:, None, :] * _normalize(light_dir)).sum(dim=-1), min=0.0)
    ld = cos_t[..., None] * kd[:, None, :] * distribution
    h = _normalize(light_dir + (eye - position)[:, None, :])
    cos_a = torch.clamp((n[:, None, :] * h).sum(dim=-1), min=0.0)
    ls = torch.pow(cos_a, P_EXP)[..., None] * KS * distribution
    return (la + ld + ls).sum(dim=-2) * kd


def _texel(texture: np.ndarray, uv, dtype):
    """Nearest texel of the (H,W,3) uint8 `texture` at uv (P,2): uv
    clamped to [0, 1], x = int(u * W), y = int(v * H), black at x = W or
    y = H."""
    h, w = texture.shape[:2]
    tex = torch.as_tensor(texture, device=uv.device)
    u = torch.clamp(uv[:, 0], 0.0, 1.0)
    v = torch.clamp(uv[:, 1], 0.0, 1.0)
    x = (u * w).long()
    y = (v * h).long()
    oob = (x >= w) | (y >= h)
    out = tex[torch.clamp(y, max=h - 1), torch.clamp(x, max=w - 1)].to(dtype) / 255.0
    return torch.where(oob[:, None], 0.0, out)


def render_pixels(tables: dict, width: int, pixels: torch.Tensor,
                  block: int = 1024) -> torch.Tensor:
    """Colour (P,3) of `pixels` (P,) int64 (row-major ids) from
    `raster_tables`."""
    ra, rb, zr, keep = tables["row_a"], tables["row_b"], tables["zrow"], tables["keep"]
    dt = ra.dtype
    pixels = pixels.to(ra.device)
    x = (pixels % width).to(torch.int32).to(dt)[:, None]
    y = (pixels // width).to(torch.int32).to(dt)[:, None]
    n = pixels.shape[0]
    inf = float("inf")
    bz = torch.full((n,), inf, dtype=dt, device=ra.device)
    bi = torch.full((n,), -1, dtype=torch.int64, device=ra.device)
    never = torch.iinfo(torch.int64).max
    for f0 in range(0, ra.shape[0], block):
        a, b, zz = ra[f0:f0 + block], rb[f0:f0 + block], zr[f0:f0 + block]
        alpha = x * a[None, :, 0] + y * a[None, :, 1] + a[None, :, 2]
        beta = x * b[None, :, 0] + y * b[None, :, 1] + b[None, :, 2]
        gamma = 1.0 - alpha - beta
        inside = ((alpha > 0) & (alpha < 1) & (beta > 0) & (beta < 1)
                  & (gamma > 0) & (gamma < 1) & keep[None, f0:f0 + block])
        z = x * zz[None, :, 0] + y * zz[None, :, 1] + zz[None, :, 2]
        score = torch.where(inside, z, inf)
        cz = score.amin(dim=1)
        cols = torch.arange(score.shape[1], device=score.device)[None]
        col = torch.where(score == cz[:, None], cols, never).amin(dim=1)
        better = cz < bz
        bz = torch.where(better, cz, bz)
        bi = torch.where(better, f0 + col, bi)

    covered = bi >= 0
    f = torch.clamp(bi, min=0)
    x, y = x[:, 0], y[:, 0]
    alpha = x * ra[f, 0] + y * ra[f, 1] + ra[f, 2]
    beta = x * rb[f, 0] + y * rb[f, 1] + rb[f, 2]
    gamma = 1.0 - alpha - beta

    def interp(name):
        c = tables[name][f]
        return alpha[:, None] * c[:, 0] + beta[:, None] * c[:, 1] + gamma[:, None] * c[:, 2]

    normal, uv, color = interp("nrm"), interp("uv"), interp("col")
    position = torch.stack([x, y, bz], dim=-1)
    eye, lp, li = tables["eye"], tables["light_pos"], tables["light_int"]
    shader = tables["shader"][f]
    out = torch.where((shader == NORMAL)[:, None], (_normalize(normal) + 1.0) / 2.0,
                      _blinn_phong(eye, position, normal, color, lp, li))
    mesh = tables["face_mesh"][f]
    for i, tex in enumerate(tables["textures"]):
        sel = covered & (mesh == i) & (shader == TEXTURE)
        if tex is None or not bool(sel.any()):
            continue
        kd = _texel(tex, uv[sel], dt)
        out[sel] = _blinn_phong(eye, position[sel], normal[sel], kd, lp, li)
    return torch.where(covered[:, None], out, 0.0)
