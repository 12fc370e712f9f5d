"""Fragment shaders (reference: include/shader/Shader.hpp, src/Shader.cpp).

The five shader types (Shader.hpp:32-38) as functions over fragment
batches. Quirks reproduced faithfully:

  * Blinn-Phong attenuation uses the 2-D (x,y-only) distance, and despite
    the "distanceSquared" name it is sqrt(dx^2+dy^2) (Shader.cpp:519-523);
  * shading positions are SCREEN-space fragment coords (x_px, y_px,
    z_remapped) while light positions stay world-space, faithful to the
    raster pipeline feeding `point` straight from pixel coords
    (Rasterizer.cpp:282-326);
  * the shader's ka/ks/p/kh/kn are STATIC globals (Shader.cpp:7-12), not
    material properties;
  * final color multiplies by the payload color (Shader.cpp:542);
  * displacement/bump follow the scalar impls (Shader.cpp:446-507).

All functions take torch tensors and broadcast over arbitrary leading
batch dims.
"""

from __future__ import annotations

import enum

import torch

from software_rasterizer_tpu_torch.ops.texture_ops import fetch_nearest

# Static shader globals (Shader.cpp:7-12)
KA = 0.005
KS = 0.7937
P_EXP = 150.0
KH = 0.2
KN = 0.1


class ShaderType(enum.IntEnum):
    """SHADERS_TYPE (Shader.hpp:32-38)."""

    NORMAL = 0
    TEXTURE = 1
    PHONG = 2
    DISPLACEMENT = 3
    BUMP = 4


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1, keepdim=keepdim))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = _norm(v, keepdim=True)
    return torch.where(n > 0, v / torch.where(n > 0, n, 1.0), 0.0)


def blinn_phong(eye, position, normal, kd, payload_color, light_pos, light_int):
    """Shader::BlinnPhong (Shader.cpp:510-543), summed over lights.

    eye: (3,); position/normal/kd/payload_color: (...,3);
    light_pos/light_int: (L,3). Returns (...,3).
    """
    n = _normalize(normal)
    pos = position[..., None, :]          # (...,1,3)
    light_dir = light_pos - pos           # (...,L,3)
    # 2-D x/y-only attenuation, sqrt not square (Shader.cpp:519-523)
    dxy = light_pos[..., :2] - pos[..., :2]
    att = torch.sqrt((dxy * dxy).sum(dim=-1))              # (...,L)
    distribution = light_int / torch.clamp(att, min=1e-12)[..., None]
    la = KA * light_int                                    # (L,3) ambient
    cos_t = torch.clamp(
        (n[..., None, :] * _normalize(light_dir)).sum(dim=-1), min=0.0)
    ld = cos_t[..., None] * kd[..., None, :] * distribution
    v = eye - position                                     # (...,3)
    h = _normalize(light_dir + v[..., None, :])
    cos_a = torch.clamp((n[..., None, :] * h).sum(dim=-1), min=0.0)
    ls = torch.pow(cos_a, P_EXP)[..., None] * KS * distribution
    total = (la + ld + ls).sum(dim=-2)                     # sum over lights
    return total * payload_color


def shade_normal(normal):
    """NORMAL shader: (n_hat + 1)/2 (Shader.cpp:547-552)."""
    return (_normalize(normal) + 1.0) / 2.0


def shade_texture(eye, position, normal, uv, tex_id, atlas, tex_wh, light_pos, light_int):
    """TEXTURE shader (Shader.cpp:554-573): kd = payload color = texel."""
    kd = fetch_nearest(atlas, tex_wh, tex_id, uv)
    return blinn_phong(eye, position, normal, kd, kd, light_pos, light_int)


def shade_phong(eye, position, normal, color, light_pos, light_int):
    """PHONG shader (Shader.cpp:575-594): kd = payload color = vertex color."""
    return blinn_phong(eye, position, normal, color, color, light_pos, light_int)


def _tbn_perturbed_normal(normal, uv, tex_id, atlas, tex_wh):
    """Shared TBN finite-difference machinery of bump/displacement
    (Shader.cpp:446-507). Returns (new_normal, origin_norm)."""
    n = normal
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    denom = torch.sqrt(nx * nx + nz * nz)
    safe = torch.clamp(denom, min=1e-12)
    t = torch.stack([(nx * ny) / safe, denom, (nz * ny) / safe], dim=-1)
    b = torch.linalg.cross(n, t)
    # glm::mat3 TBN(t.x,b.x,n.x, t.y,b.y,n.y, t.z,b.z,n.z) fills COLUMNS,
    # so TBN*ln = (t.ln, b.ln, n.ln), the transpose of the conventional
    # TBN map. Reproduced exactly.
    wh = tex_wh[torch.clamp(tex_id.long(), min=0)].float()
    tw, th = wh[..., 0], wh[..., 1]
    c0 = fetch_nearest(atlas, tex_wh, tex_id, uv)
    origin_norm = _norm(c0)
    uv_u = torch.stack([(uv[..., 0] + 1.0) / tw, uv[..., 1]], dim=-1)
    uv_v = torch.stack([uv[..., 0], (uv[..., 1] + 1.0) / th], dim=-1)
    cu = fetch_nearest(atlas, tex_wh, tex_id, uv_u)
    cv = fetch_nearest(atlas, tex_wh, tex_id, uv_v)
    du = KH * KN * (_norm(cu) - origin_norm)
    dv = KH * KN * (_norm(cv) - origin_norm)
    ln = torch.stack([-du, -dv, torch.ones_like(du)], dim=-1)
    out = torch.stack([(t * ln).sum(dim=-1), (b * ln).sum(dim=-1),
                       (n * ln).sum(dim=-1)], dim=-1)
    return _normalize(out), origin_norm


def shade_bump(eye, position, normal, uv, tex_id, atlas, tex_wh, light_pos, light_int):
    """BUMP shader (Shader.cpp:621-640)."""
    kd = fetch_nearest(atlas, tex_wh, tex_id, uv)
    new_n, _ = _tbn_perturbed_normal(normal, uv, tex_id, atlas, tex_wh)
    return blinn_phong(eye, position, new_n, kd, kd, light_pos, light_int)


def shade_displacement(eye, position, normal, uv, tex_id, atlas, tex_wh, light_pos, light_int):
    """DISPLACEMENT shader (Shader.cpp:596-619): also moves the position
    along the normal by kn*|texel| (Shader.cpp:473-476)."""
    kd = fetch_nearest(atlas, tex_wh, tex_id, uv)
    new_n, origin_norm = _tbn_perturbed_normal(normal, uv, tex_id, atlas, tex_wh)
    new_pos = position + KN * normal * origin_norm[..., None]
    return blinn_phong(eye, new_pos, new_n, kd, kd, light_pos, light_int)


def shade_fragments(
    shader_type,
    eye,
    position,
    normal,
    uv,
    color,
    tex_id,
    atlas,
    tex_wh,
    light_pos,
    light_int,
    active_types=None,
):
    """Dispatch over the 5 shader types per fragment.

    shader_type: (...,) integer tensor. Each active shader is evaluated
    over the whole batch and selected per fragment, the counterpart of
    the reference's per-shader function-pointer dispatch
    (Shader.cpp:94-108).

    `active_types`: tuple of ShaderType values present in the scene;
    branches not listed are never evaluated (each texture-path branch
    costs several atlas gathers per pixel). None evaluates all five.
    """
    if active_types is None:
        active_types = tuple(int(t) for t in ShaderType)
    active = set(int(t) for t in active_types)

    def branch(t):
        if t == int(ShaderType.NORMAL):
            return shade_normal(normal)
        if t == int(ShaderType.TEXTURE):
            return shade_texture(eye, position, normal, uv, tex_id, atlas,
                                 tex_wh, light_pos, light_int)
        if t == int(ShaderType.DISPLACEMENT):
            return shade_displacement(eye, position, normal, uv, tex_id,
                                      atlas, tex_wh, light_pos, light_int)
        if t == int(ShaderType.BUMP):
            return shade_bump(eye, position, normal, uv, tex_id, atlas,
                              tex_wh, light_pos, light_int)
        return shade_phong(eye, position, normal, color, light_pos, light_int)

    types = sorted(active) or [int(ShaderType.PHONG)]
    st = shader_type[..., None]
    out = branch(types[0])
    for t in types[1:]:
        out = torch.where(st == t, branch(t), out)
    return out
