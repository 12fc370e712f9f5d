"""Geometric optics helpers (reference: src/Tools.cpp).

reflect / refract / fresnel / toWorld over batched (..., 3) tensors,
with the JAX package's formulas (Tools.cpp:250-327).
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """v / |v|, or 0 where |v| <= eps."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n > eps, v / torch.where(n > 0, n, 1.0), 0.0)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Tools::reflect (Tools.cpp:250-253): I - 2(I.N)N."""
    return i - 2.0 * (i * n).sum(dim=-1, keepdim=True) * n


def refract(i: torch.Tensor, n: torch.Tensor, ior) -> torch.Tensor:
    """Tools::refract (Tools.cpp:255-269); the 0-vector on total internal
    reflection (the reference's k < 0 branch). ior: (...,) or scalar."""
    cosi = torch.clamp((i * n).sum(dim=-1), -1.0, 1.0)
    ior = torch.broadcast_to(torch.as_tensor(ior, dtype=i.dtype, device=i.device),
                             cosi.shape)
    entering = cosi < 0
    etai = torch.where(entering, 1.0, ior)
    etat = torch.where(entering, ior, 1.0)
    nn = torch.where(entering[..., None], n, -n)
    ci = cosi.abs()
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - ci * ci)
    out = eta[..., None] * i + (eta * ci - torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * nn
    return torch.where((k < 0)[..., None], 0.0, out)


def fresnel(i: torch.Tensor, n: torch.Tensor, ior) -> torch.Tensor:
    """Tools::fresnel (Tools.cpp:271-293): unpolarized reflectance, 1 on
    total internal reflection."""
    cosi = torch.clamp((i * n).sum(dim=-1), -1.0, 1.0)
    ior = torch.broadcast_to(torch.as_tensor(ior, dtype=i.dtype, device=i.device),
                             cosi.shape)
    exiting = cosi > 0
    etai = torch.where(exiting, ior, 1.0)
    etat = torch.where(exiting, 1.0, ior)
    sint = etai / etat * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=0.0))
    tir = sint >= 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=0.0))
    ci = cosi.abs()
    rs = (etat * ci - etai * cost) / (etat * ci + etai * cost)
    rp = (etai * ci - etat * cost) / (etai * ci + etat * cost)
    return torch.where(tir, 1.0, (rs * rs + rp * rp) / 2.0)


def to_world(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Tools::toWorld (Tools.cpp:315-327): worldRay = x*B + y*C + z*N with
    the reference's branch on |N.x| > |N.y|."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = nx.abs() > ny.abs()
    inv_a = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=1e-30))
    c_a = torch.stack([nz * inv_a, torch.zeros_like(nx), -nx * inv_a], dim=-1)
    inv_b = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=1e-30))
    c_b = torch.stack([torch.zeros_like(nx), nz * inv_b, -ny * inv_b], dim=-1)
    c = torch.where(use_x[..., None], c_a, c_b)
    b = torch.linalg.cross(c, n, dim=-1)
    return local[..., 0:1] * b + local[..., 1:2] * c + local[..., 2:3] * n
