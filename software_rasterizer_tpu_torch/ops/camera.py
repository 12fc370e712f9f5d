"""Camera ray generation (reference: RayTracing.cpp:52-58).

Quirk preserved: rays aim at the plane z=0 — dir = normalize((x,y,0)-eye)
with x/y from the fov/aspect mapping, fovy converted with glm::radians
here (unlike the raster projection path).
"""

from __future__ import annotations

import numpy as np
import torch


def camera_scale(fovy_deg: float) -> float:
    """tan(radians(fovy) / 2), rounded in float32 at every step as the
    JAX package computes it."""
    half = np.float32(np.float32(fovy_deg) * np.float32(np.pi / 180)) * np.float32(0.5)
    return float(np.tan(half, dtype=np.float32))


def camera_rays(eye, fovy_deg: float, width: int, height: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (origins (N,3), dirs (N,3)) float32 in row-major pixel order."""
    scale = camera_scale(fovy_deg)
    aspect = width / float(height)
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    x = (2.0 * (xx + 0.5) / width - 1.0) * aspect * scale
    y = (1.0 - 2.0 * (yy + 0.5) / height) * scale
    target = torch.stack([x, y, torch.zeros_like(x)], dim=-1).reshape(-1, 3)
    eye = torch.as_tensor(np.asarray(eye, np.float32), device=device)
    d = target - eye
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return eye.expand_as(d), d
