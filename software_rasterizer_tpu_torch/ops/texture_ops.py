"""Texture atlas packing and the nearest-texel fetch (reference:
TextureLoader.cpp:14-31).

`pack_atlas` is the host-side packing `Scene.rt_geometry` stores;
`fetch_nearest` is the device fetch, with clamp-truncate semantics and
the u == 1 / v == 1 -> black quirk. The JAX package's one-hot
`_small_table_rows` works around the cost of a TPU gather; here a small
table is indexed directly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def pack_atlas(atlas_u8: np.ndarray) -> np.ndarray:
    """(K,Hm,Wm,3) u8 -> (K,Hm,Wm) i32 with texel r|g<<8|b<<16."""
    a = np.asarray(atlas_u8).astype(np.int32)
    return a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16)


def fetch_nearest(atlas: torch.Tensor, tex_wh: torch.Tensor,
                  tex_id: torch.Tensor, uv: torch.Tensor,
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Texel colors (...,3) float32 of (K,Hm,Wm,3) u8 `atlas` at `uv`
    (...,2) in texture `tex_id` (...,) of extents `tex_wh` (K,2):
    uv clamped to [0,1], x = int(u*w), y = int(v*h); x >= w, y >= h or
    tex_id < 0 give black; texels are u8/255. With `packed` ((K,Hm,Wm)
    i32 from `pack_atlas`) the fetch is one word gather and an unpack,
    with the same texel values."""
    tid = torch.clamp(tex_id.long(), min=0)
    wh = tex_wh.long()[tid]
    w, h = wh[..., 0], wh[..., 1]
    u = torch.clamp(uv[..., 0], 0.0, 1.0)
    v = torch.clamp(uv[..., 1], 0.0, 1.0)
    x = (u * w.float()).long()
    y = (v * h.float()).long()
    oob = (x >= w) | (y >= h) | (tex_id < 0)
    xs = torch.minimum(x, w - 1)
    ys = torch.minimum(y, h - 1)
    if packed is not None:
        _, hm, wm = packed.shape
        word = packed.reshape(-1)[(tid * hm + ys) * wm + xs]
        out = torch.stack([(word & 255).float(), ((word >> 8) & 255).float(),
                           ((word >> 16) & 255).float()], dim=-1) / 255.0
    else:
        out = atlas[tid, ys, xs].float() / 255.0
    return torch.where(oob[..., None], 0.0, out)
