"""Texture atlas packing (reference: TextureLoader.cpp:14-31).

Only the host-side packing is ported so far: `Scene.rt_geometry` stores
the packed atlas. The device fetch comes with the raster slice.
"""

from __future__ import annotations

import numpy as np


def pack_atlas(atlas_u8: np.ndarray) -> np.ndarray:
    """(K,Hm,Wm,3) u8 -> (K,Hm,Wm) i32 with texel r|g<<8|b<<16."""
    a = np.asarray(atlas_u8).astype(np.int32)
    return a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16)
