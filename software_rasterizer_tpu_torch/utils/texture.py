"""Texture loading and the reference's nearest-texel fetch semantics.

The reference wraps cv::imread and fetches with clamp + truncation
(TextureLoader.cpp:14-31): ``x = int(clamp(u,0,1) * width)`` — note the
missing ``-1``, so ``u == 1.0`` indexes out of range and returns BLACK.
That quirk is preserved here (it is visible along texture seams).

No mipmaps, no bilinear filtering, no wrap modes — faithful to the
reference (SURVEY.md section 2.5). Colors are RGB in [0,1] (the reference
keeps OpenCV BGR end-to-end, which cancels out at display time; we use RGB
end-to-end which cancels identically).
"""

from __future__ import annotations

import numpy as np


def _decode_image(path: str) -> np.ndarray:
    """Decode an image file to (H,W,3) uint8 RGB. Tries PIL then imageio."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except ImportError:
        pass
    try:
        import imageio.v3 as iio

        arr = np.asarray(iio.imread(path))
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        return arr
    except ImportError as e:
        raise RuntimeError(f"No image decoder available for {path}") from e


class Texture:
    """Device-friendly texture: float32 RGB grid plus fetch helpers."""

    def __init__(self, data: np.ndarray, path: str = ""):
        if data.dtype == np.uint8:
            data = data.astype(np.float32) / 255.0
        self.data = np.ascontiguousarray(data, dtype=np.float32)  # (H,W,3)
        self.height, self.width = self.data.shape[:2]
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Texture":
        return cls(_decode_image(path), path=path)

    def fetch(self, uv: np.ndarray) -> np.ndarray:
        """Vectorized reference-faithful nearest fetch.

        uv: (..., 2) in any range. Returns (..., 3) float32 RGB in [0,1].
        Matches TextureLoader::getTextureColor exactly: clamp to [0,1],
        truncate to texel index, and return black when the index lands
        exactly on width/height (the u==1 or v==1 edge).
        """
        uv = np.asarray(uv, np.float32)
        u = np.clip(uv[..., 0], 0.0, 1.0)
        v = np.clip(uv[..., 1], 0.0, 1.0)
        x = (u * self.width).astype(np.int32)
        y = (v * self.height).astype(np.int32)
        oob = (x >= self.width) | (y >= self.height)
        xs = np.minimum(x, self.width - 1)
        ys = np.minimum(y, self.height - 1)
        out = self.data[ys, xs]
        out = np.where(oob[..., None], np.zeros(3, np.float32), out)
        return out
