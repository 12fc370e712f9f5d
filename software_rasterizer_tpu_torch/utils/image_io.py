"""Image output.

The reference never writes frames to disk (display-only via cv::imshow,
Render.cpp:63). We replace the GUI loop with PNG output (SURVEY.md 7.4).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """Normalized [0,1] float -> u8, matching Tools::normalizedToRGB
    (clamp then scale by 255 and truncate, Tools.cpp:94-104)."""
    img = np.asarray(img)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H,W,3) image (u8, or float in [0,1]) as PNG.

    Tiny dependency-free encoder (zlib + stored scanlines) so frame output
    never depends on optional packages.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Read a PNG back to (H,W,3) u8 (for golden-image tests)."""
    from software_rasterizer_tpu_torch.utils.texture import _decode_image

    return _decode_image(path)
