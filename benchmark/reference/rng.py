"""The renderer's random streams, written out again: threefry2x32 keys as
`jax.random.PRNGKey` / `fold_in` / `bits` make them (the partitionable
layout), and the lowbias32 hash draw of the path kernel. Integer
arithmetic throughout, so the draws are exact in any float `dtype` up to
the final conversion to a uniform."""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block on uint32 arrays."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def sample_seeds(seed: int, n: int) -> np.ndarray:
    """(n,) int32: the 32-bit seed of samples 0..n-1 of a frame rendered
    under the integer `seed`, bits(fold_in(PRNGKey(seed), s))."""
    key = (np.uint32(0), np.uint32(int(seed) & M32))
    data = np.arange(n, dtype=np.uint32)
    y0, y1 = threefry2x32(key[0], key[1], np.zeros_like(data), data)
    zero = np.zeros_like(data)
    b0, b1 = threefry2x32(y0, y1, zero, zero)
    return (b0 ^ b1).view(np.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def lowbias32_uniform(seed: torch.Tensor, lane: torch.Tensor, ctr: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Two lowbias32 rounds keyed by (sample seed, pixel, draw counter),
    24 bits as a uniform in [0, 1) of `dtype`."""
    s = seed.to(torch.int64) & M32
    c = (_mul32(ctr.to(torch.int64) & M32, 0x85EBCA6B) + s) & M32
    c = c ^ (c >> 16)
    c = _mul32(c, 0x7FEB352D)
    c = c ^ (c >> 15)
    x = _mul32(lane.to(torch.int64) & M32, 0x9E3779B1) ^ c
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(dtype) * (1.0 / (1 << 24))
