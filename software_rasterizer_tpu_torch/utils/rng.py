"""Random streams of the path kernel, bit for bit.

Two pieces, both reproducing what the JAX package's camera kernel
(`ops/pallas_path.fused_path_camera_render`) feeds and computes:

  * `sample_seeds`: one 32-bit seed per sample, a NumPy twin of
    `jax.random.bits(jax.random.fold_in(jax.random.PRNGKey(seed), s),
    (), jnp.uint32)` (threefry2x32 with `jax_threefry_partitionable=True`,
    JAX 0.9.0's default);
  * `lowbias32_uniform`: the kernel's per-lane hash draw
    (`pallas_path._RngDyn.uniform`) on int64 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block function on uint32 arrays (the
    same schedule as `jax._src.prng._threefry2x32_lowering`). `key` is
    a pair of uint32 scalars or arrays that broadcast against x0/x1."""
    k0 = np.asarray(key[0], np.uint32)
    k1 = np.asarray(key[1], np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl32(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def sample_seeds(seed: int, start_sample: int, n: int) -> np.ndarray:
    """(n,) int32 per-sample seeds for samples [start_sample, start_sample+n).

    Equals, bit for bit, the `seeds` operand that the JAX package's
    `fused_path_camera_render` builds from `jax.random.PRNGKey(seed)`
    (ops/pallas_path.py:1261-1266) under JAX 0.9.0's defaults:
      key  = PRNGKey(seed)                 -> (0, seed mod 2^32)
      k_s  = fold_in(key, start_sample+s)  -> threefry(key, (0, s'))
      bits = bits(k_s, (), uint32)         -> y0 ^ y1 of threefry(k_s, (0, 0))
    The last line is the `jax_threefry_partitionable=True` layout (the
    default), which XORs the two output words of counter (0, 0).

    The JAX pipelines default to `make_key`'s `rbg` key, whose bits
    depend on the backend; the port matches the JAX side run with
    `jax.random.PRNGKey` keys (`SRT_PRNG_IMPL=threefry2x32`).
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    key = (0, int(seed) & _M32)
    data = (np.int64(start_sample) + np.arange(n, dtype=np.int64)) & _M32
    zero = np.zeros(n, np.uint32)
    sample_key = threefry2x32(key, zero, data.astype(np.uint32))
    y0, y1 = threefry2x32(sample_key, zero, zero)
    return (y0 ^ y1).view(np.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split in 16-bit halves
    so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def lowbias32_uniform(seed: torch.Tensor, lane: torch.Tensor,
                      ctr: torch.Tensor) -> torch.Tensor:
    """`_RngDyn.uniform` (ops/pallas_path.py:911-931): two lowbias32
    rounds keyed by (sample seed, absolute lane, draw counter), as a
    float32 in [0, 1) with 24 bits. Arguments are integer tensors read
    as uint32 (negative values wrap); the hash runs in int64 so every
    value stays a non-negative 32-bit word."""
    s = seed.to(torch.int64) & _M32
    ln = lane.to(torch.int64) & _M32
    c = (_mul32(ctr.to(torch.int64) & _M32, 0x85EBCA6B) + s) & _M32
    c = c ^ (c >> 16)
    c = _mul32(c, 0x7FEB352D)
    c = c ^ (c >> 15)
    x = _mul32(ln, 0x9E3779B1) ^ c
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
