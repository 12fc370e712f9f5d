"""Random streams of the integrators, bit for bit.

Host NumPy twins of the JAX key chain (threefry2x32 with
`jax_threefry_partitionable=True`, JAX 0.9.0's default) on a (2,) uint32
key, and the per-lane hash draws of the kernels on int64 tensors:

  * `prng_key`, `fold_in`, `split`, `key_bits`: `jax.random.PRNGKey`,
    `fold_in`, `split` and `bits(key, (), uint32)`;
  * `sample_seeds`: one 32-bit seed per sample,
    `key_bits(fold_in(prng_key(seed), s))`, the camera kernel's operand;
  * `lowbias32_uniform`: the camera kernel's draw
    (`pallas_path._RngDyn.uniform`, two hash rounds);
  * `bounce_uniform`: the bounce kernel's draw (`pallas_path._Rng.uniform`,
    one round over lane * 0x9E3779B1 ^ (seed + ctr * 0x85EBCA6B));
  * `lane_uniforms`: the JAX package's `utils/rng.lane_uniforms` (one
    round over rid ^ key_bits(fold_in(key, salt))).

The JAX pipelines default to `make_key`'s `rbg` key, whose bits depend
on the backend; the port matches the JAX side run with
`jax.random.PRNGKey` keys (`SRT_PRNG_IMPL=threefry2x32`).
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


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a seed that fits 32 bits: the
    (2,) uint32 key (0, seed mod 2^32)."""
    return np.array([0, int(seed) & _M32], np.uint32)


def as_key(key) -> np.ndarray:
    """A (2,) uint32 key from a key or an integer seed."""
    if np.ndim(key) == 0:
        return prng_key(int(key))
    key = np.asarray(key)
    if key.shape != (2,):
        raise ValueError(f"a key is an int or a (2,) uint32 array, got {key.shape}")
    return key.astype(np.uint32)


def fold_in(key, data) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: threefry(key, (0, data mod 2^32)).
    `data` may be an array; the keys then stack on the leading axes."""
    key = as_key(key)
    data = (np.asarray(data, np.int64) & _M32).astype(np.uint32)
    y0, y1 = threefry2x32(key, np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)


def split(key, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: (n, 2) keys, key i = threefry(key,
    (0, i)) (the partitionable layout)."""
    return fold_in(key, np.arange(n, dtype=np.int64))


def key_bits(key) -> np.ndarray:
    """`jax.random.bits(key, (), uint32)`: y0 ^ y1 of threefry(key,
    (0, 0)) (the partitionable layout). A (..., 2) stack of keys gives
    (...,) words."""
    key = np.asarray(key, np.uint32)
    zero = np.zeros(key.shape[:-1], np.uint32)
    y0, y1 = threefry2x32((key[..., 0], key[..., 1]), zero, zero)
    return np.asarray(y0 ^ y1, np.uint32)


def sample_seeds(seed, start_sample: int, n: int) -> np.ndarray:
    """(n,) int32 per-sample seeds for samples [start_sample, start_sample+n):
    `key_bits(fold_in(key, start_sample + s))`, bit for bit the `seeds`
    operand that the JAX package's `fused_path_camera_render` builds
    (ops/pallas_path.py:1261-1266). `seed` is an integer or a key."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    data = np.int64(start_sample) + np.arange(n, dtype=np.int64)
    return key_bits(fold_in(seed, data)).view(np.int32)


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
    return _finish(_mul32(ln, 0x9E3779B1) ^ c)


def _finish(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 finalizer of a 32-bit word held in int64, as a
    float32 in [0, 1) with 24 bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def bounce_uniform(seed: int, lane: torch.Tensor, ctr: int) -> torch.Tensor:
    """`_Rng.uniform` (ops/pallas_path.py:62-74): draw number `ctr`
    (counted from 1) of lane `lane` under the 32-bit `seed`."""
    word = ((int(seed) & _M32) + ((int(ctr) * 0x85EBCA6B) & _M32)) & _M32
    return _finish(_mul32(lane.to(torch.int64) & _M32, 0x9E3779B1) ^ word)


def hash_uniform(rid: torch.Tensor, seed: int) -> torch.Tensor:
    """One lowbias32 round of rid ^ seed as a float32 in [0, 1): `rid` an
    integer tensor read as uint32 (negative and wrapped ids are fine),
    `seed` a 32-bit word."""
    return _finish((rid.to(torch.int64) & _M32) ^ (int(seed) & _M32))


def lane_uniforms(key, rid: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Per-lane uniforms in [0, 1) keyed by the ray's stable identity
    `rid`, bit for bit the JAX package's `utils/rng.lane_uniforms`:
    `hash_uniform` under key_bits(fold_in(key, salt))."""
    return hash_uniform(rid, int(key_bits(fold_in(key, salt))))
