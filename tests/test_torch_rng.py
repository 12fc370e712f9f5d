"""The port's random streams against JAX, bit for bit.

`sample_seeds` must equal the per-sample seeds that the JAX camera
kernel derives from `jax.random.PRNGKey(seed)` (threefry2x32, JAX's
default partitionable layout), and `lowbias32_uniform` must equal the
kernel's `_RngDyn.uniform` draws. Both are integer hashes, so the
comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops.pallas_path import _RngDyn
from software_rasterizer_tpu_torch.utils.rng import lowbias32_uniform, sample_seeds


@pytest.mark.parametrize("seed", [0, 1, 42, -5, 2**31 - 1])
@pytest.mark.parametrize("start", [0, 3, 64, 100003])
def test_sample_seeds_match_threefry(seed, start):
    n = 7
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.vmap(
        lambda s: jax.random.bits(jax.random.fold_in(key, s), (), jnp.uint32)
    )(jnp.asarray(start, jnp.int32) + jnp.arange(n))).view(np.int32)
    got = sample_seeds(seed, start, n)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lowbias32_uniform_matches_rngdyn(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    s = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    lane = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    base = (rng.integers(0, 40, n) * 8).astype(np.int32)
    r = _RngDyn(jnp.asarray(s), jnp.asarray(lane), jnp.asarray(base))
    for i in range(8):
        want = np.asarray(r.uniform())
        got = lowbias32_uniform(torch.from_numpy(s), torch.from_numpy(lane),
                                torch.from_numpy(base) + i).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, want), i
