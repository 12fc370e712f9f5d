"""The port's random streams against JAX, bit for bit.

`sample_seeds` must equal the per-sample seeds that the JAX camera
kernel derives from `jax.random.PRNGKey(seed)` (threefry2x32, JAX's
default partitionable layout), and `lowbias32_uniform` must equal the
kernel's `_RngDyn.uniform` draws. The key chain (`prng_key`, `fold_in`,
`split`, `key_bits`) must equal `jax.random`'s key data and bits,
`lane_uniforms` the JAX package's, and `bounce_uniform` the bounce
kernel's `_Rng.uniform`. All are integer hashes, so every comparison is
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from software_rasterizer_tpu.ops.pallas_path import _Rng, _RngDyn
from software_rasterizer_tpu.utils.rng import lane_uniforms as jlane_uniforms
from software_rasterizer_tpu_torch.utils import rng
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


# ---- the key chain and the one-round draws


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 1, 42, -5, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    assert np.array_equal(rng.prng_key(seed), np.asarray(_jkey(seed)))
    assert rng.prng_key(seed).dtype == np.uint32


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("data", [0, 1, 16, 100003, 2**31 - 1, -1])
def test_fold_in_matches_jax(seed, data):
    jdata = jnp.asarray(data, jnp.int32)     # a negative word wraps
    want = np.asarray(jax.random.fold_in(_jkey(seed), jdata))
    assert np.array_equal(rng.fold_in(seed, data), want)
    # a key goes in as well as a seed, and folds chain
    k2 = rng.fold_in(rng.fold_in(rng.prng_key(seed), data), 3)
    assert np.array_equal(
        k2, np.asarray(jax.random.fold_in(jax.random.fold_in(_jkey(seed), jdata), 3)))


@pytest.mark.parametrize("seed", [0, 7, 123456])
@pytest.mark.parametrize("n", [1, 2, 3, 17])
def test_split_matches_jax(seed, n):
    assert np.array_equal(rng.split(seed, n),
                          np.asarray(jax.random.split(_jkey(seed), n)))


@pytest.mark.parametrize("seed", [0, 7, 123456, 2**31 - 1])
def test_key_bits_matches_jax(seed):
    k = jax.random.fold_in(_jkey(seed), 5)
    want = int(jax.random.bits(k, (), jnp.uint32))
    assert int(rng.key_bits(np.asarray(k))) == want
    # a stack of keys gives a stack of words
    ks = rng.split(seed, 4)
    words = rng.key_bits(ks)
    assert words.shape == (4,) and words.dtype == np.uint32
    assert [int(w) for w in words] == [
        int(jax.random.bits(jnp.asarray(k), (), jnp.uint32)) for k in ks]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), data=st.integers(0, 2**31 - 1),
       n=st.integers(1, 5))
def test_key_chain_matches_jax_property(seed, data, n):
    jk = jax.random.fold_in(_jkey(seed), data)
    k = rng.fold_in(seed, data)
    assert np.array_equal(k, np.asarray(jk))
    assert np.array_equal(rng.split(k, n), np.asarray(jax.random.split(jk, n)))
    assert int(rng.key_bits(k)) == int(jax.random.bits(jk, (), jnp.uint32))


def test_as_key_rejects_other_shapes():
    with pytest.raises(ValueError, match="a key is"):
        rng.as_key(np.zeros(3, np.uint32))


@pytest.mark.parametrize("seed,salt", [(0, 0), (3, 1), (42, 15)])
def test_lane_uniforms_match_jax(seed, salt):
    g = np.random.default_rng(seed)
    # negative ids and ids that wrapped through 2 * rid + 2 in int32
    rid = g.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    with np.errstate(over="ignore"):
        rid[::3] = rid[::3] * np.int32(2) + np.int32(2)
    want = np.asarray(jlane_uniforms(_jkey(seed), jnp.asarray(rid), salt))
    got = rng.lane_uniforms(seed, torch.from_numpy(rid), salt).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert (got >= 0).all() and (got < 1).all()
    # the same words held in int64 (as the Whitted plain version keeps them)
    got64 = rng.lane_uniforms(
        seed, torch.from_numpy(rid.astype(np.int64) & 0xFFFFFFFF), salt).numpy()
    assert np.array_equal(got64, want)


@pytest.mark.parametrize("seed", [0, -7, 2**31 - 1])
def test_bounce_uniform_matches_rng(seed):
    lane = np.arange(5000, dtype=np.int32) * 211
    r = _Rng(jnp.asarray(seed, jnp.int32), jnp.asarray(lane))
    for ctr in range(1, 26):
        want = np.asarray(r.uniform())
        got = rng.bounce_uniform(seed, torch.from_numpy(lane), ctr).numpy()
        assert np.array_equal(got, want), ctr
