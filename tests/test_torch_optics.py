"""The port's optics helpers and texel fetch against the JAX package's.

Inputs are random numpy vectors from fixed seeds, handed to both sides.
The optics results agree within 1e-6 (rtol and atol): both sides follow
the same formulas, but XLA's CPU backend may contract a multiply and an
add into one FMA and sums a norm in its own order, so the last bits of a
float32 may differ. Total internal reflection is forced on a share of
the refract/fresnel inputs (rays leaving a dense medium at grazing
angles). The texel fetch is integer indexing and a u8/255 divide on both
sides, so it must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops import optics as jopt
from software_rasterizer_tpu.ops.texture_ops import fetch_nearest as jfetch
from software_rasterizer_tpu_torch.ops import optics as topt
from software_rasterizer_tpu_torch.ops.texture_ops import fetch_nearest

TOL = 1e-6


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _inputs(seed=0, n=512):
    rng = np.random.default_rng(seed)
    i, nrm = _unit(rng, n), _unit(rng, n)
    # the second half leaves glass (I.N > 0) at a grazing angle: TIR
    tir = slice(n // 2, n)
    i[tir] = nrm[tir] * 0.2 + _unit(rng, n - n // 2) * 0.05
    i[tir] += np.cross(nrm[tir], _unit(rng, n - n // 2))
    i /= np.linalg.norm(i, axis=-1, keepdims=True)
    ior = rng.uniform(1.1, 2.4, size=n).astype(np.float32)
    return i, nrm, ior


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_normalize():
    rng = np.random.default_rng(1)
    v = (rng.normal(size=(256, 3)) * 10.0 ** rng.uniform(-8, 3, (256, 1))).astype(np.float32)
    v[:8] = 0.0
    for eps in (0.0, 1e-20, 1e-3):
        _close(topt.normalize(torch.tensor(v), eps), jopt.normalize(jnp.asarray(v), eps))


def test_reflect():
    i, n, _ = _inputs(2)
    _close(topt.reflect(torch.tensor(i), torch.tensor(n)),
           jopt.reflect(jnp.asarray(i), jnp.asarray(n)))


@pytest.mark.parametrize("fn", ["refract", "fresnel"])
def test_refract_fresnel(fn):
    i, n, ior = _inputs(3)
    got = getattr(topt, fn)(torch.tensor(i), torch.tensor(n), torch.tensor(ior))
    want = np.asarray(getattr(jopt, fn)(jnp.asarray(i), jnp.asarray(n), jnp.asarray(ior)))
    _close(got, want)
    # both TIR branches are exercised: refract returns 0, fresnel 1
    tir = (want == 0.0).all(-1) if fn == "refract" else want == 1.0
    assert 0 < tir.sum() < len(tir)
    # a scalar ior broadcasts as in the JAX package
    _close(getattr(topt, fn)(torch.tensor(i), torch.tensor(n), 1.5),
           getattr(jopt, fn)(jnp.asarray(i), jnp.asarray(n), 1.5))


def test_to_world():
    rng = np.random.default_rng(4)
    local, n = _unit(rng, 512), _unit(rng, 512)
    n[:4] = [[0, 0, 1], [1, 0, 0], [0, 1, 0], [0.6, -0.8, 0]]
    _close(topt.to_world(torch.tensor(local), torch.tensor(n)),
           jopt.to_world(jnp.asarray(local), jnp.asarray(n)))


def test_fetch_nearest_exact():
    rng = np.random.default_rng(5)
    atlas = rng.integers(0, 256, size=(3, 7, 9, 3), dtype=np.uint8)
    wh = np.array([[9, 7], [4, 5], [2, 2]], np.int32)
    n = 600
    tex = rng.integers(-1, 3, size=n).astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, size=(n, 2)).astype(np.float32)
    uv[:20, 0] = 1.0           # the u == 1 -> black quirk
    uv[20:40, 1] = 1.0
    uv[40:60] = 0.0
    uv[60:80] = [0.5, 0.25]    # exact texel boundaries
    got = fetch_nearest(torch.tensor(atlas), torch.tensor(wh),
                        torch.tensor(tex), torch.tensor(uv))
    want = np.asarray(jfetch(jnp.asarray(atlas), jnp.asarray(wh),
                             jnp.asarray(tex), jnp.asarray(uv)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert (want[tex < 0] == 0).all() and (want[:20] == 0).all()
    assert (want[(tex >= 0) & (uv.min(-1) > 0) & (uv.max(-1) < 0.9)] != 0).any()
