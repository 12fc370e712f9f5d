"""The device half of the port's `ops/bvh.py` against the JAX package's:
`slab_test`, `chunk_bounds` (the NumPy form of `ops/bvh.py` and the tensor
form of the trace tiers against `ops/pallas_trace.chunk_bounds`),
`bvh_nearest_leaf`, `bvh_nearest_hit` and `bvh_sample_area`.

Both sides get the same NumPy arrays (seeded) and the same tree
(`build_bvh` is bit-identical in the two packages,
tests/test_torch_scene.py). The JAX side walks one ray at a time under
`vmap`; the port steps all rays together over a stack, each ray taking
its own walk.

Tolerances: 0 for masks and indices; 1e-6 relative for t (XLA:CPU
contracts multiply-adds into FMAs, torch rounds every operation). The
triangles and rays are in general position, so no rounding decides a
comparison; the slab test is also held against a float64 oracle off the
entries where the interval's ends lie within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops import bvh as jb
from software_rasterizer_tpu.ops import pallas_trace as jpt
from software_rasterizer_tpu_torch.ops import bvh as tb
from software_rasterizer_tpu_torch.ops import trace_tiers as tt

T_RTOL = 1e-6


def _tris(seed, n, spread=10.0):
    g = np.random.default_rng(seed)
    base = g.uniform(-spread, spread, (n, 1, 3))
    return (base + g.normal(0, 0.4, (n, 3, 3))).astype(np.float32)


def _tree(tris):
    lo, hi = tb.primitive_bounds(tris[:, 0], tris[:, 1], tris[:, 2])
    return tb.build_bvh(lo, hi, tb.triangle_areas(tris[:, 0], tris[:, 1], tris[:, 2]))


def _jax_tree(bvh):
    return jb.FlatBVH(*(jnp.asarray(a) for a in bvh))


def _rays_at(tris, seed, n, start=-30.0):
    """Rays from a corner outside the soup towards points near triangle
    centroids (hits and near misses), the last four along an axis (zero
    components)."""
    g = np.random.default_rng(seed)
    orig = (np.full((n, 3), start) + g.normal(0, 1, (n, 3))).astype(np.float32)
    d = tris[g.integers(0, len(tris), n)].mean(axis=1) + g.normal(0, 0.1, (n, 3)) - orig
    d[-4:] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]]
    orig[-4:] = tris[:4].mean(axis=1) - 5.0 * d[-4:]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return orig, d


def test_slab_test_matches_jax_and_the_float64_oracle():
    g = np.random.default_rng(1)
    orig, d = _rays_at(_tris(0, 50), 2, 64, start=-8.0)
    lo = g.uniform(-6, 4, (32, 3)).astype(np.float32)
    hi = lo + g.uniform(0.5, 3, (32, 3)).astype(np.float32)
    lo[-1], hi[-1] = 1e30, -1e30                       # an empty chunk's box
    got = tb.slab_test(*(torch.from_numpy(a) for a in (orig, d, lo, hi)))
    want = np.asarray(jb.slab_test(*(jnp.asarray(a) for a in (orig, d, lo, hi))))
    assert got.dtype == torch.bool and got.shape == (64, 32)
    assert np.array_equal(got.numpy(), want)
    assert got.any() and not got.all()
    # float64, with the same stand-in for a zero component
    o64, d64 = orig.astype(np.float64), d.astype(np.float64)
    inv = 1.0 / np.where(d64 == 0.0, 1e-30, d64)
    t0 = (lo[None] - o64[:, None]) * inv[:, None]
    t1 = (hi[None] - o64[:, None]) * inv[:, None]
    tmin, tmax = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
    clear = np.abs(tmax - np.maximum(tmin, 0.0)) > 1e-5 * np.maximum(np.abs(tmax), 1.0)
    assert np.array_equal(got.numpy()[clear], (tmax >= np.maximum(tmin, 0.0))[clear])
    assert clear.mean() > 0.99


def test_slab_test_nan_ray_enters_no_box():
    lo, hi = torch.tensor([[-1.0, -1.0, -1.0]]), torch.tensor([[1.0, 1.0, 1.0]])
    orig = torch.tensor([[0.0, 0.0, -5.0]] * 3)
    d = torch.tensor([[0.0, 0.0, 1.0], [float("nan"), 0.0, 1.0], [0.0, 0.0, -1.0]])
    assert tb.slab_test(orig, d, lo, hi).flatten().tolist() == [True, False, False]


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunk_bounds_both_forms_match_jax(chunk):
    tris = _tris(3, 320)
    valid = np.random.default_rng(4).random(320) > 0.1
    valid[64:128] = False                    # an empty chunk at either size
    v = [tris[:, k] for k in range(3)]
    # the NumPy form of ops/bvh.py: inf boxes for empty chunks
    lo, hi = tb.chunk_bounds(*v, valid, chunk)
    wlo, whi = jb.chunk_bounds(*v, valid, chunk)
    assert np.array_equal(lo, wlo) and np.array_equal(hi, whi)
    assert lo.dtype == np.float32 and np.isinf(lo).any()
    # the tensor form of the trace tiers: 1e30 boxes, any F (300 pads to 320)
    for f in (320, 300):
        tlo, thi = tt.chunk_bounds(*(torch.from_numpy(a[:f]) for a in v),
                                   torch.from_numpy(valid[:f]), chunk)
        jlo, jhi = jpt.chunk_bounds(*(jnp.asarray(a[:f]) for a in v),
                                    jnp.asarray(valid[:f]), chunk)
        assert np.array_equal(tlo.numpy(), np.asarray(jlo))
        assert np.array_equal(thi.numpy(), np.asarray(jhi))
        assert tlo.shape == (-(-f // chunk), 3) and tlo.dtype == torch.float32
        assert (tlo == 1e30).any() and (thi == -1e30).any()


def test_super_bounds_cover_their_chunks():
    tris = _tris(5, 16 * 19)                             # 19 chunks: a short tail
    v = [torch.from_numpy(tris[:, k]) for k in range(3)]
    lo, hi = tt.chunk_bounds(*v, torch.ones(tris.shape[0], dtype=torch.bool), 16)
    lo2, hi2 = tt.super_bounds(lo, hi)
    assert lo2.shape == hi2.shape == (3, 3)
    for s in range(3):
        sl = slice(s * tt.MM2C_SUPER, (s + 1) * tt.MM2C_SUPER)
        assert torch.equal(lo2[s], lo[sl].amin(dim=0))
        assert torch.equal(hi2[s], hi[sl].amax(dim=0))


def test_flat_bvh_to_device():
    bvh = _tree(_tris(0, 20))
    dev = bvh.to("cpu")
    assert all(isinstance(a, torch.Tensor) for a in dev)
    assert dev.left.dtype == dev.prim.dtype == torch.int64
    assert dev.bb_min.dtype == dev.area.dtype == torch.float32
    for a, b in zip(bvh, dev):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_bvh_nearest_leaf_matches_jax():
    tris = _tris(0, 100)
    bvh = _tree(tris)
    orig, d = _rays_at(tris, 2, 96)
    got = tb.bvh_nearest_leaf(bvh.to("cpu"), torch.from_numpy(orig), torch.from_numpy(d))
    want = np.asarray(jb.bvh_nearest_leaf(_jax_tree(bvh), jnp.asarray(orig),
                                          jnp.asarray(d)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).mean() > 0.5


@pytest.mark.parametrize("n_tri", [100, 3000])
def test_bvh_nearest_hit_matches_jax_and_the_sweep(n_tri):
    tris = _tris(7, n_tri, spread=6.0)
    bvh = _tree(tris)
    orig, d = _rays_at(tris, 8, 128, start=-20.0)
    v = [torch.from_numpy(np.ascontiguousarray(tris[:, k])) for k in range(3)]
    to, td = torch.from_numpy(orig), torch.from_numpy(d)
    t, p = tb.bvh_nearest_hit(bvh.to("cpu"), *v, to, td)
    wt, wp = (np.asarray(a) for a in jb.bvh_nearest_hit(
        _jax_tree(bvh), *(jnp.asarray(tris[:, k]) for k in range(3)),
        jnp.asarray(orig), jnp.asarray(d)))
    assert p.dtype == torch.int64 and t.dtype == torch.float32
    assert np.array_equal(p.numpy(), wp)
    np.testing.assert_allclose(t.numpy(), wt, rtol=T_RTOL)
    assert (t.numpy()[wp < 0] == np.float32(1e30)).all()
    assert 0.3 < (wp >= 0).mean()
    # and the port's own unculled sweep over the same triangles
    from software_rasterizer_tpu_torch.ops.intersect import _intersect_tri_raw

    hit, idx, ts = _intersect_tri_raw(to, td, *v, torch.ones(n_tri, dtype=torch.bool),
                                      cull_chunks=False)
    assert torch.equal(idx, p) and torch.equal(hit, p >= 0)
    np.testing.assert_allclose(ts.numpy(), t.numpy(), rtol=T_RTOL)


def test_bvh_traversal_stack_overflow_raises():
    tris = _tris(0, 100)
    orig, d = _rays_at(tris, 2, 8)
    with pytest.raises(ValueError, match="max_depth=2"):
        tb.bvh_nearest_leaf(_tree(tris).to("cpu"), torch.from_numpy(orig),
                            torch.from_numpy(d), max_depth=2)


def test_bvh_sample_area_matches_jax():
    tris = _tris(9, 200)
    bvh = _tree(tris)
    u = np.random.default_rng(10).random(512).astype(np.float32)
    u[:2] = [0.0, np.float32(1.0 - 2.0 ** -24)]
    prim, pdf = tb.bvh_sample_area(bvh.to("cpu"), torch.from_numpy(u))
    wprim, wpdf = (np.asarray(a) for a in jb.bvh_sample_area(_jax_tree(bvh),
                                                            jnp.asarray(u)))
    assert prim.dtype == torch.int64 and pdf.shape == (512,)
    assert np.array_equal(prim.numpy(), wprim)
    np.testing.assert_allclose(pdf.numpy(), wpdf, rtol=T_RTOL)
    assert len(np.unique(wprim)) > 100          # the draws spread over the leaves
