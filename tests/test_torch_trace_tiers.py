"""The plain PyTorch versions of the chunk-culled trace tiers against the
JAX package's Pallas kernels run in interpret mode (as
tests/test_intersect.py runs them on the CPU), against its XLA sweep
`_intersect_tri_raw(cull_chunks=False)`, and against the port's own
unculled `trace_nearest_vpu_plain`.

Both sides get the same seeded NumPy arrays: triangle soups spread along
x and sorted by it, so the chunk boxes are tight and the cull is real (300 triangles in
chunks of 64; 160 chunks of 16; 1100 chunks of 16, as the JAX tests take
them), with invalid rows, an empty chunk, rays in blocks of 128 sorted
along x, a ray count that is no multiple of the block, and rays with zero
direction components. On the CPU the
port's entry points run their plain versions.

Tolerances.
  * The cull mask, the lists and the counts are equal to the JAX
    package's, entry for entry: the slab test has one multiply and one
    subtract an axis, so FMA contraction has nothing to contract.
  * Each tier's plain version equals `trace_nearest_vpu_plain` over the
    whole table bit for bit in (hit, idx, t): the same expressions, and a
    conservative cull.
  * Against the JAX tiers (the 13-feature bilinear matmul at HIGHEST
    precision, ~5e-7 absolute error on u*det) and the XLA sweep (FMA
    contraction): hit and idx equal, bar rays proven in float64 to be ties
    or to sit on an acceptance threshold (`torch_scenes.mt_knife_edge_rays`);
    at most 0.5% of the rays may need that proof.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops import pallas_trace as jpt
from software_rasterizer_tpu.ops.intersect import _intersect_tri_raw as jraw
from software_rasterizer_tpu_torch.ops import trace_kernel as tk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops.intersect import mt_tri_table
from torch_scenes import mt_knife_edge_rays

BLOCK = 128
# name -> (seed, triangles, chunk, x spread, rays)
CASES = {
    "300 in chunks of 64": (3, 300, 64, 8.0, 500),
    "160 chunks of 16": (11, 16 * 160, 16, 40.0, 512),
    "1100 chunks of 16": (7, 16 * 1100, 16, 60.0, 384),
}
TIERS = {
    "mm2c": (tt.trace_nearest_mm2c, jpt.trace_nearest_mm2c, {}),
    "mm2": (tt.trace_nearest_mm2, jpt.trace_nearest_mm2, {}),
    "mm2 cull=False": (tt.trace_nearest_mm2, jpt.trace_nearest_mm2, {"cull": False}),
    "mm2s": (tt.trace_nearest_mm2_stream, jpt.trace_nearest_mm2_stream, {}),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """NumPy arrays of a case: v0, v1, v2, valid, orig, d, and the (F,12)
    table. Triangles spread along x and sorted by it (the stand-in for BVH
    leaf order); rays from below z, mostly along +z and sorted by x, so a
    ray block sees a part of the soup; the last three rays have zero
    direction components."""
    seed, f, chunk, spread, n = CASES[name]
    g = np.random.RandomState(seed)
    centers = g.rand(f, 1, 3) * np.array([spread, 2.0, 2.0]) - 1.0
    centers = centers[np.argsort(centers[:, 0, 0])]   # a chunk is a run along x
    tri = (centers + g.rand(f, 3, 3) * 0.4).astype(np.float32)
    valid = g.rand(f) > 0.05
    valid[2 * chunk:3 * chunk] = False                     # an empty chunk
    orig = (g.rand(n, 3) * np.array([spread, 1.0, 1.0])
            - np.array([0.0, 0.0, 4.0])).astype(np.float32)
    orig = orig[np.argsort(orig[:, 0])]      # a ray block is a run along x
    d = g.rand(n, 3) * 0.2 + np.array([0.0, 0.0, 1.0])
    d[-3:] = [[0, 0, 1], [0, 1, 0], [1, 0, 0]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    v = [np.ascontiguousarray(tri[:, k]) for k in range(3)]
    table = mt_tri_table(*(torch.from_numpy(a) for a in v),
                         torch.from_numpy(valid)).numpy()
    return (*v, valid, orig, d, table)


def _torch_operands(name):
    v0, v1, v2, valid, orig, d, table = _case(name)
    chunk = CASES[name][2]
    lo, hi = tt.chunk_bounds(*(torch.from_numpy(a) for a in (v0, v1, v2, valid)), chunk)
    return torch.from_numpy(table), lo, hi, torch.from_numpy(orig), torch.from_numpy(d)


def _jax_operands(name):
    v0, v1, v2, valid, orig, d, _ = _case(name)
    chunk = CASES[name][2]
    j = [jnp.asarray(a) for a in (v0, v1, v2, valid)]
    lo, hi = jpt.chunk_bounds(*j, chunk)
    return j, jpt.mt_tri_coef(*j), lo, hi, jnp.asarray(orig), jnp.asarray(d)


def _padded(orig, d, block):
    """The rays padded to whole blocks, as the JAX tiers pad them (o = 0,
    d = 1) before their prepass."""
    pad = (-orig.shape[0]) % block
    return (jnp.pad(orig, ((0, pad), (0, 0))),
            jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_cull_mask_and_lists_match_jax(name):
    table, lo, hi, orig, d = _torch_operands(name)
    _, _, jlo, jhi, jo, jd = _jax_operands(name)
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    launches = tt.LAUNCHES_CULL
    mask = tt.cull_prepass(lo, hi, orig, d, BLOCK)
    assert tt.LAUNCHES_CULL == launches          # CPU tensors: the plain version
    nb, nc = -(-orig.shape[0] // BLOCK), lo.shape[0]
    assert mask.shape == (nb, nc) and mask.dtype == torch.uint8
    n = orig.shape[0]
    whole = n // BLOCK                # blocks without padded rays
    want = np.asarray(jpt._cull_prepass(jlo, jhi, *_padded(jo, jd, BLOCK), BLOCK,
                                        interpret=True))
    assert np.array_equal(mask.numpy()[:whole].astype(bool), want[:whole])
    # the JAX tiers pad a short last block with rays that may enter boxes;
    # the port's absent rays do not vote: its mask is the JAX one of the
    # block's own rays alone
    if whole < nb:
        tail = n - whole * BLOCK
        o_t = jnp.tile(jo[whole * BLOCK:], (-(-BLOCK // tail), 1))[:BLOCK]
        d_t = jnp.tile(jd[whole * BLOCK:], (-(-BLOCK // tail), 1))[:BLOCK]
        w_t = np.asarray(jpt._cull_prepass(jlo, jhi, o_t, d_t, BLOCK, interpret=True))
        assert np.array_equal(mask.numpy()[whole:].astype(bool), w_t)
        assert (mask.numpy()[whole:] <= want[whole:]).all()
    assert 0.0 < mask.float().mean() < 0.9       # the cull is real

    counts, lists = tt.chunk_lists(mask)
    ov = jnp.asarray(mask.numpy().astype(bool))
    pos = jnp.cumsum(ov.astype(jnp.int32), axis=1) - 1
    w_lists = np.zeros((nb, nc), np.int32)
    for b in range(nb):                          # pallas_trace.py's scatter, a row at a time
        tgt = np.where(np.asarray(ov[b]), np.asarray(pos[b]), nc)
        keep = tgt < nc
        w_lists[b, tgt[keep]] = np.arange(nc, dtype=np.int32)[keep]
    assert counts.dtype == lists.dtype == torch.int32
    assert np.array_equal(counts.numpy(), np.asarray(ov.sum(axis=1)))
    assert np.array_equal(lists.numpy(), w_lists)
    for b in range(nb):                          # ascending survivors first
        row = lists[b, :int(counts[b])].numpy()
        assert np.array_equal(row, np.flatnonzero(mask[b].numpy()))


def _winners_agree(table, orig, d, got, want):
    g_hit, g_idx = got[0].numpy(), got[1].numpy()
    w_hit, w_idx = np.asarray(want[0]), np.asarray(want[1])
    same = g_idx == w_idx
    assert same.mean() >= 0.995, int((~same).sum())
    edge = mt_knife_edge_rays(table, orig, d, g_idx, w_idx)
    assert edge[~same].all(), np.flatnonzero(~same & ~edge)
    assert np.array_equal(g_hit[same], w_hit[same])


# every tier on every case, bar the unculled interpret-mode sweep of 1100
# chunks (minutes on the CPU)
TIER_CASES = [(name, tier) for name in sorted(CASES) for tier in sorted(TIERS)
              if (name, tier) != ("1100 chunks of 16", "mm2 cull=False")]


@pytest.mark.parametrize("name,tier", TIER_CASES)
def test_plain_tier_matches_jax_tier_and_the_unculled_sweeps(name, tier):
    fn, jfn, kw = TIERS[tier]
    chunk = CASES[name][2]
    table, lo, hi, orig, d = _torch_operands(name)
    before = (tt.LAUNCHES_MM2C, tt.LAUNCHES_CULL, tt.LAUNCHES_MM2, tt.LAUNCHES_MM2S)
    got = fn(table, lo, hi, orig, d, chunk=chunk, block=BLOCK, **kw)
    assert before == (tt.LAUNCHES_MM2C, tt.LAUNCHES_CULL, tt.LAUNCHES_MM2,
                      tt.LAUNCHES_MM2S)          # CPU tensors: the plain versions
    n = orig.shape[0]
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int64
    assert got[2].dtype == torch.float32 and got[2].shape == (n,)

    # bit for bit the port's unculled kernel #2 (plain) over the whole table
    ref = tk.trace_nearest_vpu_plain(table, table.shape[0], orig, d)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert 0.05 < got[0].float().mean() < 1.0
    miss = ~got[0]
    assert (got[1][miss] == -1).all() and (got[2][miss] == 1e30).all()
    v0, v1, v2, valid = _case(name)[:4]
    assert valid[got[1][got[0]].numpy()].all()   # no invalid row wins

    # the JAX tier in interpret mode, and the JAX XLA sweep without a cull
    (j0, j1, j2, jvalid), coef, jlo, jhi, jo, jd = _jax_operands(name)
    want = jfn(coef, jlo, jhi, jo, jd, chunk=chunk, block=BLOCK, interpret=True, **kw)
    o_np, d_np = orig.numpy(), d.numpy()
    _winners_agree(table.numpy(), o_np, d_np, got, want)
    if tier == "mm2c":                           # once a case is enough
        _winners_agree(table.numpy(), o_np, d_np, got,
                       jraw(jo, jd, j0, j1, j2, jvalid, 64, cull_chunks=False))


def test_every_block_size_and_chunk_size_gives_the_same():
    name = "160 chunks of 16"
    table, _, _, orig, d = _torch_operands(name)
    v0, v1, v2, valid = (torch.from_numpy(a) for a in _case(name)[:4])
    ref = tk.trace_nearest_vpu_plain(table, table.shape[0], orig, d)
    for chunk, block in ((16, 32), (48, 96), (128, 2048), (256, 128)):
        lo, hi = tt.chunk_bounds(v0, v1, v2, valid, chunk)   # 48: a short last chunk
        for fn in (tt.trace_nearest_mm2c, tt.trace_nearest_mm2,
                   tt.trace_nearest_mm2_stream):
            got = fn(table, lo, hi, orig, d, chunk=chunk, block=block)
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), (chunk, block)


def test_listed_plain_follows_its_lists():
    """A block sweeps exactly the chunks its list names: with one chunk
    listed, only that chunk's triangles can win."""
    name = "300 in chunks of 64"
    table, lo, hi, orig, d = _torch_operands(name)
    nb, nc = -(-orig.shape[0] // BLOCK), lo.shape[0]
    counts = torch.ones(nb, dtype=torch.int32)
    lists = torch.zeros((nb, nc), dtype=torch.int32)
    lists[:, 0] = 1
    hit, idx, _ = tt.trace_listed_plain(table, counts, lists, orig, d, 64, BLOCK)
    assert hit.any() and ((idx[hit] >= 64) & (idx[hit] < 128)).all()
    only = torch.zeros_like(table)
    only[64:128] = table[64:128]
    ref = tk.trace_nearest_vpu_plain(only, table.shape[0], orig, d)
    assert torch.equal(idx, ref[1])
    # no chunk listed: every ray misses
    none = tt.trace_listed_plain(table, torch.zeros(nb, dtype=torch.int32), lists,
                                 orig, d, 64, BLOCK)
    assert not none[0].any() and (none[1] == -1).all() and (none[2] == 1e30).all()


def test_nan_ray_misses_and_does_not_vote():
    table, lo, hi, orig, d = _torch_operands("300 in chunks of 64")
    orig, d = orig[:64].clone(), d[:64].clone()
    base = tt.cull_prepass(lo, hi, orig, d, 64)
    d[5, 0] = float("nan")
    keep = torch.ones(64, dtype=torch.bool)
    keep[5] = False
    with_nan = tt.cull_prepass(lo, hi, orig, d, 64)
    alone = tt.cull_prepass(lo, hi, torch.cat([orig[keep], orig[:1]]),
                            torch.cat([d[keep], d[:1]]), 64)
    assert torch.equal(with_nan, alone) and (with_nan <= base).all()
    for fn in (tt.trace_nearest_mm2c, tt.trace_nearest_mm2, tt.trace_nearest_mm2_stream):
        hit, idx, t = fn(table, lo, hi, orig, d, chunk=64, block=64)
        assert not hit[5] and idx[5] == -1 and t[5] == 1e30


def test_no_rays_and_bad_operands():
    table, lo, hi, orig, d = _torch_operands("300 in chunks of 64")
    for fn in (tt.trace_nearest_mm2c, tt.trace_nearest_mm2, tt.trace_nearest_mm2_stream):
        hit, idx, t = fn(table, lo, hi, orig[:0], d[:0], chunk=64, block=BLOCK)
        assert hit.shape == idx.shape == t.shape == (0,)
    assert tt.cull_prepass(lo, hi, orig[:0], d[:0], BLOCK).shape == (0, lo.shape[0])
    with pytest.raises(ValueError, match="multiple of 32"):
        tt.trace_nearest_mm2c(table, lo, hi, orig, d, chunk=64, block=100)
    with pytest.raises(ValueError, match="multiple of 32"):
        tt.cull_prepass(lo, hi, orig, d, 4096)
    with pytest.raises(ValueError, match="chunk=512"):
        tt.trace_nearest_mm2(table, lo, hi, orig, d, chunk=512, block=BLOCK)
    with pytest.raises(ValueError, match="chunk boxes"):
        tt.trace_nearest_mm2_stream(table, lo, hi, orig, d, chunk=32, block=BLOCK)
    with pytest.raises(TypeError, match="dtype"):
        tt.trace_nearest_mm2c(table, lo.double(), hi.double(), orig, d, chunk=64)
    with pytest.raises(ValueError, match="rays must be"):
        tt.trace_nearest_mm2c(table, lo, hi, orig, d[:5], chunk=64)
    with pytest.raises(TypeError, match="int32"):
        tt.trace_listed_plain(table, torch.zeros(2, dtype=torch.int64),
                              torch.zeros((2, 5), dtype=torch.int32), orig, d, 64, BLOCK)


@pytest.mark.parametrize("launch", ["cull", "listed", "fused"])
def test_launch_on_cpu_tensors_raises(launch):
    table, lo, hi, orig, d = _torch_operands("300 in chunks of 64")
    with pytest.raises(ValueError, match="CUDA tensors"):
        if launch == "cull":
            tt.launch_cull_prepass(lo, hi, orig, d, BLOCK)
        elif launch == "listed":
            counts, lists = tt.chunk_lists(tt.cull_prepass(lo, hi, orig, d, BLOCK))
            tt.launch_trace_listed(table, counts, lists, orig, d, 64, BLOCK)
        else:
            tt.launch_trace_fused_cull(table, lo, hi, *tt.super_bounds(lo, hi), orig, d,
                                       64, BLOCK)
