"""Kernel #8, `trace_nearest_mm` (the port of the JAX package's unculled
chunked sweep `ops/pallas_trace.trace_nearest_mm` / `_trace_kernel`), on
the CPU through its plain version.

Inputs are the sorted triangle soups of tests/test_torch_trace_tiers.py
(invalid rows, an empty chunk, a ray count that is no multiple of the
block, rays with zero direction components).

Rules.
  * `trace_nearest_mm_plain` equals the port's unculled
    `trace_nearest_vpu_plain` over the whole table bit for bit in (hit,
    idx, t), at every chunk and block size: the same Moller-Trumbore
    expressions, rows in ascending order under a strict `<`.
  * Against the JAX kernel in interpret mode (the 13-feature bilinear
    matmul at HIGHEST precision, ~5e-7 absolute error on u*det): hit and
    idx equal, bar rays proven in float64 to be ties or to sit on an
    acceptance threshold (`torch_scenes.mt_knife_edge_rays`); at most 0.5%
    of the rays may need that proof. Where idx agrees on a hit, t agrees
    within rtol=1e-5 (t = (e2.q) / det on one side, the matmul's t'/det on
    the other).
  * `nearest_hit(backend="mm")` takes it by name (tests/test_torch_intersect.py).
"""

import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops import pallas_trace as jpt
from software_rasterizer_tpu_torch.ops import trace_kernel as tk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from test_torch_trace_tiers import CASES, _case, _jax_operands, _torch_operands
from torch_scenes import mt_knife_edge_rays

T_RTOL = 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name):
    table, _, _, orig, d = _torch_operands(name)
    launches = tt.LAUNCHES_MM
    got = tt.trace_nearest_mm(table, orig, d)
    assert tt.LAUNCHES_MM == launches            # CPU tensors: the plain version
    n = orig.shape[0]
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int64
    assert got[2].dtype == torch.float32 and got[2].shape == (n,)
    ref = tk.trace_nearest_vpu_plain(table, table.shape[0], orig, d)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    _, coef, _, _, jo, jd = _jax_operands(name)
    w_hit, w_idx, w_t = (np.asarray(x) for x in jpt.trace_nearest_mm(
        coef, jo, jd, chunk=512, block=128, interpret=True))
    g_hit, g_idx, g_t = (x.numpy() for x in got)
    same = g_idx == w_idx
    assert same.mean() >= 0.995, int((~same).sum())
    edge = mt_knife_edge_rays(table.numpy(), orig.numpy(), d.numpy(), g_idx, w_idx)
    assert edge[~same].all(), np.flatnonzero(~same & ~edge)
    assert np.array_equal(g_hit[same], w_hit[same])
    both = same & g_hit
    assert both.mean() > 0.05
    np.testing.assert_allclose(g_t[both], w_t[both], rtol=T_RTOL)
    valid = _case(name)[3]
    assert valid[g_idx[g_hit]].all()             # no invalid row wins


def test_every_chunk_and_block_gives_the_same():
    table, _, _, orig, d = _torch_operands("160 chunks of 16")
    ref = tk.trace_nearest_vpu_plain(table, table.shape[0], orig, d)
    for chunk, block in ((16, 32), (48, 96), (512, 2048), (400, 128)):
        got = tt.trace_nearest_mm(table, orig, d, chunk=chunk, block=block)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), (chunk, block)


def test_no_rays_and_bad_operands():
    table, _, _, orig, d = _torch_operands("300 in chunks of 64")
    hit, idx, t = tt.trace_nearest_mm(table, orig[:0], d[:0])
    assert hit.shape == idx.shape == t.shape == (0,)
    empty = tt.trace_nearest_mm(table[:0], orig, d)
    assert not empty[0].any() and (empty[1] == -1).all() and (empty[2] == 1e30).all()
    with pytest.raises(ValueError, match="multiple of 32"):
        tt.trace_nearest_mm(table, orig, d, block=100)
    with pytest.raises(ValueError, match="needs CUDA"):
        tt.launch_trace_unculled(table, orig, d, 2048)
    with pytest.raises(ValueError, match="chunk=1024"):
        tt.trace_nearest_mm_plain(torch.zeros((2048, 12)), orig, d, chunk=1024)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_equals_plain_and_kernel_2(card):
    table, _, _, orig, d = (x.to(card) for x in _torch_operands("1100 chunks of 16"))
    want = tk.trace_nearest_vpu(table, table.shape[0], orig, d)
    for block in (32, 256, 2048):
        launches = tt.LAUNCHES_MM
        got = tt.trace_nearest_mm(table, orig, d, block=block)
        assert tt.LAUNCHES_MM == launches + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want)), block
    plain = tt.trace_nearest_mm_plain(table, orig, d)
    assert all(torch.equal(a, b) for a, b in zip(plain, want))
