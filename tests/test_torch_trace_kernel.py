"""The plain PyTorch nearest-triangle trace against the JAX package's
`trace_nearest_vpu` run in interpret mode (the Pallas kernel on the CPU,
as the JAX package's own tests run it), and against its XLA winner
search `_intersect_tri_raw`.

Both sides get the same numpy arrays: Cornell's `tri_table` with camera
rays and with bounce rays leaving its surfaces, and a seeded soup of 300
triangles whose table has invalid (zeroed) rows in the middle and at the
tail. On the CPU the port's `trace_nearest_vpu` runs its plain version.

Tolerances. The two sides evaluate the same expressions, but XLA's CPU
backend contracts multiplies and adds into FMAs while torch rounds every
operation on its own, so the last bits of u, v and t differ and a ray on
a knife edge takes the other triangle. The rule per case: winners equal
on >= 99.5% of the rays; every differing ray is shown in float64 to be a
tie (two triangles at the same t) or to sit on an acceptance threshold
(`torch_scenes.mt_knife_edge_rays`); where the winners agree, t agrees
within rtol=1e-5, atol=1e-7 (one float32 ulp of the coordinates, which
are near 1) and the hit flags are equal. (A bounce ray that starts
on a surface can meet it again at a t of 1e-6 to 1e-5: that t is the
rounding noise of differences of numbers near 1, blown up by 1/det on a
grazing ray, so below t = 1e-3 the test only asks that both sides are
below 2e-3.) The
camera case is 64x64: the box's corner edges fall on the image
diagonals, and the pixels whose ray meets such an edge exactly are a
share of about 0.2 / width of the frame (11 of 4096 here, 5 of 576 at
24x24).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.intersect import _intersect_tri_raw
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.ops.pallas_trace import trace_nearest_vpu as jtrace
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu_torch.ops import trace_kernel as tk
from software_rasterizer_tpu_torch.ops.intersect import mt_tri_table
from software_rasterizer_tpu_torch.utils import cuda_build
from torch_scenes import mt_knife_edge_rays

WIN_SHARE, T_RTOL, T_SELF = 0.995, 1e-5, 1e-3


def _cornell(w=64, h=64):
    scene = jcornell()
    scene.set_ndc_matrix(w, h)
    rt = jprepare(scene.rt_geometry(), scene.rt_frame())
    orig, d = jcamera_rays(rt.eye, scene.fovy, w, h)
    return rt, np.asarray(orig), np.asarray(d)


def _case(name):
    """(tri_table (F,12), n_tri, orig (N,3), d (N,3)) as numpy arrays."""
    g = np.random.default_rng(5)
    if name.startswith("cornell"):
        rt, orig, d = _cornell()
        table, n_tri = np.array(rt.tri_table), int(rt.n_tri)
        if name == "cornell_bounce":
            # rays leaving the surfaces the camera sees, in seeded directions
            hit, _, t = tk.trace_nearest_vpu_plain(
                torch.from_numpy(table), n_tri, torch.from_numpy(orig),
                torch.from_numpy(d))
            keep = hit.numpy()
            orig = (orig + d * t.numpy()[:, None])[keep]
            d = g.normal(size=orig.shape).astype(np.float32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
        return table, n_tri, orig.astype(np.float32), d.astype(np.float32)
    # a soup of 300 small triangles; rows 100-119 and 280-299 invalid, so
    # the loop bound is 280 and zero rows lie inside it
    f = 300
    c = g.uniform(-1, 1, (f, 1, 3))
    v = (c + g.normal(scale=0.25, size=(f, 3, 3))).astype(np.float32)
    valid = np.ones(f, bool)
    valid[100:120] = valid[280:] = False
    table = mt_tri_table(*(torch.from_numpy(v[:, k]) for k in range(3)),
                         torch.from_numpy(valid)).numpy()
    n = 1000                                  # not a multiple of any block
    orig = g.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return table, 280, orig, d


def _check_winners(table, orig, d, got, want, share=WIN_SHARE):
    (g_hit, g_idx, g_t), (w_hit, w_idx, w_t) = got, want
    same = g_idx == w_idx
    assert same.mean() >= share, int((~same).sum())
    edge = mt_knife_edge_rays(table, orig, d, g_idx, w_idx)
    assert edge[~same].all(), np.flatnonzero(~same & ~edge)
    assert np.array_equal(g_hit[same], w_hit[same])
    far = same & (w_t > T_SELF)
    np.testing.assert_allclose(g_t[far], w_t[far], rtol=T_RTOL, atol=1e-7)
    assert (g_t[same & ~far] <= 2 * T_SELF).all()
    return same


@pytest.mark.parametrize("name", ["cornell_camera", "cornell_bounce", "soup"])
def test_plain_matches_pallas_interpret(name):
    table, n_tri, orig, d = _case(name)
    launches = tk.LAUNCHES
    hit, idx, t = tk.trace_nearest_vpu(torch.from_numpy(table), n_tri,
                                       torch.from_numpy(orig), torch.from_numpy(d))
    assert tk.LAUNCHES == launches            # CPU tensors: the plain version
    assert hit.dtype == torch.bool and idx.dtype == torch.int64
    assert t.dtype == torch.float32 and t.shape == (orig.shape[0],)
    w_hit, w_idx, w_t = jtrace(jnp.asarray(table), jnp.asarray(n_tri, jnp.int32),
                               jnp.asarray(orig), jnp.asarray(d), interpret=True)
    got = (hit.numpy(), idx.numpy(), t.numpy())
    want = (np.asarray(w_hit), np.asarray(w_idx), np.asarray(w_t))
    _check_winners(table, orig, d, got, want)
    # sentinels: a miss is index -1 and t = 1e30 on both sides
    miss = ~got[0]
    assert (got[1][miss] == -1).all() and (got[2][miss] == np.float32(1e30)).all()
    assert 0.05 < got[0].mean() <= 1.0        # the case has hits
    if name == "soup":
        assert miss.any() and not np.isin(got[1], np.r_[100:120, 280:300]).any()


def test_plain_matches_xla_winner_search():
    """Winners identical to `_intersect_tri_raw` on Cornell camera rays,
    bar proven ties."""
    rt, orig, d = _cornell()
    table, n_tri = np.asarray(rt.tri_table), int(rt.n_tri)
    hit, idx, t = tk.trace_nearest_vpu_plain(
        torch.from_numpy(table), n_tri, torch.from_numpy(orig), torch.from_numpy(d))
    w_hit, w_idx, w_t = _intersect_tri_raw(
        jnp.asarray(orig), jnp.asarray(d), rt.v0, rt.v1, rt.v2, rt.tri_valid)
    _check_winners(table, orig, d, (hit.numpy(), idx.numpy(), t.numpy()),
                   (np.asarray(w_hit), np.asarray(w_idx), np.asarray(w_t)))


def test_lowest_index_wins_a_tie_and_nan_misses():
    # two copies of one triangle: the lower row wins; a zero row between
    # them is rejected; a NaN ray misses
    tri = np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    v = np.stack([tri, np.zeros((3, 3), np.float32), tri])
    valid = np.array([True, False, True])
    table = mt_tri_table(*(torch.from_numpy(v[:, k]) for k in range(3)),
                         torch.from_numpy(valid))
    orig = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 0.0], [5.0, 5.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [float("nan"), 0.0, 1.0], [0.0, 0.0, 1.0]])
    hit, idx, t = tk.trace_nearest_vpu(table, 3, orig, d)
    assert hit.tolist() == [True, False, False]
    assert idx.tolist() == [0, -1, -1]
    assert float(t[0]) == 1.0 and float(t[1]) == float(t[2]) == np.float32(1e30)
    # a loop bound of 0 traces nothing
    assert not tk.trace_nearest_vpu(table, 0, orig, d)[0].any()


def test_bad_operands_raise():
    table = torch.zeros((4, 12))
    rays = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="expected \\(\\*, 12\\)"):
        tk.trace_nearest_vpu(torch.zeros((4, 9)), 4, rays, rays)
    with pytest.raises(ValueError, match="n_tri=5"):
        tk.trace_nearest_vpu(table, 5, rays, rays)
    with pytest.raises(TypeError, match="dtype"):
        tk.trace_nearest_vpu(table, 4, rays.double(), rays.double())
    with pytest.raises(ValueError, match="rays must be"):
        tk.trace_nearest_vpu(table, 4, rays, torch.zeros((4, 3)))


def test_launch_on_cpu_tensors_raises():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.launch_trace_nearest(torch.zeros((4, 12)), 4, torch.zeros((5, 3)),
                                torch.zeros((5, 3)))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tk.build_kernel()
