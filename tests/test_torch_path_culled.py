"""The chunk-culled tier of the path and Whitted kernels (the JAX camera
kernel's mm=True tier, ops/pallas_path.py:354, and the same per-ray walk
in the bounce and Whitted kernels), on the CPU through their plain
versions.

Scenes: the Cornell box tessellated by `torch_scenes.stress_cornell` at
levels=2 (576 triangles in a table of 640 rows, five chunks of the
scene's granule of 128 and 20 leaves of 32, so the boxes really cull),
and Cornell with a mirror and a glass sphere (36 triangles in one chunk,
with spheres).

Rules.
  * Culled against full sweep: equal lane for lane (`torch.equal`) for the
    camera kernel, the bounce kernel and the Whitted kernel. Both walks
    test their rows with the same expressions in the same order and the
    slab test is conservative, so only a wrong cull could make them
    differ. The culled walk must also make fewer (ray, row) tests.
  * Against the JAX camera kernel's mm=True tier in interpret mode
    (`_force_mm=True`, the A/B of tests/test_path_mm.py): the standing
    camera-kernel rule of tests/test_torch_path_kernel.py (>= 80% of lit
    lanes within rtol=1e-4, atol=1e-5, the sum over agreeing lanes within
    1e-4 relative). The JAX tier finds winners by its bilinear MXU form
    and recomputes (u, v, t) exactly; XLA contracts FMAs.
  * `pack_scene_tables`, the chunk boxes and the leaf boxes follow
    `tri_table`'s row order, so a chunk's rows are the chunk's triangles
    and a leaf's the leaf's; a leaf box holds its rows' box, a margin of
    `trace_tiers.LEAF_PAD` of the scene's extent wider; tables that do not
    cover the rows raise.
  * The kernels themselves (they run only on the card) are held against
    these plain versions by the `cuda`-marked test at the end and by
    chip_smoke.py phases 26-28.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.ops.intersect import RTScene as JRTScene
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.ops.pallas_path import fused_path_camera_render
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.scenes.stress import subdivide_mesh as jsubdivide
from software_rasterizer_tpu_torch.ops import path_kernel as pk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import (
    mt_tri_table,
    nearest_hit,
    rt_scene_from_numpy,
)
from software_rasterizer_tpu_torch.ops.path import path_render, path_trace, primary_state
from torch_scenes import mirror_glass_cornell, stress_cornell

W = 16
SPP, MAX_BOUNCES = 4, 6
LANE_RTOL, LANE_ATOL, LIT_SHARE, SUM_RTOL = 1e-4, 1e-5, 0.80, 1e-4
SCENES = {
    "stress_576": lambda: stress_cornell(jcornell, jsubdivide, 2),
    "mirror_glass": lambda: mirror_glass_cornell(jmodels, jcornell),
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(fovy, JAX RTScene arrays, port RTScene on the CPU)."""
    scene = SCENES[name]()
    scene.set_ndc_matrix(W, W)
    rt = jprepare(scene.rt_geometry(), scene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in rt._asdict().items()}
    return scene.fovy, arrays, rt_scene_from_numpy(arrays, "cpu")


def test_stress_scene_is_above_the_gate():
    _, arrays, rt = _scene("stress_576")
    assert rt.n_tri == 576 and rt.v0.shape[0] == 640
    assert rt.cull_chunk == 128 and rt.chunk_lo.shape == (5, 3)
    assert pk.use_cull(rt, None) and not pk.use_cull(rt, False)
    assert not pk.use_cull(_scene("mirror_glass")[2], None)
    assert pk.CULL_MIN_TRIS == 512


def test_tables_follow_the_tri_table_row_order():
    """Row f of `tri_table`, of `pack_scene_tables`' attr and of the
    Whitted attr is triangle f, and the chunk boxes are the boxes of runs
    of those rows: a chunk's rows are the chunk's triangles."""
    _, _, rt = _scene("stress_576")
    assert torch.equal(rt.tri_table, mt_tri_table(rt.v0, rt.v1, rt.v2, rt.tri_valid))
    attr, _, _ = pk.pack_scene_tables(rt)
    assert attr.shape == (rt.tri_table.shape[0], 16)
    assert torch.equal(attr[:, 0:9], torch.cat([rt.n0, rt.n1, rt.n2], dim=1))
    assert torch.equal(attr[:, 9:12][rt.tri_valid], rt.mat_kd[rt.tri_mat.long()][rt.tri_valid])
    _, wattr, _, _, _ = wk.pack_whitted_tables(rt)
    assert torch.equal(wattr[:, 0:9], torch.cat([rt.v0, rt.v1, rt.v2], dim=1))
    lo, hi = tt.chunk_bounds(rt.v0, rt.v1, rt.v2, rt.tri_valid, rt.cull_chunk)
    assert torch.equal(lo, rt.chunk_lo) and torch.equal(hi, rt.chunk_hi)
    ct = pk.pack_cull_tables(rt)
    assert ct.chunk == rt.cull_chunk and ct.lo2.shape == (1, 3)
    assert torch.equal(ct.lo2[0], rt.chunk_lo.amin(dim=0))
    lo3, hi3 = tt.chunk_bounds(rt.v0, rt.v1, rt.v2, rt.tri_valid, tt.LEAF)
    assert ct.lo3.shape == ct.hi3.shape == (20, 3)
    extent = max(float(lo3[:18].abs().max()), float(hi3[:18].abs().max()),
                 float(rt.eye.abs().max()))
    pad = tt.LEAF_PAD * extent
    assert torch.allclose(ct.lo3[:18], lo3[:18] - pad, rtol=0, atol=1e-7)
    assert torch.allclose(ct.hi3[:18], hi3[:18] + pad, rtol=0, atol=1e-7)
    assert (ct.lo3[:18] < lo3[:18]).all() and (ct.hi3[:18] > hi3[:18]).all()
    # the two leaves past the last valid row keep their inverted boxes
    assert torch.equal(ct.lo3[18:], lo3[18:]) and torch.equal(ct.hi3[18:], hi3[18:])
    # a chunk's box is its leaves' box
    assert torch.equal(lo3.reshape(5, 4, 3).amin(dim=1), rt.chunk_lo)
    assert torch.equal(hi3.reshape(5, 4, 3).amax(dim=1), rt.chunk_hi)


def _camera(rt, fovy, cull, stats=None):
    return pk.path_camera_render_plain(rt, 5, W, W, fovy, SPP, max_bounces=MAX_BOUNCES,
                                       stats=stats, cull=cull)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_camera_culled_equals_full_sweep(name):
    fovy, _, rt = _scene(name)
    s_cull, s_full = {}, {}
    a = _camera(rt, fovy, True, s_cull)
    b = _camera(rt, fovy, False, s_full)
    assert torch.equal(a, b)
    assert bool(torch.isfinite(a).all()) and float(a.sum()) > 0
    assert s_cull["lane_iterations"] == s_full["lane_iterations"]
    assert s_full["slab_tests"] == 0 and s_cull["slab_tests"] > 0
    if name == "stress_576":
        assert s_cull["row_tests"] < 0.8 * s_full["row_tests"], (s_cull, s_full)


def test_camera_culled_matches_jax_mm_tier():
    fovy, arrays, rt = _scene("stress_576")
    jrt = JRTScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = np.asarray(fused_path_camera_render(
        jrt, jax.random.PRNGKey(5), W, W, fovy, SPP, max_bounces=MAX_BOUNCES,
        interpret=True, _force_mm=True))
    got = pk.path_camera_render(rt, 5, W, W, fovy, SPP, max_bounces=MAX_BOUNCES).numpy()
    assert got.shape == want.shape == (3, W * W)
    lane_ok = np.isclose(got, want, rtol=LANE_RTOL, atol=LANE_ATOL).all(axis=0)
    lit = (got != 0).any(axis=0) | (want != 0).any(axis=0)
    assert lane_ok[~lit].all() and lit.sum() >= 20
    assert lane_ok[lit].mean() >= LIT_SHARE, (int((~lane_ok).sum()), int(lit.sum()))
    s_got = got[:, lane_ok].sum(dtype=np.float64)
    s_want = want[:, lane_ok].sum(dtype=np.float64)
    assert abs(s_got - s_want) <= SUM_RTOL * abs(s_want), (s_got, s_want)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bounce_culled_equals_full_sweep(name):
    fovy, _, rt = _scene(name)
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), fovy, W, W, "cpu"))
    hit = nearest_hit(rt, o, d)
    state, live = primary_state(hit), hit.hit
    s_cull, s_full = {}, {}
    a = pk.fused_bounce_group_plain(rt, state, live, 0x2545F491, MAX_BOUNCES,
                                    stats=s_cull, cull=True)
    b = pk.fused_bounce_group(rt, state, live, 0x2545F491, MAX_BOUNCES, cull=False)
    pk.fused_bounce_group_plain(rt, state, live, 0x2545F491, MAX_BOUNCES,
                                stats=s_full, cull=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[0].sum()) > 0 and s_cull["lane_bounces"] == s_full["lane_bounces"]
    if name == "stress_576":
        assert s_cull["row_tests"] < 0.8 * s_full["row_tests"], (s_cull, s_full)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_whitted_culled_equals_full_sweep(name):
    fovy, _, rt = _scene(name)
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), fovy, W, W, "cpu"))
    s_cull, s_full = {}, {}
    a = wk.whitted_uber_trace_plain(rt, o, d, 5, cull=True, stats=s_cull)
    b = wk.whitted_uber_trace_plain(rt, o, d, 5, cull=False, stats=s_full)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[0].sum()) > 0
    if name == "stress_576":
        assert s_cull["row_tests"] < 0.8 * s_full["row_tests"], (s_cull, s_full)
    # the default takes the culled walk above 512 rows: the same frame
    c = wk.whitted_uber_trace(rt, o, d, 5)
    assert torch.equal(a[0], c[0])


def test_routes_above_the_gate():
    """The measured rule of ops/path.py: above 512 triangles too,
    `path_trace(fused=None)` takes the bounce kernel (its culled walk) and
    `path_render(fused=None)` the camera kernel (its culled walk)."""
    fovy, _, rt = _scene("stress_576")
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), fovy, W, W, "cpu"))
    kw = dict(max_bounces=MAX_BOUNCES)
    auto = path_trace(rt, o, d, 3, **kw)
    assert torch.equal(auto, path_trace(rt, o, d, 3, fused=True, **kw))
    img = path_render(rt, W, W, fovy, 5, spp=2, **kw)
    cam = pk.path_camera_render(rt, 5, W, W, fovy, 2, cull=True, **kw)
    assert torch.equal(img, (cam.T / 2.0).reshape(W, W, 3))


def test_bad_cull_tables_raise():
    _, _, rt = _scene("stress_576")
    ct = pk.pack_cull_tables(rt)
    cpu = torch.device("cpu")
    for short in (ct._replace(lo=ct.lo[:4], hi=ct.hi[:4]),
                  ct._replace(lo3=ct.lo3[:17], hi3=ct.hi3[:17]),
                  ct._replace(chunk=130)):
        with pytest.raises(ValueError, match="do not cover"):
            pk._check_cull(short, rt.n_tri, cpu)
    assert pk._check_cull(ct, rt.n_tri, cpu)[6:] == (5, 20, 128)
    with pytest.raises(ValueError, match="needs CUDA"):
        pk.launch_path_camera(rt.tri_table, *pk.pack_scene_tables(rt)[:2],
                              rt.emitter_cr, torch.zeros(1, dtype=torch.int32),
                              torch.zeros(8), n_tri=rt.n_tri, n_sph=0, n_emitters=1,
                              lane_offset=0, n_lanes=4, width=2, height=2, p_rr=0.8,
                              max_bounces=2, cull_tables=ct)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_culled_equal_full_sweep_and_plain(card):
    """On the card: the culled camera, bounce and Whitted kernels equal
    their full-sweep instances and their plain versions."""
    _, arrays, _ = _scene("stress_576")
    fovy = _scene("stress_576")[0]
    rt = rt_scene_from_numpy(arrays, card)
    a = pk.path_camera_render(rt, 5, W, W, fovy, SPP, max_bounces=MAX_BOUNCES, cull=True)
    b = pk.path_camera_render(rt, 5, W, W, fovy, SPP, max_bounces=MAX_BOUNCES, cull=False)
    c = pk.path_camera_render_plain(rt, 5, W, W, fovy, SPP, max_bounces=MAX_BOUNCES)
    assert torch.equal(a, b)
    # against the plain version: lanes may differ only where the last bit
    # of a transcendental (logf, cosf, sinf, expf) flips a knife edge
    assert torch.isclose(a, c, rtol=1e-3, atol=1e-4).all(dim=0).float().mean() >= 0.99
    o, d = (x.contiguous() for x in camera_rays(rt.eye.cpu().numpy(), fovy, W, W, card))
    k = wk.whitted_uber_trace(rt, o, d, 5, cull=True)
    f = wk.whitted_uber_trace(rt, o, d, 5, cull=False)
    p = wk.whitted_uber_trace_plain(rt, o, d, 5)
    assert torch.equal(k[0], f[0]) and torch.equal(k[1], f[1])
    assert torch.isclose(k[0], p[0], rtol=1e-3, atol=1e-4).all(dim=1).float().mean() >= 0.99
