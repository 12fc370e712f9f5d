"""The warp walk of the culled path kernels (csrc/trace_common.cuh
warp_walk_chunks: a ballot a chunk, then the whole warp on one entering
ray's rows at a time) through its CPU model `trace_tiers.warp_walk_plain`.

Scene: the Cornell box tessellated by `torch_scenes.stress_cornell` at
levels=2 (576 triangles in a table of 640 rows, five chunks of 128 in one
super box), 32x32 camera rays and as many bounce rays from their hits
(directions from a seeded NumPy draw).

Rules.
  * The model equals `walk_nearest_plain` bit for bit in (t, row, u, v),
    and its tally of (ray, row) and slab tests equals the per-ray walk's:
    it changes which slot tests a pair, not the pairs or their
    expressions.
  * A triangle present at two rows is won by the lower row: two rows of
    one slot of a slice (rows r and r + 32), two slots of one slice, two
    slices of one chunk (chunks of 256 rows here), and two chunks, in
    either order of copy; t is the same.
  * Lanes outside `active` stay misses (t 1e30, row -1, u = v = 0) and
    change no active lane's result.
  * The warp walk issues no more row-test slots than the per-thread walk
    and no fewer than its row tests (`warp_slots`, a hand count).
  * Against the JAX package's XLA sweep (`_intersect_tri_raw`, no cull):
    the same winner, bar rays proven in float64 to be ties or to sit on an
    acceptance threshold (`torch_scenes.mt_knife_edge_rays`; XLA contracts
    FMAs), at most 3% of the rays: at 32x32 edges shared by two triangles
    of the tessellation pass through pixel centres (21 of the 1,024
    camera rays, none of the bounce rays).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops.intersect import _intersect_tri_raw as jraw
from software_rasterizer_tpu_torch.ops import path_kernel as pk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import nearest_hit, prepare_rt_scene
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from torch_scenes import mt_knife_edge_rays, stress_cornell

W = 32
SEED = 7


@functools.lru_cache(maxsize=None)
def _scene():
    """(RTScene on the CPU, {"camera": (o, d), "bounce": (o, d)})."""
    scene = stress_cornell(build_cornell_scene, subdivide_mesh, 2)
    scene.set_ndc_matrix(W, W)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), scene.fovy, W, W, "cpu"))
    hit = nearest_hit(rt, o, d)
    nrm = hit.normal[hit.hit]
    rng = np.random.default_rng(SEED)
    g = torch.from_numpy(rng.standard_normal((nrm.shape[0], 3)).astype(np.float32))
    g = g / g.norm(dim=1, keepdim=True)
    g = torch.where((g * nrm).sum(dim=1, keepdim=True) < 0, -g, g)
    o2 = (hit.coords[hit.hit] + 1e-4 * nrm).contiguous()
    return rt, {"camera": (o, d), "bounce": (o2, g.contiguous())}


def _walks(table, n_rows, o, d, cull, active=None):
    """(model result, model tally, per-ray result, per-ray tally)."""
    tm, tp = {}, {}
    model = tt.warp_walk_plain(table, n_rows, o, d, cull, active, tm)
    plain = tt.walk_nearest_plain(table, n_rows, o, d, cull, active, tp)
    return model, tm, plain, tp


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_model_equals_the_per_ray_walk(rays):
    rt, sets = _scene()
    o, d = sets[rays]
    model, tm, plain, tp = _walks(rt.tri_table, rt.n_tri, o, d, pk.pack_cull_tables(rt))
    for a, b in zip(model, plain):
        assert torch.equal(a, b)
    # bounce rays leave through the open side of the box: 42% hit
    assert int((model[1] >= 0).sum()) > 0.3 * o.shape[0]
    assert tm == tp and tm["row_tests"] < 0.8 * o.shape[0] * rt.n_tri


# the duplicates' chunks: two slices of tt.WALK_SLICE rows each
CHUNK = 2 * tt.WALK_SLICE


def _table_with_copy(rt, src, dst):
    """The scene's table with row `src` copied to row `dst`, and cull
    tables of chunks of CHUNK rows, their boxes widened by 1e-3 (so a ray
    that meets row `src` enters the box of `dst`'s chunk whatever the
    rounding of v0 + e1)."""
    table = rt.tri_table.clone()
    table[dst] = table[src]
    v0 = table[:, 0:3]
    lo, hi = tt.chunk_bounds(v0, v0 + table[:, 3:6], v0 + table[:, 6:9],
                             torch.ones(table.shape[0], dtype=torch.bool), CHUNK)
    return table, tt.cull_tables(lo - 1e-3, hi + 1e-3, CHUNK)


def _slice(f):
    return f // tt.WALK_SLICE


# where the two rows of a duplicate lie: the distance between them and
# whether a pair (row, row + distance) counts: one slot of a slice, two
# slots of one slice, two slices of one chunk, two chunks
COPIES = {
    "one slot": (32, lambda a, b: _slice(a) == _slice(b)),
    "two slots": (7, lambda a, b: _slice(a) == _slice(b)),
    "two slices": (150, lambda a, b: (a // CHUNK == b // CHUNK) & (_slice(a) != _slice(b))),
    "two chunks": (300, lambda a, b: a // CHUNK != b // CHUNK),
}


@pytest.mark.parametrize("gap", sorted(COPIES))
@pytest.mark.parametrize("upward", [True, False])
def test_the_lower_row_of_a_duplicate_wins(gap, upward):
    rt, sets = _scene()
    o, d = sets["camera"]
    ct = pk.pack_cull_tables(rt)
    _, row, _, _ = tt.walk_nearest_plain(rt.tri_table, rt.n_tri, o, d, ct)
    # the most hit row whose copy lands on a row of the kind asked for
    k, kind = COPIES[gap]
    rows = torch.arange(rt.n_tri)
    other = rows + k if upward else rows - k
    fits = (other >= 0) & (other < rt.n_tri) & kind(rows, other)
    counts = torch.where(fits, torch.bincount(row[row >= 0], minlength=rt.n_tri), 0)
    src = int(counts.argmax())
    dst = int(other[src])
    table, cull = _table_with_copy(rt, src, dst)
    rays = row == src
    assert int(rays.sum()) >= 3
    model, _, plain, _ = _walks(table, rt.n_tri, o, d, cull)
    for a, b in zip(model, plain):
        assert torch.equal(a, b)
    t_before = tt.walk_nearest_plain(rt.tri_table, rt.n_tri, o, d, ct)[0]
    assert (model[1][rays] == min(src, dst)).all()
    assert torch.equal(model[0][rays], t_before[rays])


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_inactive_lanes_stay_misses(rays):
    rt, sets = _scene()
    o, d = sets[rays]
    ct = pk.pack_cull_tables(rt)
    active = torch.from_numpy(np.random.default_rng(SEED).random(o.shape[0]) < 0.5)
    model, tm, plain, tp = _walks(rt.tri_table, rt.n_tri, o, d, ct, active)
    for a, b in zip(model, plain):
        assert torch.equal(a, b)
    t, row, u, v = model
    assert (t[~active] == tt.BIG).all() and (row[~active] == -1).all()
    assert (u[~active] == 0).all() and (v[~active] == 0).all()
    full = tt.warp_walk_plain(rt.tri_table, rt.n_tri, o, d, ct)
    for a, b in zip(model, full):
        assert torch.equal(a[active], b[active])
    assert tm == tp


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_warp_walk_issues_no_more_slots_than_the_per_thread_walk(rays):
    rt, sets = _scene()
    o, d = sets[rays]
    _, tm, _, _ = _walks(rt.tri_table, rt.n_tri, o, d, pk.pack_cull_tables(rt))
    # every chunk of this table holds a multiple of 32 rows: no idle slot
    assert tm["row_tests"] == tm["slots"] < tm["slots_thread"]


def test_warp_slots_by_hand():
    # lanes 0 and 1 (warp 0) and 40 (warp 1) on rows [0, 200): slices of
    # 128 and 72 rows, 4 + 3 steps a lane; the per-thread walk steps
    # through all 200 rows in both warps
    assert tt.WALK_SLICE == 128
    lanes = torch.tensor([0, 1, 40])
    assert tt.warp_slots(lanes, 0, 200) == (32 * 7 * 3, 32 * 200 * 2)
    assert tt.warp_slots(torch.tensor([5]), 128, 133) == (32, 32 * 5)


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_model_matches_jax_xla_sweep(rays):
    rt, sets = _scene()
    o, d = sets[rays]
    _, row, _, _ = tt.warp_walk_plain(rt.tri_table, rt.n_tri, o, d, pk.pack_cull_tables(rt))
    n = rt.n_tri
    v = [jnp.asarray(x[:n].numpy()) for x in (rt.v0, rt.v1, rt.v2)]
    _, want, _ = jraw(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), *v,
                      jnp.asarray(rt.tri_valid[:n].numpy()), chunk=128, cull_chunks=False)
    got, want = row.numpy(), np.asarray(want).astype(np.int64)
    same = got == want
    assert same.mean() >= 0.97, int((~same).sum())
    edge = mt_knife_edge_rays(rt.tri_table.numpy(), o.numpy(), d.numpy(), got, want)
    assert edge[~same].all(), np.flatnonzero(~same & ~edge)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_tally_equals_the_model(card):
    """On the card: the culled camera kernel's (3,) tally of row tests,
    slab tests and row-test slots equals its plain version's counts,
    whose slots are the model's (`warp_slots`)."""
    from software_rasterizer_tpu_torch.utils.rng import sample_seeds

    scene = stress_cornell(build_cornell_scene, subdivide_mesh, 2)
    scene.set_ndc_matrix(W, W)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), card)
    fovy = scene.fovy
    attr, sph, n_sph = pk.pack_scene_tables(rt)
    tally = torch.zeros(3, dtype=torch.int64, device=card)
    got = pk.launch_path_camera(
        rt.tri_table.float().contiguous(), attr, sph, rt.emitter_cr.float().contiguous(),
        torch.as_tensor(sample_seeds(5, 0, 1)).to(card), pk._camera_table(rt, fovy, W, W),
        n_tri=rt.n_tri, n_sph=n_sph, n_emitters=rt.n_emitters, lane_offset=0, n_lanes=W * W,
        width=W, height=W, p_rr=0.8, max_bounces=6, cull_tables=pk.pack_cull_tables(rt),
        tally=tally)
    st = {}
    want = pk.path_camera_render_plain(rt, 5, W, W, fovy, 1, max_bounces=6, stats=st, cull=True)
    torch.cuda.synchronize()
    # lanes may differ only where the last bit of a transcendental flips a
    # knife edge; the counts are the same where no lane differs
    close = torch.isclose(got, want, rtol=1e-3, atol=1e-4).all(dim=0)
    assert close.float().mean() >= 0.99
    if bool(close.all()):
        assert tally.tolist() == [st["row_tests"], st["slab_tests"], st["slots"]]
