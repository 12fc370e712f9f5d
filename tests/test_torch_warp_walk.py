"""The warp walk of the culled path kernels (csrc/trace_common.cuh
warp_walk_chunks: super, chunk and leaf boxes, a ballot a leaf, then the
whole warp on one entering ray's rows of a slice of leaves at a time)
through its CPU model `trace_tiers.warp_walk_plain`.

Scene: the Cornell box tessellated by `torch_scenes.stress_cornell` at
levels=2 (576 triangles in a table of 640 rows, five chunks of 128 in one
super box, 20 leaves of 32), 32x32 camera rays and as many bounce rays
from their hits (directions from a seeded NumPy draw).

Rules.
  * The model equals `walk_nearest_plain` bit for bit in (t, row, u, v),
    and its tally of (ray, row) and slab tests equals the per-ray walk's:
    it changes which slot tests a pair, not the pairs or their
    expressions.
  * The leaf boxes cull: the walk tests no more rows than with leaf boxes
    that are their chunks' boxes (the chunk-only walk, the same result),
    fewer in all, and at least one row for each ray that hits.
  * A triangle present at two rows is won by the lower row: two slots of
    one leaf, one slot of two leaves of a chunk (rows r and r + 32), two
    slots of two leaves, two leaves a slice or more apart (chunks of 256
    rows here), and two chunks, in either order of copy; t is the same.
  * Camera rays aimed through the edges that two coplanar triangles of
    different leaves share (the rays `torch_scenes.edge_tie_pixels` finds
    meeting two triangles) get the full sweep's (t, row) from the culled
    walk: no rounding of a leaf box's slab test drops a hit there.
  * Lanes outside `active` stay misses (t 1e30, row -1, u = v = 0) and
    change no active lane's result.
  * The warp walk issues no more row-test slots than the per-thread walk
    and no fewer than its row tests (`warp_slots`, a hand count for a
    leaf).
  * The cooperative box tests (a warp testing its rays' (ray, child box)
    pairs one a thread, `coop_children`, where `box_steps` chooses it)
    enter the same leaves with the same lanes in the same order as each
    ray's own tests, and count the same slab tests; the warps issue no
    more box-test slots than the own-thread loop, fewer on these rays,
    and no fewer than the chunk and leaf tests. `coop_children` equals
    `slab_test` ray by ray for ballots from none to a full warp, 1 to 32
    children a pass, and children barred by `ok`; `box_steps` by hand.
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
from torch_scenes import edge_tie_pixels, mt_knife_edge_rays, stress_cornell

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


def _chunk_only(ct):
    """`ct` with each leaf box its chunk's box: the chunk-only walk."""
    per_chunk, nl = ct.chunk // tt.LEAF, ct.lo3.shape[0]
    return ct._replace(lo3=ct.lo.repeat_interleave(per_chunk, dim=0)[:nl].contiguous(),
                       hi3=ct.hi.repeat_interleave(per_chunk, dim=0)[:nl].contiguous())


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_leaf_boxes_cull(rays):
    rt, sets = _scene()
    o, d = sets[rays]
    ct = pk.pack_cull_tables(rt)
    assert ct.lo3.shape == (20, 3) and ct.chunk // tt.LEAF == 4
    model, tm, plain, _ = _walks(rt.tri_table, rt.n_tri, o, d, ct)
    chunk_only, tc, _, _ = _walks(rt.tri_table, rt.n_tri, o, d, _chunk_only(ct))
    for a, b, c in zip(model, plain, chunk_only):
        assert torch.equal(a, b) and torch.equal(a, c)
    hits = int((model[1] >= 0).sum())
    assert hits <= tm["row_tests"] < tc["row_tests"] == tm["chunk_rows"] == tc["chunk_rows"]
    assert tm["slots"] < tc["slots"]


# the duplicates' chunks: two slices of tt.LEAF * tt.SLICE_LEAVES rows each
CHUNK = 2 * tt.LEAF * tt.SLICE_LEAVES


def _table_with_copy(rt, src, dst):
    """The scene's table with row `src` copied to row `dst`, and cull
    tables of chunks of CHUNK rows, their chunk and leaf boxes widened by
    1e-3 (so a ray that meets row `src` enters the boxes of `dst`'s chunk
    and leaf whatever the rounding of v0 + e1)."""
    table = rt.tri_table.clone()
    table[dst] = table[src]
    v0 = table[:, 0:3]
    tris = (v0, v0 + table[:, 3:6], v0 + table[:, 6:9],
            torch.ones(table.shape[0], dtype=torch.bool))
    lo, hi = tt.chunk_bounds(*tris, CHUNK)
    lo3, hi3 = tt.leaf_bounds(*tris)
    return table, tt.cull_tables(lo - 1e-3, hi + 1e-3, CHUNK, lo3 - 1e-3, hi3 + 1e-3)


def _leaf(f):
    return f // tt.LEAF


# where the two rows of a duplicate lie: the distance between them and
# whether a pair (row, row + distance) counts: two slots of one leaf, one
# slot of two leaves of a chunk, two slots of two leaves of a chunk, two
# leaves of a chunk a slice or more apart, two chunks
COPIES = {
    "two slots": (7, lambda a, b: _leaf(a) == _leaf(b)),
    "one slot": (32, lambda a, b: a // CHUNK == b // CHUNK),
    "two leaves": (40, lambda a, b: a // CHUNK == b // CHUNK),
    "two slices": (150, lambda a, b: a // CHUNK == b // CHUNK),
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


def _leaf_edge_rays(rt):
    """Camera rays from the eye through points (a quarter, half and three
    quarters along) of each edge that two coplanar triangles of different
    leaves share."""
    n = rt.n_tri
    v = torch.stack([rt.v0[:n], rt.v1[:n], rt.v2[:n]], dim=1).double()   # (n,3,3)
    nrm = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    edges = {}
    for f in range(n):
        if not bool(rt.tri_valid[f]):
            continue
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(v[f, a].tolist()), tuple(v[f, b].tolist()))))
            edges.setdefault(key, []).append(f)
    pts = []
    for (a, b), tris in edges.items():
        if len(tris) == 2 and _leaf(tris[0]) != _leaf(tris[1]) \
                and abs(float(nrm[tris[0]] @ nrm[tris[1]])) > 1 - 1e-9:
            a, b = torch.tensor(a), torch.tensor(b)
            pts += [a + s_ * (b - a) for s_ in (0.25, 0.5, 0.75)]
    p = torch.stack(pts).float()
    d = p - rt.eye.float()
    d = d / d.norm(dim=1, keepdim=True)
    return rt.eye.float().expand_as(d).contiguous(), d.contiguous()


def test_rays_through_shared_leaf_edges_keep_the_full_sweeps_hit():
    rt, _ = _scene()
    o, d = _leaf_edge_rays(rt)
    arrays = {"tri_table": rt.tri_table.numpy(), "n_tri": rt.n_tri, "eye": rt.eye.numpy()}
    ties = torch.from_numpy(edge_tie_pixels(arrays, d.numpy()))
    # most such rays meet the edge first; the others meet a nearer wall
    assert o.shape[0] >= 100 and int(ties.sum()) >= 0.3 * o.shape[0]
    ct = pk.pack_cull_tables(rt)
    model, _, culled, _ = _walks(rt.tri_table, rt.n_tri, o, d, ct)
    full = tt.walk_nearest_plain(rt.tri_table, rt.n_tri, o, d)
    for a, b, c in zip(model, culled, full):
        assert torch.equal(a, b)
        assert torch.equal(b, c), torch.nonzero(b != c).flatten()[:8].tolist()


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


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_cooperative_box_tests_enter_the_same_leaves(rays):
    rt, sets = _scene()
    o, d = sets[rays]
    ct = pk.pack_cull_tables(rt)
    tc, to = {}, {}
    coop = list(tt._walk_spans(ct, rt.n_tri, o, d, None, tc, coop=True))
    own = list(tt._walk_spans(ct, rt.n_tri, o, d, None, to))
    assert len(coop) == len(own) > 0
    for (la, a0, a1), (lb, b0, b1) in zip(coop, own):
        assert (a0, a1) == (b0, b1) and torch.equal(la, lb)
    assert tc == to
    # every box slot tests at most one (ray, box) pair of the chunk and
    # leaf levels; the cooperative form takes fewer here
    assert tc["box_tests"] == tc["slab_tests"] - o.shape[0] * ct.lo2.shape[0]
    assert 0 < tc["box_tests"] <= tc["box_slots"] < tc["box_slots_thread"]


@pytest.mark.parametrize("per", [1, 4, 8, 32])
@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_cooperative_pairing_equals_each_rays_own_tests(rays, per):
    from software_rasterizer_tpu_torch.ops.bvh import _inv_dir, slab_test

    rt, sets = _scene()
    o, d = sets[rays]
    ct = pk.pack_cull_tables(rt)
    n = min(o.shape[0], 1000)   # a partial last warp
    o, d = o[:n], d[:n]
    rng = np.random.default_rng(SEED + per)
    # each warp's share of lanes in the ballot: none, all, then at random
    share = rng.random(-(-n // tt.WARP))
    share[:2] = (0.0, 1.0)
    share = torch.from_numpy(share).repeat_interleave(tt.WARP)[:n]
    parent = torch.from_numpy(rng.random(n)) < share
    for nb in sorted({1, max(per // 2, 1), min(per, ct.lo3.shape[0])}):
        l0 = min(3, ct.lo3.shape[0] - nb)
        lo, hi = ct.lo3[l0:l0 + nb], ct.hi3[l0:l0 + nb]
        ok = torch.from_numpy(rng.random(nb) < 0.8)
        got, tests = tt.coop_children(o, _inv_dir(d), parent, lo, hi, per, ok)
        want = slab_test(o, d, lo, hi) & parent[:, None] & ok[None]
        assert torch.equal(got, want), nb
        assert tests == int(parent.sum()) * nb
    assert bool(want.any())


def test_box_steps_by_hand():
    # the model's constants are the kernels'
    import pathlib
    import re

    header = (pathlib.Path(tt.__file__).parents[1] / "csrc" / "trace_common.cuh").read_text()
    for name, value in (("kCoopRays", tt.COOP_RAYS), ("kSuper", tt.MM2C_SUPER),
                        ("kLeaf", tt.LEAF)):
        assert re.search(rf"constexpr int {name} = (\d+);", header).group(1) == str(value)
    assert tt.COOP_RAYS == 24
    k = torch.tensor([0, 1, 4, 5, 16, 17, 24, 25, 28, 32])
    # 8 chunks of a super box, 4 rays a pass: ceil(k / 4) passes where
    # that is fewer than 8 steps and k <= COOP_RAYS
    steps, own, coop = tt.box_steps(k, 8, 8)
    assert steps.tolist() == [0, 1, 1, 2, 4, 5, 6, 8, 8, 8]
    assert own.tolist() == [0] + [8] * 9
    assert coop.tolist() == [False] + [True] * 6 + [False] * 3
    # a short last super box of 2 chunks: one pass of up to 4 rays
    assert tt.box_steps(k, 2, 8)[0].tolist() == [0, 1, 1, 2, 2, 2, 2, 2, 2, 2]
    # 4 leaves a chunk, 8 rays a pass; 32 rays would take 4 passes = 4 steps
    assert tt.box_steps(k, 4, 4)[0].tolist() == [0, 1, 1, 1, 2, 3, 3, 4, 4, 4]
    # 3 leaves a chunk does not divide a warp: the own-thread loop
    steps, own, coop = tt.box_steps(k, 3, 3)
    assert torch.equal(steps, own) and not bool(coop.any())


def test_warp_slots_by_hand():
    # lanes 0 and 1 (warp 0) and 40 (warp 1) on the leaf of rows [32, 64):
    # one row-step a lane; the per-thread walk steps through all 32 rows
    # in both warps
    assert tt.LEAF == 32
    lanes = torch.tensor([0, 1, 40])
    assert tt.warp_slots(lanes, 32, 64) == (32 * 3, 32 * 32 * 2)
    # a short last leaf still costs a row-step a lane
    assert tt.warp_slots(torch.tensor([5]), 128, 133) == (32, 32 * 5)
    with pytest.raises(ValueError, match="one leaf"):
        tt.warp_slots(lanes, 0, 200)


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
    """On the card: the culled camera kernel's (6,) tally of row tests,
    slab tests, row-test slots and box-test slots equals its plain
    version's counts, whose slots are the models' (`warp_slots`,
    `box_steps`); the full sweep's loop entries stay 0."""
    from software_rasterizer_tpu_torch.utils.rng import sample_seeds

    scene = stress_cornell(build_cornell_scene, subdivide_mesh, 2)
    scene.set_ndc_matrix(W, W)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), card)
    fovy = scene.fovy
    attr, sph, n_sph = pk.pack_scene_tables(rt)
    tally = torch.zeros(len(pk.TALLY_ENTRIES), dtype=torch.int64, device=card)
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
        assert tally.tolist() == [st["row_tests"], st["slab_tests"], st["slots"], 0, 0,
                                  st["box_slots"]]
