"""The redesigned full sweeps of the path kernels, through their CPU models.

  * The bounce kernel's full sweep runs bounce-major (csrc/path_bounce.cu
    path_bounce_major): for each bounce, the list of the live lanes, in no
    fixed order, then the next list of those that live on.
    `path_kernel.bounce_major_plain` models it, the order shuffled by a
    seeded generator, and must equal `fused_bounce_group_plain` bit for
    bit in (acc, state, live): a lane's draws are keyed by its column and
    the bounce, and its sum has one term a bounce, added in bounce order.
  * Both kernels' full sweeps stage the table in slices and fold it row
    by row into each ray's (t, row, u, v), reading the winner's attributes
    once after the sweep (csrc/path_common.cuh dual_trace_block).
    `path_kernel.staged_sweep_plain` models it and must equal the per-ray
    sweep (`trace_tiers.walk_nearest_plain`) and `_dual_trace` bit for bit,
    the lowest row winning a tie also when the two copies of a triangle
    lie in two slices.
  * `path_kernel.loop_slots` counts the lane-slots of the two schedules
    by hand.

Scene: the Cornell box, 24x24 camera rays and bounce rays from their hits
(directions from a seeded NumPy draw); the wavefront is the first 555
lanes (not a multiple of 32), a seventh of its hit lanes dead at the start.
The JAX package is the reference through `fused_bounce_group_plain`, which
tests/test_torch_bounce_kernel.py holds against its Pallas kernel.
"""

import functools

import numpy as np
import pytest
import torch

from software_rasterizer_tpu_torch.ops import path_kernel as pk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import nearest_hit, prepare_rt_scene
from software_rasterizer_tpu_torch.ops.path import primary_state
from software_rasterizer_tpu_torch.scenes import build_cornell_scene

W = 24
N = 555
SEED = 0x9E3779B9
RNG_SEED = 11


@functools.lru_cache(maxsize=None)
def _scene():
    """(RTScene on the CPU, {"camera": (o, d), "bounce": (o, d)}, the
    wavefront's state (18, N) and live (N,))."""
    scene = build_cornell_scene()
    scene.set_ndc_matrix(W, W)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), scene.fovy, W, W, "cpu"))
    hit = nearest_hit(rt, o, d)
    rng = np.random.default_rng(RNG_SEED)
    g = torch.from_numpy(rng.standard_normal((o.shape[0], 3)).astype(np.float32))
    g = g / g.norm(dim=1, keepdim=True)
    g = torch.where((g * hit.normal).sum(dim=1, keepdim=True) < 0, -g, g)
    o2 = torch.where(hit.hit[:, None], hit.coords + 1e-4 * hit.normal, o).contiguous()
    state = primary_state(hit)[:, :N].contiguous()
    live = (hit.hit & (torch.arange(o.shape[0]) % 7 != 3))[:N].contiguous()
    return rt, {"camera": (o, d), "bounce": (o2, g.contiguous())}, state, live


@pytest.mark.parametrize("n_bounces", [0, 1, 16])
def test_bounce_major_model_equals_the_plain_version(n_bounces):
    rt, _, state, live = _scene()
    want = pk.fused_bounce_group_plain(rt, state, live, SEED, n_bounces)
    st = {}
    got = pk.bounce_major_plain(rt, state, live, SEED, n_bounces, order_seed=3, stats=st)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    acc, out, out_live = got
    # lanes dead at the start: no sum, still dead, their state kept
    dead = ~live
    assert int(dead.sum()) > N // 10 and int(live.sum()) > N // 2
    assert (acc[:, dead] == 0).all() and not out_live[dead].any()
    assert torch.equal(out[:, dead], state[:, dead])
    if n_bounces == 0:
        assert torch.equal(out, state) and torch.equal(out_live, live)
        return
    # some lanes die in bounce 1 and still take its state update
    one = pk.fused_bounce_group_plain(rt, state, live, SEED, 1)
    died = live & ~one[2]
    assert int(died.sum()) > 0 and not torch.equal(one[1][:, died], state[:, died])
    # the model's count of the kernel's lane-slots: 32 for every 32 lanes
    # of each bounce's list, or part
    ref = {}
    pk.fused_bounce_group_plain(rt, state, live, SEED, n_bounces, stats=ref)
    assert st["lane_bounces"] == ref["lane_bounces"] == int(ref["per_lane"].sum())
    assert st["slots"] == pk.loop_slots(ref["per_lane"])[1]


def test_bounce_major_order_does_not_matter():
    rt, _, state, live = _scene()
    a = pk.bounce_major_plain(rt, state, live, SEED, 16, order_seed=1)
    b = pk.bounce_major_plain(rt, state, live, SEED, 16, order_seed=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _duplicated(rt, src, before):
    """The plain tables with row `src` copied to a new row next to it,
    below it (`before`) or above it, the copy's Kd changed so that the
    winner shows in the bounce ray's hit; returns (tables, the slice size
    that puts the two copies in two slices, the row of the lower copy)."""
    tabs = pk._plain_tables(rt, False)
    at = src if before else src + 1
    tri = torch.cat([tabs.tri[:at], tabs.tri[src:src + 1], tabs.tri[at:]])
    copy = tabs.attr[src:src + 1].clone()
    copy[0, 9:12] = torch.tensor([0.1, 0.9, 0.3])
    attr = torch.cat([tabs.attr[:at], copy, tabs.attr[at:]])
    return tabs._replace(tri=tri, attr=attr, n_tri=tabs.n_tri + 1), src + 1, src


@pytest.mark.parametrize("rays", ["camera", "bounce"])
@pytest.mark.parametrize("before", [True, False])
def test_staged_sweep_picks_the_lower_copy_across_a_slice_boundary(rays, before):
    rt, sets, _, _ = _scene()
    o, d = sets[rays]
    _, row, _, _ = tt.walk_nearest_plain(rt.tri_table, rt.n_tri, o, d)
    src = int(torch.bincount(row[row >= 0], minlength=rt.n_tri).argmax())
    tabs, slice_rows, lower = _duplicated(rt, src, before)
    # the two copies are rows src and src + 1, the last row of one slice
    # and the first of the next
    assert lower // slice_rows != (lower + 1) // slice_rows
    want = tt.walk_nearest_plain(tabs.tri, tabs.n_tri, o, d)
    for size in (slice_rows, pk.STAGE_ROWS):
        got = pk.staged_sweep_plain(tabs.tri, tabs.n_tri, o, d, size)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    hits = row == src
    assert int(hits.sum()) >= 3 and (want[1][hits] == lower).all()
    # the whole dual trace, the attribute read and the spheres included
    ox, oy, oz = o.unbind(1)
    dl = tuple(d[:, k] for k in range(3))
    db = tuple(d.flip(0)[:, k].contiguous() for k in range(3))
    want = pk._dual_trace(tabs, (ox, oy, oz), dl, db)
    got = pk._dual_trace(tabs, (ox, oy, oz), dl, db, slice_rows=slice_rows)
    for a, b in zip(_flat(got), _flat(want)):
        assert torch.equal(a, b)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _flat(y)]


# (per-lane iterations, static slots, bounce-major slots) by hand; 32
# lanes a warp
SLOT_CASES = {
    # one warp, lanes of 3 and 1 iterations: 3 iterations of the warp
    # either way (bounce-major: lists of 2, 1, 1 lanes)
    "one warp": ([3, 1] + [0] * 30, 32 * 3, 32 * 3),
    # two warps, each with one lane of 4 and 31 of 1: the static loop runs
    # both warps 4 times; bounce-major runs 64 lanes, then 2 lanes three
    # times (one warp each)
    "two long lanes": ([4] + [1] * 31 + [4] + [1] * 31, 2 * 32 * 4, 32 * (2 + 3)),
    # 40 lanes of 2 (not a multiple of 32): two warps twice either way
    "ragged": ([2] * 40, 2 * 32 * 2, 2 * 32 * 2),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_loop_slots_by_hand(case):
    per_lane, static, major = SLOT_CASES[case]
    assert pk.loop_slots(torch.tensor(per_lane)) == (static, major)


def test_tally_of_five_entries_is_accepted():
    t5 = torch.zeros(5, dtype=torch.int64)
    assert pk._check_tally(t5, t5.device, slots=True) == t5.data_ptr()
    # six: the box-test slots of the culled walk after the loop's entries
    t6 = torch.zeros(6, dtype=torch.int64)
    assert pk._check_tally(t6, t6.device, slots=True) == t6.data_ptr()
    for bad in (4, 7):
        with pytest.raises(ValueError):
            pk._check_tally(torch.zeros(bad, dtype=torch.int64), t5.device, slots=True)
    assert len(pk.TALLY_ENTRIES) == 6 and pk.TALLY_ENTRIES[5] == "box_slots"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_runs_bounce_major(card):
    """On the card: the bounce kernel's full sweep equals its plain version
    on every lane, and its tally counts the lane-bounces and the
    lane-slots of the bounce-major schedule (`loop_slots`)."""
    _, _, state, live = _scene()
    scene = build_cornell_scene()
    scene.set_ndc_matrix(W, W)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), card)
    attr, sph, n_sph = pk.pack_scene_tables(rt)
    st, lv = state.to(card), live.to(card)
    tally = torch.zeros(5, dtype=torch.int64, device=card)
    got = pk.launch_path_bounce(
        rt.tri_table.float().contiguous(), attr, sph, rt.emitter_cr.float().contiguous(),
        st, lv, n_tri=rt.n_tri, n_sph=n_sph, n_emitters=rt.n_emitters, seed=SEED,
        n_bounces=16, p_rr=0.8, tally=tally)
    ref = {}
    want = pk.fused_bounce_group_plain(rt, st, lv, SEED, 16, stats=ref)
    torch.cuda.synchronize()
    close = torch.isclose(got[0], want[0], rtol=1e-3, atol=1e-4).all(dim=0)
    assert close.float().mean() >= 0.99
    if bool(close.all()) and torch.equal(got[2], want[2]):
        assert tally[3:].tolist() == [ref["lane_bounces"], pk.loop_slots(ref["per_lane"])[1]]

