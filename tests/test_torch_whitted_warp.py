"""The Whitted kernel's warp-uniform step and its culled warp walk
(csrc/whitted_uber.cu) through their CPU models: `trace_tiers.warp_walk_plain`
for the walk and `whitted_kernel.warp_step_plain` for the step.

Scenes: the Cornell box tessellated by `torch_scenes.stress_cornell` at
levels=2 (576 triangles in a table of 640 rows in BVH leaf order, chunk
boxes, the culled walk); Cornell with a mirror and a glass sphere, and the
same with a second emitter (`torch_scenes`); 32x32 camera rays (48x48
for the step model).

Rules.
  * On the Whitted trace's own rays (the main rays and the shadow rays of
    `whitted_uber_trace_plain`, logged by its `rays` list), the warp walk
    equals the per-ray walk (`walk_nearest_plain`) in (hit, row, t bits),
    and the walk's row test is the Whitted row test (`whitted_kernel._mt`)
    t for t. A triangle copied into another leaf of its chunk is won by
    the lower row, at the same t.
  * `warp_step_plain` (warps of 32 lanes, each pass one main trace and then
    shadow traces by emitter) gives every lane the same rays in the same
    order, the same frame, ray counts and test counts as
    `whitted_uber_trace_plain`, bit for bit, where lanes of one warp sit at
    different depths; each of its traces serves the lanes of one warp, and
    a pass is one main trace then shadow traces in ascending emitter order.
  * The row-test slots by hand: a leaf entered by lanes of two warps, one
    of them partial, under both walks; 40 rays that leave the box through
    the full sweep.
  * On the card (`cuda`): the kernel against the plain version on a window
    of each scene, its (2, 4) tally against the plain version's counts
    (slots: the warp walk's and the full sweep's models).
"""

import functools

import pytest
import torch

from software_rasterizer_tpu_torch import models
from software_rasterizer_tpu_torch.ops import path_kernel as pk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
from software_rasterizer_tpu_torch.ops.trace_kernel import mt_plane
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from torch_scenes import mirror_glass_cornell, stress_cornell, two_emitter_cornell

W = 32
# the step model's frame: at 48x48 some warp's pass holds lanes at two
# depths (at 32x32 none does)
W_STEP = 48
MD = 5
SEED = 11
SCENES = {
    "stress_576": lambda: stress_cornell(build_cornell_scene, subdivide_mesh, 2),
    "mirror_glass": lambda: mirror_glass_cornell(models, build_cornell_scene),
    "two_emitters": lambda: two_emitter_cornell(models, build_cornell_scene),
}


def _rt(name, device="cpu", w=W):
    """(RTScene, camera origins, camera directions) of a w x w frame."""
    scene = SCENES[name]()
    scene.set_ndc_matrix(w, w)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), device)
    o, d = (x.contiguous() for x in camera_rays(rt.eye.cpu().numpy(), scene.fovy, w, w,
                                                  device))
    return rt, o, d


@functools.lru_cache(maxsize=None)
def _scene(name, w=W):
    return _rt(name, w=w)


@functools.lru_cache(maxsize=None)
def _stress_rays():
    """The stress scene and the rays of its Whitted trace: {"main": (o, d),
    "shadow": (o, d)}."""
    rt, o, d = _scene("stress_576")
    log = []
    wk.whitted_uber_trace_plain(rt, o, d, MD, cull=True, rays=log)
    rays = {}
    for kind in ("main", "shadow"):
        parts = [e for e in log if e[0] == kind]
        rays[kind] = tuple(torch.cat([e[k] for e in parts]).contiguous() for k in (4, 5))
    return rt, rays


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("kind", ["main", "shadow"])
def test_warp_walk_equals_the_per_ray_walk_on_whitted_rays(kind):
    rt, rays = _stress_rays()
    o, d = rays[kind]
    ct = pk.pack_cull_tables(rt)
    tm, tp = {}, {}
    model = tt.warp_walk_plain(rt.tri_table, rt.n_tri, o, d, ct, tally=tm)
    plain = tt.walk_nearest_plain(rt.tri_table, rt.n_tri, o, d, ct, tally=tp)
    assert torch.equal(model[1], plain[1])
    assert torch.equal(_bits(model[0]), _bits(plain[0]))
    # the shadow rays go toward the light, through the box: most hit
    assert int((model[1] >= 0).sum()) > 0.5 * o.shape[0]
    # the cull is real, and both walks make the same tests
    assert tm == tp and tm["row_tests"] < 0.8 * o.shape[0] * rt.n_tri


@pytest.mark.parametrize("kind", ["main", "shadow"])
def test_walk_row_test_is_the_whitted_row_test(kind):
    rt, rays = _stress_rays()
    o, d = rays[kind]
    rows = rt.tri_table[:rt.n_tri]
    o_, d_ = tuple(o[:, k:k + 1] for k in range(3)), tuple(d[:, k:k + 1] for k in range(3))
    _, _, t_whitted, _ = wk._mt(*(rows[None, :, k] for k in range(9)), o_, d_)
    assert torch.equal(_bits(t_whitted), _bits(mt_plane(o, d, rows)))


# chunks of two slices of leaves, so a slice boundary may lie inside a chunk
CHUNK = 2 * tt.LEAF * tt.SLICE_LEAVES
# rows between a triangle and its copy: a slice's worth of leaves, so the
# two leaves fall in one slice only where a warp enters none between them
GAP = tt.LEAF * tt.SLICE_LEAVES


@pytest.mark.parametrize("upward", [True, False])
def test_the_lower_row_of_a_copy_across_a_slice_boundary_wins(upward):
    rt, rays = _stress_rays()
    o, d = rays["main"]
    ct = pk.pack_cull_tables(rt)
    _, row, _, _ = tt.walk_nearest_plain(rt.tri_table, rt.n_tri, o, d, ct)
    # the most hit row whose copy, GAP rows away, lies in another leaf of
    # the same chunk
    rows = torch.arange(rt.n_tri)
    other = rows + GAP if upward else rows - GAP
    fits = (other >= 0) & (other < rt.n_tri) & (rows // CHUNK == other // CHUNK)
    counts = torch.where(fits, torch.bincount(row[row >= 0], minlength=rt.n_tri), 0)
    src = int(counts.argmax())
    dst = int(other[src])
    table = rt.tri_table.clone()
    table[dst] = table[src]
    v0 = table[:, 0:3]
    tris = (v0, v0 + table[:, 3:6], v0 + table[:, 6:9],
            torch.ones(table.shape[0], dtype=torch.bool))
    lo, hi = tt.chunk_bounds(*tris, CHUNK)
    lo3, hi3 = tt.leaf_bounds(*tris)
    cull = tt.cull_tables(lo - 1e-3, hi + 1e-3, CHUNK, lo3 - 1e-3, hi3 + 1e-3)
    model = tt.warp_walk_plain(table, rt.n_tri, o, d, cull)
    plain = tt.walk_nearest_plain(table, rt.n_tri, o, d, cull)
    assert torch.equal(model[1], plain[1]) and torch.equal(_bits(model[0]), _bits(plain[0]))
    hit_src = row == src
    assert int(hit_src.sum()) >= 3
    t_before = tt.walk_nearest_plain(rt.tri_table, rt.n_tri, o, d, ct)[0]
    assert (model[1][hit_src] == min(src, dst)).all()
    assert torch.equal(_bits(model[0][hit_src]), _bits(t_before[hit_src]))


def _per_lane(log):
    """lane -> its traces in order: (kind, emitter, depth, origin, direction)."""
    out = {}
    for kind, emitter, lanes, depth, o, d in log:
        for lane, dep, oo, dd in zip(lanes.tolist(), depth.tolist(), o.tolist(), d.tolist()):
            out.setdefault(lane, []).append((kind, emitter, dep, tuple(oo), tuple(dd)))
    return out


@pytest.mark.parametrize("name,spp", [("mirror_glass", 1), ("two_emitters", 1),
                                      ("two_emitters", 4)])
def test_warp_step_model_equals_plain(name, spp):
    rt, o, d = _scene(name, W_STEP)
    st_p, st_w, log_p, log_w = {}, {}, [], []
    a = wk.whitted_uber_trace_plain(rt, o, d, MD, key=SEED, spp=spp, stats=st_p, rays=log_p)
    b = wk.warp_step_plain(rt, o, d, MD, key=SEED, spp=spp, stats=st_w, rays=log_w)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[0].sum()) > 0
    assert st_p == st_w
    assert _per_lane(log_p) == _per_lane(log_w)
    # each trace serves one warp; a warp's pass is one main trace, then
    # shadow traces in ascending emitter order
    last = {}
    for kind, emitter, lanes, _, _, _ in log_w:
        warps = torch.unique(lanes // tt.WARP)
        assert warps.numel() == 1
        w = int(warps[0])
        if kind == "main":
            last[w] = -1
        else:
            assert w in last and emitter > last[w]
            last[w] = emitter
    # with several emitters some pass traces toward both
    if rt.n_emitters > 1:
        assert {e[1] for e in log_w if e[0] == "shadow"} == set(range(rt.n_emitters))
    # lanes of one warp at different depths in one main trace
    assert any(e[0] == "main" and torch.unique(e[3]).numel() > 1 for e in log_w)


def test_warp_slots_by_hand():
    # lane 3 (warp 0) and lanes 35, 36 (warp 1, its other lanes idle)
    # enter the leaf of rows [256, 288): the warp walk spends one step on
    # each lane, the per-ray walk steps through all 32 rows in both warps
    assert tt.LEAF == 32 and tt.WARP == 32
    assert tt.warp_slots(torch.tensor([3, 35, 36]), 256, 288) == (32 * 3, 32 * 32 * 2)


def test_full_sweep_slots_by_hand():
    # 40 rays from the eye away from the box: one pass of one main trace,
    # no shadow trace; two warps (32 + 8 lanes) step through all 36 rows
    scene = build_cornell_scene()
    scene.set_ndc_matrix(W, W)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    _, d = camera_rays(rt.eye.numpy(), scene.fovy, W, W, "cpu")
    d = (-d[:40]).contiguous()
    o = rt.eye.float()[None].expand(40, 3).contiguous()
    st = {}
    rgb, nray = wk.whitted_uber_trace_plain(rt, o, d, MD, stats=st)
    assert rt.n_tri == 36 and (nray[0] == 1).all() and (nray[1] == 0).all()
    # the full sweep makes no box test
    no_box = {"box_tests": 0, "box_slots": 0, "box_slots_thread": 0}
    assert st["main"] == {"row_tests": 40 * 36, "slab_tests": 0, "slots": 2 * 32 * 36,
                          "slots_thread": 2 * 32 * 36, "chunk_rows": 0, **no_box}
    assert st["shadow"] == {"row_tests": 0, "slab_tests": 0, "slots": 0, "slots_thread": 0,
                            "chunk_rows": 0, **no_box}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_launch_args_are_the_wrappers(name):
    """`whitted_launch_args` hands the launcher the scene's tables, the
    emitter picks' seeds only with several emitters, and the chunk tables
    only above 512 rows."""
    rt, o, d = _scene(name)
    args, kw = wk.whitted_launch_args(rt, o, d, MD, key=SEED, spp=4, lane_offset=64)
    tri, attr, sph, n_tri, n_sph = wk.pack_whitted_tables(rt)
    assert all(torch.equal(a, b) for a, b in zip(args, (tri, attr, sph)))
    assert args[6] is o and args[7] is d and (kw["n_tri"], kw["n_sph"]) == (n_tri, n_sph)
    assert (kw["cull_tables"] is not None) == (name == "stress_576")
    if rt.n_emitters > 1:
        assert kw["n_emitters"] == 2 and kw["lane_offset"] == 64
        assert kw["pick_seeds"].shape == (MD + 1, 4)
    else:
        assert "pick_seeds" not in kw


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,spp", [("stress_576", 1), ("mirror_glass", 1),
                                      ("two_emitters", 1), ("two_emitters", 4)])
def test_kernel_equals_plain_on_the_card(card, name, spp):
    """The kernel (the warp walk above 512 rows) against the plain version
    on the frame's middle 512 lanes: ray counts equal, pixels equal bar
    knife edges of a transcendental's last bit, and the (2, 4) tally equal
    to the plain version's counts where every pixel is equal."""
    rt, o, d = _rt(name, card)
    sl = slice(W * W // 2 - 256, W * W // 2 + 256)
    tally = torch.zeros((2, len(wk.TALLY_COLUMNS)), dtype=torch.int64, device=card)
    args, kw = wk.whitted_launch_args(rt, o[sl], d[sl], MD, key=SEED, spp=spp)
    got = wk.launch_whitted_uber(*args, tally=tally, **kw)
    st = {}
    want = wk.whitted_uber_trace_plain(rt, o[sl], d[sl], MD, key=SEED, spp=spp, stats=st)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    close = torch.isclose(got[0], want[0], rtol=1e-3, atol=1e-4).all(dim=1)
    assert close.float().mean() >= 0.99
    if bool(torch.equal(got[0], want[0])):
        assert tally.tolist() == [[st[r][k] for k in wk.TALLY_COLUMNS] for r in wk.TALLY_ROWS]
