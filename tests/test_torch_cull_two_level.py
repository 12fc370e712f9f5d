"""The two-level warp vote of the cull prepass (#5) and of the fused cull
(#4) (csrc/trace_culled.cu), through their plain models on the CPU.

  * `trace_tiers.cull_prepass_warp_plain` (each warp votes on each
    super-chunk box first and skips its chunks only where conditions (a)
    and (b) prove the skip exact) gives `cull_prepass_plain`'s mask bit for
    bit: on `torch_scenes.stress_cornell` camera and bounce rays at four
    ray-block sizes, on adversarial rays (zero, denormal, infinite and NaN
    direction components; origins on a box face, inside a box and at
    +-1e30) and boxes (an inverted empty chunk mid-table, the tail super's
    padding, hand-made super boxes that children stick out of), and where
    each condition is broken once, its tally then showing that super taken
    child by child; and the JAX `_cull_prepass` in interpret mode;
  * its tally on two cases counted by hand;
  * `trace_tiers.fused_warp_plain` (each warp's own two-level vote, then the
    two-stage sweep of the chunks it enters) equals
    `trace_nearest_mm2c_plain` (the block vote) and kernel #2's plain
    version bit for bit, its tally a count made warp by warp, and its
    winners the JAX `trace_nearest_mm2c` in interpret mode's bar rays proven
    knife edges;
  * `cuda`-marked: each kernel equals its model on the card, tally
    included (skipped without a card).

Inputs come from NumPy seeds; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops import pallas_trace as jpt
from software_rasterizer_tpu_torch.ops import intersect as ti
from software_rasterizer_tpu_torch.ops import trace_kernel as tk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from torch_scenes import mt_knife_edge_rays, stress_cornell
from test_torch_trace_tiers import BLOCK, _jax_operands, _padded, _torch_operands

SIZE = 32
BIG = 1e30
NAMES = tt.CULL_TALLY_NAMES


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain models issue thousands of small tensor ops; with several
    test processes each running PyTorch's intra-op pool on every core, the
    pools oversubscribe the CPU and each op waits on descheduled threads
    (six processes took ~70x longer a case than one). One thread a process
    for this module, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stress(levels):
    """stress_cornell at `levels` with camera rays and bounce rays from
    their hit points (a NumPy seed), 40 rays short of whole blocks."""
    sc = stress_cornell(build_cornell_scene, subdivide_mesh, levels)
    sc.set_ndc_matrix(SIZE, SIZE)
    rt = ti.prepare_rt_scene(sc.rt_geometry(), sc.rt_frame(), "cpu")
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), sc.fovy, SIZE, SIZE, "cpu"))
    hit = ti.nearest_hit(rt, o, d, backend="vpu")
    g = np.random.RandomState(9 + levels)
    w = torch.from_numpy(g.randn(o.shape[0], 3).astype(np.float32))
    w = w / torch.sqrt((w * w).sum(dim=1, keepdim=True))
    w = torch.where(((w * hit.normal).sum(dim=1) < 0)[:, None], -w, w)
    o2 = torch.where(hit.hit[:, None], hit.coords + 1e-6 * hit.normal, o).contiguous()
    d2 = torch.where(hit.hit[:, None], w, d).contiguous()
    return rt, {"camera": (o[:-40], d[:-40]), "bounce": (o2[:-40], d2[:-40])}


_SCENES = {}


def _scene(levels):
    if levels not in _SCENES:
        _SCENES[levels] = _stress(levels)
    return _SCENES[levels]


def _same_mask(lo, hi, o, d, block, supers=None):
    """The model's mask and tally, after checking the mask against the flat
    plain version."""
    mask, work = tt.cull_prepass_warp_plain(lo, hi, o, d, block, supers=supers)
    want = tt.cull_prepass_plain(lo, hi, o, d, block)
    assert torch.equal(mask, want), int((mask != want).sum())
    return mask, dict(zip(NAMES, work))


@pytest.mark.parametrize("block", [32, 64, 128, 2048])
@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("levels", [2, 3])
def test_model_mask_equals_flat_mask_on_stress_cornell(levels, kind, block):
    rt, rays = _scene(levels)
    o, d = rays[kind]
    mask, work = _same_mask(rt.chunk_lo, rt.chunk_hi, o, d, block)
    nc = rt.chunk_lo.shape[0]
    threads, r = tt.launch_shape(block)
    n_w = -(-o.shape[0] // block) * (threads // 32)
    assert work["warp_supers"] == n_w * -(-nc // tt.MM2C_SUPER)
    assert work["warp_supers_unproven"] == 0      # finite rays, no empty chunk
    assert work["super_tests"] == o.shape[0] * -(-nc // tt.MM2C_SUPER)
    assert work["chunk_tests"] <= o.shape[0] * nc
    if levels == 3 and block <= 128:
        assert work["warp_supers_skipped"] > 0    # the skip is real
        assert work["chunk_tests"] < o.shape[0] * nc
    assert 0 < mask.float().mean() <= 1


def _boxes(nc=43, seed=4):
    """nc chunk boxes along x from a NumPy seed (nc % 8 != 0: the tail
    super is short), each [x, x + w] x [y, y + 1] x [z, z + 1]."""
    g = np.random.RandomState(seed)
    x = np.sort(g.rand(nc) * 40.0)
    lo = np.stack([x, g.rand(nc) * 2.0, g.rand(nc) * 2.0], axis=1)
    hi = lo + np.stack([g.rand(nc) * 2.0 + 0.1, np.ones(nc), np.ones(nc)], axis=1)
    return torch.from_numpy(lo.astype(np.float32)), torch.from_numpy(hi.astype(np.float32))


def _rays(n=200, seed=6):
    """Rays from below z toward the boxes, sorted along x so a block sees a
    part of the table."""
    g = np.random.RandomState(seed)
    o = g.rand(n, 3) * np.array([44.0, 3.0, 1.0]) - np.array([2.0, 0.0, 3.0])
    o = o[np.argsort(o[:, 0])]
    d = g.randn(n, 3) * np.array([0.3, 0.3, 0.1]) + np.array([0.0, 0.0, 1.0])
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def _adversarial(name):
    """(lo, hi, orig, d, supers) of one adversarial set."""
    lo, hi = _boxes()
    o, d = _rays()
    supers = None
    if name == "directions":
        # zero, denormal, infinite and NaN components, in several warps
        for k, comp in enumerate([0.0, -0.0, 1e-40, -1e-40, float("inf"), float("-inf"),
                                  float("nan")]):
            d[7 + 29 * k, k % 3] = comp
        d[150] = torch.tensor([0.0, 0.0, 1e-40])
        d[151] = torch.tensor([0.0, 0.0, 0.0])
    elif name == "origins":
        o[10] = torch.stack([lo[5, 0], lo[5, 1] + 0.5, lo[5, 2] + 0.5])   # on a face
        d[10] = torch.tensor([0.0, 0.0, 1.0])
        o[11] = (lo[9] + hi[9]) / 2                                       # inside
        o[40] = torch.tensor([1e30, 0.5, 0.5])
        o[41] = torch.tensor([-1e30, 0.5, 0.5])
        d[41] = torch.tensor([1.0, 0.0, 0.0])
        o[90] = torch.tensor([0.0, 1e30, -1e30])
        o[120] = torch.tensor([float("nan"), 0.0, 0.0])
        o[121] = torch.tensor([2e30, 0.0, 0.0])
        o[122] = torch.tensor([float("inf"), 0.0, 0.0])
    elif name == "empty chunk":
        lo[21] = BIG
        hi[21] = -BIG
    elif name == "sticking out":
        lo2, hi2 = tt.super_bounds(lo, hi)
        lo2, hi2 = lo2.clone(), hi2.clone()
        hi2[1, 0] -= 0.5        # chunks of super 1 stick out in +x
        lo2[3] += 0.25          # and of super 3 on every axis
        supers = (lo2, hi2)
    return lo, hi, o, d, supers


@pytest.mark.parametrize("block", [32, 64, 256])
@pytest.mark.parametrize("name", ["directions", "origins", "empty chunk", "sticking out"])
def test_model_mask_equals_flat_mask_on_adversarial_sets(name, block):
    lo, hi, o, d, supers = _adversarial(name)
    _, work = _same_mask(lo, hi, o, d, block, supers)
    nsc = -(-lo.shape[0] // tt.MM2C_SUPER)
    n_w = -(-o.shape[0] // block) * (min(block, 256) // 32)
    assert work["warp_supers"] == n_w * nsc
    if name in ("directions", "origins"):
        # the warps holding a ray that breaks (a) go child by child on
        # every super; the others skip where no ray enters
        bad = ~tt.ray_proven(o, d)
        assert bad.any() and bad.sum() < o.shape[0]
        warps = torch.unique(torch.nonzero(bad).flatten() // 32 if block <= 256 else None)
        assert work["warp_supers_unproven"] == warps.numel() * nsc
    else:
        ok = tt.super_proven(lo, hi, *(supers or tt.super_bounds(lo, hi)))
        assert int((~ok).sum()) == (1 if name == "empty chunk" else 2)
        assert work["warp_supers_unproven"] == n_w * int((~ok).sum())
        # the guard matters: some ray enters a child of an unproven super but
        # not the super box itself
        lo2, hi2 = supers or tt.super_bounds(lo, hi)
        enter = tt.slab_test(o, d, lo, hi)
        enter2 = tt.slab_test(o, d, lo2, hi2).repeat_interleave(tt.MM2C_SUPER, dim=1)
        assert (enter & ~enter2[:, :lo.shape[0]]).any()
    assert work["warp_supers_skipped"] > 0


def test_each_condition_broken_once():
    lo, hi = _boxes()
    o, d = _rays(n=128)
    block = 64
    _, base = _same_mask(lo, hi, o, d, block)
    assert base["warp_supers_unproven"] == 0
    # (a): one denormal direction component in ray 70 (warp 2 of 4)
    d_a = d.clone()
    d_a[70, 1] = 1e-40
    _, work = _same_mask(lo, hi, o, d_a, block)
    nsc = -(-lo.shape[0] // tt.MM2C_SUPER)
    assert work["warp_supers_unproven"] == nsc
    assert work["warp_supers"] == base["warp_supers"]
    # (b): one child of super 2 sticks out of its box
    lo2, hi2 = tt.super_bounds(lo, hi)
    lo2 = lo2.clone()
    lo2[2, 2] = lo[17, 2] + 1e-3
    _, work = _same_mask(lo, hi, o, d, block, (lo2, hi2))
    assert work["warp_supers_unproven"] == 4     # super 2 in each of the 4 warps
    assert work["warp_chunk_votes"] >= base["warp_chunk_votes"]


def test_mask_matches_jax_prepass():
    table, lo, hi, orig, d = _torch_operands("160 chunks of 16")
    n = orig.shape[0] // BLOCK * BLOCK
    mask, work = _same_mask(lo, hi, orig[:n], d[:n], BLOCK)
    _, _, jlo, jhi, jo, jd = _jax_operands("160 chunks of 16")
    want = np.asarray(jpt._cull_prepass(jlo, jhi, *_padded(jo[:n], jd[:n], BLOCK), BLOCK,
                                        interpret=True))
    assert np.array_equal(mask.numpy().astype(bool), want)
    assert work["warp_supers_skipped"] > 0
    # the empty chunk's inverted box makes its super unproven in every warp
    assert work["warp_supers_unproven"] == n // 32


def _hand_case(empty):
    """Ten unit chunk boxes along x (supers {0..7}, {8, 9}); 34 rays in one
    ray block of 64: warp 0 holds 32 rays that miss every box, warp 1 two
    rays, one of which enters chunk 8 alone (`empty`: no ray of warp 1
    enters anything, and chunk 9 is the inverted box of an empty chunk)."""
    lo = torch.tensor([[float(c), 0.0, 0.0] for c in range(10)])
    hi = lo + torch.tensor([0.5, 1.0, 1.0])
    o = torch.full((34, 3), 100.0)
    d = torch.tensor([1.0, 0.0, 0.0]).expand(34, 3).clone()
    if empty:
        lo[9], hi[9] = BIG, -BIG
    else:
        o[32] = torch.tensor([8.2, 5.0, 0.5])
        d[32] = torch.tensor([0.0, -1.0, 0.0])
    return lo, hi, o, d


@pytest.mark.parametrize("empty", [False, True])
def test_tally_counted_by_hand(empty):
    lo, hi, o, d = _hand_case(empty)
    mask, work = _same_mask(lo, hi, o, d, 64)
    if not empty:
        # both supers proven; warp 0 enters neither, warp 1 super 1 only
        assert mask.tolist() == [[0] * 8 + [1, 0]]
        assert work == {"super_tests": 32 * 2 + 2 * 2, "chunk_tests": 2 * 2,
                        "warp_supers": 4, "warp_supers_skipped": 3,
                        "warp_supers_unproven": 0, "warp_chunk_votes": 2}
    else:
        # super 1 holds the inverted box: both warps take it child by child,
        # and every ray enters the inverted box (a skip would have lost it)
        assert mask.tolist() == [[0] * 9 + [1]]
        assert work == {"super_tests": 32 + 2, "chunk_tests": 32 * 2 + 2 * 2,
                        "warp_supers": 4, "warp_supers_skipped": 2,
                        "warp_supers_unproven": 2, "warp_chunk_votes": 4}


def _brute_fused(rt, o, d, block):
    """#4's tally counted warp by warp from the launch layout (thread k of a
    block holds rays k + j * threads): each warp's vote on each super box,
    in an entered super on each chunk box, and the two-stage steps of the
    chunks it enters."""
    n = o.shape[0]
    threads, rays = tt.launch_shape(block)
    lo2, hi2 = tt.super_bounds(rt.chunk_lo, rt.chunk_hi)
    nc, nsc = rt.chunk_lo.shape[0], lo2.shape[0]
    n_rows = rt.tri_table.shape[0]
    e_sup = tt.slab_test(o, d, lo2, hi2).numpy()
    e_chk = tt.slab_test(o, d, rt.chunk_lo, rt.chunk_hi).numpy()
    ok1 = tk.mt_stage1_plane(o, d, rt.tri_table).numpy()
    zero_ray = tk.mt_stage1_plane(torch.zeros((1, 3)), torch.zeros((1, 3)),
                                  rt.tri_table).numpy()[0]
    work = np.zeros(tt.TALLY_ENTRIES, np.int64)
    for b in range(-(-n // block)):
        for w in range(threads // 32):
            lanes = [[b * block + w * 32 + l + j * threads
                      if w * 32 + l + j * threads < block
                      and b * block + w * 32 + l + j * threads < n else -1
                      for l in range(32)] for j in range(rays)]
            act = [r for row in lanes for r in row if r >= 0]
            for sc in range(nsc):
                work[4] += len(act)
                if not any(e_sup[r, sc] for r in act):
                    continue
                for c in range(sc * 8, min(sc * 8 + 8, nc)):
                    work[4] += len(act)
                    work[5] += 1
                    if not any(e_chk[r, c] for r in act):
                        work[6] += 1
                        continue
                    r0, r1 = c * rt.cull_chunk, min((c + 1) * rt.cull_chunk, n_rows)
                    for j in range(rays):
                        slot = [r for r in lanes[j] if r >= 0]
                        pas = np.zeros(r1 - r0, bool)
                        for r in lanes[j]:
                            pas |= ok1[r, r0:r1] if r >= 0 else zero_ray[r0:r1]
                        work[0] += r1 - r0
                        work[1] += int(pas.sum())
                        work[2] += len(slot) * (r1 - r0)
                        work[3] += len(slot) * int(pas.sum())
                        work[7] += sum(int(ok1[r, r0:r1].sum()) for r in slot)
    return tuple(int(x) for x in work)


@pytest.mark.parametrize("block", [32, 64, 512])
@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("levels", [2, 3])
def test_fused_model_equals_block_vote_and_a_brute_count(levels, kind, block):
    rt, rays = _scene(levels)
    o, d = rays[kind]
    got, work = tt.fused_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, o, d,
                                    rt.cull_chunk, block)
    want = tt.trace_nearest_mm2c_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, o, d,
                                       rt.cull_chunk, block)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ref = tk.trace_nearest_vpu_plain(rt.tri_table, rt.n_tri, o, d)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got[0].any()
    if block != 512:
        assert work == _brute_fused(rt, o, d, block)
    steps, voted, tests, full, slabs, pairs, skipped, passes = work
    assert 0 < voted < steps and 0 < passes <= full <= tests and slabs > 0
    assert pairs > 0


@pytest.mark.parametrize("name", ["300 in chunks of 64", "160 chunks of 16"])
def test_fused_model_matches_jax_fused_tier(name):
    table, lo, hi, orig, d = _torch_operands(name)
    chunk = {"300 in chunks of 64": 64, "160 chunks of 16": 16}[name]
    got, work = tt.fused_warp_plain(table, lo, hi, orig, d, chunk, BLOCK)
    assert all(torch.equal(a, b) for a, b in zip(
        got, tt.trace_nearest_mm2c_plain(table, lo, hi, orig, d, chunk, BLOCK)))
    _, coef, jlo, jhi, jo, jd = _jax_operands(name)
    want = jpt.trace_nearest_mm2c(coef, jlo, jhi, jo, jd, chunk=chunk, block=BLOCK,
                                  interpret=True)
    g_idx, w_idx = got[1].numpy(), np.asarray(want[1])
    same = g_idx == w_idx
    assert same.mean() >= 0.995, int((~same).sum())
    edge = mt_knife_edge_rays(table.numpy(), orig.numpy(), d.numpy(), g_idx, w_idx)
    assert edge[~same].all()
    assert np.array_equal(got[0].numpy()[same], np.asarray(want[0])[same])
    if name == "160 chunks of 16":
        assert work[6] > 0                      # some warps skip chunks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stress", "directions", "origins", "empty chunk",
                                  "sticking out"])
def test_prepass_kernel_equals_its_model(card, name):
    if name == "stress":
        rt, rays = _scene(3)
        sets = [(rt.chunk_lo, rt.chunk_hi, o, d, None) for o, d in rays.values()]
    else:
        sets = [_adversarial(name)]
    for lo, hi, o, d, supers in sets:
        for block in (32, 64, 96, 256, 768, 2048):
            want, work = tt.cull_prepass_warp_plain(lo, hi, o, d, block, supers=supers)
            tally = torch.zeros(tt.CULL_TALLY_ENTRIES, dtype=torch.int64, device=card)
            launches = tt.LAUNCHES_CULL
            got = tt.launch_cull_prepass(
                lo.to(card), hi.to(card), o.to(card), d.to(card), block,
                supers=None if supers is None else tuple(x.to(card) for x in supers),
                tally=tally)
            assert tt.LAUNCHES_CULL == launches + 1
            assert torch.equal(got.cpu(), want), (name, block)
            assert tuple(tally.tolist()) == work, (name, block)
            assert torch.equal(got.cpu(), tt.cull_prepass_plain(lo, hi, o, d, block))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 512])
def test_fused_kernel_equals_its_model_and_kernel_2(card, block):
    rt, rays = _scene(3)
    table, lo, hi = (x.to(card) for x in (rt.tri_table, rt.chunk_lo, rt.chunk_hi))
    lo2, hi2 = tt.super_bounds(lo, hi)
    for kind, (o, d) in rays.items():
        o, d = o.to(card), d.to(card)
        tally = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64, device=card)
        launches = tt.LAUNCHES_MM2C
        got = tt.launch_trace_fused_cull(table, lo, hi, lo2, hi2, o, d, rt.cull_chunk,
                                         block, tally=tally)
        assert tt.LAUNCHES_MM2C == launches + 1
        plain, work = tt.fused_warp_plain(table, lo, hi, o, d, rt.cull_chunk, block)
        assert all(torch.equal(a, b) for a, b in zip(got, plain)), kind
        assert all(torch.equal(a, b) for a, b in zip(
            got, tk.trace_nearest_vpu(table, rt.n_tri, o, d))), kind
        assert tuple(tally.tolist()) == work, kind
