"""The two-stage Moller-Trumbore test of kernels #6 and #8
(csrc/trace_culled.cu: stage 1 computes p, det, inv, tvec and u, the warp
votes on |det| >= 1e-6 and u in [0, 1], stage 2 runs only if some lane
passed), its plain forms, and the plain models of the work those kernels
count (`trace_tiers.TALLY_NAMES`), on the CPU.

  * `trace_kernel.mt_plane_two_stage` (stage 1, then stage 2 where it
    passed) equals `mt_plane` bit for bit, and a pair whose stage 1 fails
    gets 1e30, on adversarial rows and rays: det at +-1e-6 and its float
    neighbours, u exactly 0 and 1, NaN and Inf rays, zero rows;
  * `unculled_tally_plain` and `listed_warp_plain`'s counts equal a brute
    count, warp by warp and row by row, over the plain stage-1 planes on a
    small `torch_scenes.stress_cornell`;
  * `listed_warp_plain` (each warp sweeping only the listed chunks some ray
    of it enters) equals `trace_listed_plain` bit for bit, and the JAX
    `trace_nearest_mm2_stream` in interpret mode as
    tests/test_torch_trace_tiers.py holds it (winners equal bar proven knife
    edges);
  * `cuda`-marked: each kernel equals its plain version and kernel #2 bit
    for bit, and its tally equals the plain model (skipped without a card).

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
from test_torch_trace_tiers import BLOCK, _jax_operands, _torch_operands

SIZE = 32
BIG = 1e30


def _f32(x):
    return np.float32(x)


def _adversarial():
    """Rows and rays that sit on each threshold of stage 1: (orig (N,3),
    d (N,3), rows (C,12)) float32 tensors."""
    g = np.random.RandomState(5)
    rows = []
    # det = e1 . (d x e2) for d = +z: with e2 = (0, s, 0) and e1 = (1, 0, 0),
    # d x e2 = (-s, 0, 0), det = -s; with e1 = (-1, 0, 0), det = s
    for s in (1e-6, np.nextafter(_f32(1e-6), _f32(0)), np.nextafter(_f32(1e-6), _f32(1)),
              2e-6, 0.5):
        for sign in (1.0, -1.0):
            rows.append([0, 0, 1, -sign, 0, 0, 0, _f32(s), 0, 0, 0, 0])
    # unit triangles on z = 1 whose u is exactly 0 or 1 for rays along +z
    # through their vertices and edges
    rows.append([0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0])
    rows.append([0.25, 0.5, 1, 0.5, 0, 0, 0, 0.5, 0, 0, 0, 0])
    rows.append([0] * 12)                               # a zero row
    rows.append([0] * 12)
    rows += (g.rand(20, 12) * 2 - 1).tolist()           # random rows
    rows = np.asarray(rows, np.float32)
    rows[:, 9:] = 0.0
    orig = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0, 0], [0, 0.5, 0],
            [0.5, 0.5, 0], [0.25, 0.5, 0], [0.75, 0.5, 0], [0.25, 1.0, 0],
            [0.5, 0.25, 0], [np.nan, 0, 0], [0, 0, 0], [np.inf, 0, 0], [0, 0, 0],
            [0.1, 0.2, 0], [0.3, 0.3, 0]]
    d = [[0, 0, 1]] * 11 + [[0, 0, 1], [0, np.nan, 1], [0, 0, 1], [np.inf, 0, 1],
                            [0, 0, 0], [0.01, -0.02, 1]]
    orig += (g.rand(31, 3) * 2 - 1).tolist()
    d += (g.rand(31, 3) * 2 - 1).tolist()
    return (torch.tensor(np.asarray(orig, np.float32)),
            torch.tensor(np.asarray(d, np.float32)), torch.from_numpy(rows))


def test_two_stage_equals_the_test_on_adversarial_pairs():
    orig, d, rows = _adversarial()
    full = tk.mt_plane(orig, d, rows)
    staged = tk.mt_plane_two_stage(orig, d, rows)
    assert torch.equal(full.view(torch.int32), staged.view(torch.int32))
    ok1 = tk.mt_stage1_plane(orig, d, rows)
    assert (full[~ok1] == BIG).all()           # stage 1 fails => 1e30
    assert (staged[~ok1] == BIG).all()
    assert bool(ok1.any()) and bool((~ok1).any()) and bool((full < BIG).any())
    # the thresholds themselves: det at +-1e-6 passes, its lower neighbour
    # fails, in both forms; NaN and Inf rays and zero rows fail stage 1
    assert ok1[0, 0] and ok1[0, 1] and not ok1[0, 2] and not ok1[0, 3]
    assert ok1[0, 4] and ok1[0, 5]
    assert not ok1[11:15].any() and not ok1[:, 12:14].any()
    # u exactly 0 and 1 pass stage 1 (rays through the vertices of row 10)
    for r in (0, 1):
        assert ok1[r, 10], r
    # the plain sweep over these rows, with the staged test, is the sweep's
    ct, cf = tk.plane_winner(staged)
    hit, idx, t = tk.trace_nearest_vpu_plain(rows, rows.shape[0], orig, d)
    assert torch.equal(t, ct) and torch.equal(idx, torch.where(hit, cf, -1))


@pytest.fixture(scope="module")
def scene():
    """A small stress_cornell (576 triangles, chunks of 128) with camera
    rays and bounce rays from their hit points, made from a NumPy seed."""
    sc = stress_cornell(build_cornell_scene, subdivide_mesh, 2)
    sc.set_ndc_matrix(SIZE, SIZE)
    rt = ti.prepare_rt_scene(sc.rt_geometry(), sc.rt_frame(), "cpu")
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), sc.fovy, SIZE, SIZE, "cpu"))
    hit = ti.nearest_hit(rt, o, d, backend="vpu")
    g = np.random.RandomState(9)
    w = torch.from_numpy(g.randn(o.shape[0], 3).astype(np.float32))
    w = w / torch.sqrt((w * w).sum(dim=1, keepdim=True))
    w = torch.where(((w * hit.normal).sum(dim=1) < 0)[:, None], -w, w)
    o2 = torch.where(hit.hit[:, None], hit.coords + 1e-6 * hit.normal, o).contiguous()
    d2 = torch.where(hit.hit[:, None], w, d).contiguous()
    # a short last block: drop 40 rays
    return rt, {"camera": (o[:-40], d[:-40]), "bounce": (o2[:-40], d2[:-40])}


def _brute(rt, o, d, block, listed=None):
    """The tally of a two-stage kernel, counted warp by warp and row by row
    from the launch layout itself (thread k of a block holds rays k + j *
    threads): for #8 (listed None) every row; for #6 the block's listed
    chunks, each warp's slab votes on them first."""
    n = o.shape[0]
    threads = min(block, 256)
    rays = next(r for r in (1, 2, 4, 8) if r * threads >= block)
    table = rt.tri_table
    n_rows = table.shape[0]
    ok1 = tk.mt_stage1_plane(o, d, table).numpy()                   # (n, rows)
    if listed is not None:
        enter = tt.slab_test(o, d, rt.chunk_lo, rt.chunk_hi).numpy()  # (n, nc)
    work = np.zeros(tt.TALLY_ENTRIES, np.int64)
    zero_ray = tk.mt_stage1_plane(torch.zeros((1, 3)), torch.zeros((1, 3)), table).numpy()[0]
    for b in range(-(-n // block)):
        for w in range(threads // 32):
            lanes = [[b * block + w * 32 + l + j * threads
                      if w * 32 + l + j * threads < block and
                      b * block + w * 32 + l + j * threads < n else -1
                      for l in range(32)] for j in range(rays)]
            act = [r for row in lanes for r in row if r >= 0]
            if listed is None:
                chunks = [(0, n_rows)]
            else:
                chunks = []
                for c in listed[b]:
                    work[4] += len(act)
                    work[5] += 1
                    if not any(enter[r, c] for r in act):
                        work[6] += 1
                        continue
                    chunks.append((c * rt.cull_chunk, min((c + 1) * rt.cull_chunk, n_rows)))
            for r0, r1 in chunks:
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


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("block", [64, 512])
def test_tally_models_equal_a_brute_count(scene, kind, block):
    rt, rays = scene
    o, d = rays[kind]
    assert tt.unculled_tally_plain(rt.tri_table, o, d, block) == _brute(rt, o, d, block)
    mask = tt.cull_prepass_plain(rt.chunk_lo, rt.chunk_hi, o, d, block)
    counts, lists = tt.chunk_lists(mask)
    listed = [lists[b, :int(counts[b])].tolist() for b in range(counts.shape[0])]
    _, work = tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, counts, lists,
                                   o, d, rt.cull_chunk, block)
    assert work == _brute(rt, o, d, block, listed)
    steps, voted, tests, full, slabs, pairs, skipped, passes = work
    assert 0 < voted < steps and 0 < passes < full < tests and slabs > 0
    if block == 512 and kind == "camera":
        assert skipped > 0                      # the per-warp vote is real
    # the entry points add the models on the CPU
    tally = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64)
    tt.trace_nearest_mm2_stream(rt.tri_table, rt.chunk_lo, rt.chunk_hi, o, d,
                                chunk=rt.cull_chunk, block=block, tally=tally)
    assert tuple(tally.tolist()) == work
    tally.zero_()
    tt.trace_nearest_mm(rt.tri_table, o, d, block=block, tally=tally)
    assert tuple(tally.tolist()) == tt.unculled_tally_plain(rt.tri_table, o, d, block)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("block", [32, 64, 256, 2048])
def test_per_warp_sweep_equals_the_listed_sweep(scene, kind, block):
    rt, rays = scene
    o, d = rays[kind]
    counts, lists = tt.chunk_lists(tt.cull_prepass_plain(rt.chunk_lo, rt.chunk_hi, o, d,
                                                         block))
    want = tt.trace_listed_plain(rt.tri_table, counts, lists, o, d, rt.cull_chunk, block)
    got, _ = tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, counts, lists,
                                  o, d, rt.cull_chunk, block)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ref = tk.trace_nearest_vpu_plain(rt.tri_table, rt.n_tri, o, d)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got[0].any()


@pytest.mark.parametrize("name", ["300 in chunks of 64", "160 chunks of 16"])
def test_per_warp_sweep_matches_jax_stream_tier(name):
    table, lo, hi, orig, d = _torch_operands(name)
    chunk = {"300 in chunks of 64": 64, "160 chunks of 16": 16}[name]
    counts, lists = tt.chunk_lists(tt.cull_prepass(lo, hi, orig, d, BLOCK))
    got, work = tt.listed_warp_plain(table, lo, hi, counts, lists, orig, d, chunk, BLOCK)
    assert all(torch.equal(a, b) for a, b in zip(
        got, tt.trace_listed_plain(table, counts, lists, orig, d, chunk, BLOCK)))
    _, coef, jlo, jhi, jo, jd = _jax_operands(name)
    want = jpt.trace_nearest_mm2_stream(coef, jlo, jhi, jo, jd, chunk=chunk, block=BLOCK,
                                        interpret=True)
    g_idx, w_idx = got[1].numpy(), np.asarray(want[1])
    same = g_idx == w_idx
    assert same.mean() >= 0.995, int((~same).sum())
    edge = mt_knife_edge_rays(table.numpy(), orig.numpy(), d.numpy(), g_idx, w_idx)
    assert edge[~same].all()
    assert np.array_equal(got[0].numpy()[same], np.asarray(want[0])[same])
    assert work[6] > 0                          # some warps skip listed chunks


def test_warp_layout_and_bad_tally():
    ids = tt.warp_rays(1000, 512, "cpu")            # 256 threads, 2 rays a thread
    assert ids.shape == (2, 8, 2, 32)
    assert ids[0, 1, 1, 3].item() == 32 + 3 + 256
    assert ids[1, 7, 1, 31].item() == -1           # past the 1000th ray
    assert sorted(ids[ids >= 0].tolist()) == list(range(1000))
    assert tt.launch_shape(64) == (64, 1) and tt.launch_shape(2048) == (256, 8)
    table, lo, hi, orig, d = _torch_operands("300 in chunks of 64")
    with pytest.raises(ValueError, match="tally"):
        tt.trace_nearest_mm(table, orig, d, tally=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="int64"):
        tt.trace_nearest_mm2_stream(table, lo, hi, orig, d, chunk=64,
                                    tally=torch.zeros(tt.TALLY_ENTRIES))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 1024])
def test_kernels_equal_plain_kernel_2_and_tally_models(card, scene, block):
    rt, rays = scene
    table, lo, hi = (x.to(card) for x in (rt.tri_table, rt.chunk_lo, rt.chunk_hi))
    for kind, (o, d) in rays.items():
        o, d = o.to(card), d.to(card)
        ref = tk.trace_nearest_vpu(table, rt.n_tri, o, d)
        tally = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64, device=card)
        launches = tt.LAUNCHES_MM
        got = tt.trace_nearest_mm(table, o, d, block=block, tally=tally)
        assert tt.LAUNCHES_MM == launches + 1
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), kind
        assert all(torch.equal(a, b) for a, b in zip(got, tt.trace_nearest_mm_plain(
            table, o, d, block=block)))
        assert tuple(tally.tolist()) == tt.unculled_tally_plain(table, o, d, block)
        tally.zero_()
        launches = tt.LAUNCHES_MM2S
        got = tt.trace_nearest_mm2_stream(table, lo, hi, o, d, chunk=rt.cull_chunk,
                                          block=block, tally=tally)
        assert tt.LAUNCHES_MM2S == launches + 1
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), kind
        counts, lists = tt.chunk_lists(tt.cull_prepass_plain(lo, hi, o, d, block))
        plain, work = tt.listed_warp_plain(table, lo, hi, counts, lists, o, d,
                                           rt.cull_chunk, block)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        assert tuple(tally.tolist()) == work
