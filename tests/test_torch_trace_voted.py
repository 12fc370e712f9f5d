"""Kernels #2 (csrc/trace_nearest.cu, the small-scene nearest hit) and #7
(csrc/trace_culled.cu trace_listed_all_kernel, the listed sweep) in their
warp-voted two-stage form, on the CPU: the plain models of the work they
count (`trace_kernel.TALLY_NAMES`) and of their results.

  * `trace_tiers.nearest_tally_plain` (kernel #2's tally: every warp of
    the grid sweeps the first n_tri rows with each of its ray slots, a
    lane past N holding the zero ray) equals a brute count warp by warp
    and row by row, at 1, 2 and 4 ray slots a thread, on Cornell camera
    and bounce rays at 64x64 and on adversarial rays (d = 0, NaN, +-inf,
    a ray through an edge two triangles share, a row duplicated for a
    tie, a zero row); `trace_nearest_vpu(tally=)` adds it on the CPU;
  * the two-stage test's plain form (`mt_plane_two_stage`) swept by
    `plane_winner` equals `trace_nearest_vpu_plain` ray for ray, bit for
    bit, on the same sets;
  * `listed_warp_plain(vote=False)` (kernel #7: every warp of a ray block
    sweeps every listed chunk) equals `trace_listed_plain` bit for bit,
    and its tally a brute count, on `torch_scenes.stress_cornell` at
    levels 2 and 3 and ray blocks of 32, 64 and 2048;
    `trace_nearest_mm2(tally=)` adds it on the CPU;
  * the JAX `trace_nearest_vpu` and `trace_nearest_mm2` in interpret mode
    agree with the plain versions on their winners, bar the knife edges
    `torch_scenes.mt_knife_edge_rays` proves (as
    tests/test_torch_trace_kernel.py and test_torch_trace_tiers.py hold
    them);
  * `cuda`-marked: kernel #2 (a table of at most 1024 rows, staged in
    shared memory, and one above, read through the cache) and kernel #7
    (ray blocks of 64 and 1024) equal their plain versions and kernel #2
    bit for bit, and their tallies their models (skipped without a card).

Inputs come from NumPy seeds; every comparison but the JAX one is exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops import pallas_trace as jpt
from software_rasterizer_tpu_torch.ops import intersect as ti
from software_rasterizer_tpu_torch.ops import trace_kernel as tk
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import mt_tri_table
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from torch_scenes import mt_knife_edge_rays, stress_cornell
from test_torch_trace_tiers import BLOCK, _jax_operands, _torch_operands

BIG = 1e30
SIZE = 64          # Cornell's frame
STRESS_SIZE = 32   # stress_cornell's frame


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch intra-op thread a test process for this module, as in
    tests/test_torch_cull_two_level.py (several processes each running the
    pool on every core oversubscribe the CPU), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bounce(rt, o, d, seed):
    """Rays leaving the hit points of `o`, `d` in seeded directions turned
    into the normal's hemisphere; a ray that missed keeps its camera ray."""
    hit = ti.nearest_hit(rt, o, d, backend="vpu")
    g = np.random.RandomState(seed)
    w = torch.from_numpy(g.randn(o.shape[0], 3).astype(np.float32))
    w = w / torch.sqrt((w * w).sum(dim=1, keepdim=True))
    w = torch.where(((w * hit.normal).sum(dim=1) < 0)[:, None], -w, w)
    o2 = torch.where(hit.hit[:, None], hit.coords + 1e-6 * hit.normal, o).contiguous()
    d2 = torch.where(hit.hit[:, None], w, d).contiguous()
    return o2, d2


def _cornell():
    """Cornell's table, its triangle count, and its camera and bounce rays
    at 64x64 less 40 (a short last block)."""
    sc = build_cornell_scene()
    sc.set_ndc_matrix(SIZE, SIZE)
    rt = ti.prepare_rt_scene(sc.rt_geometry(), sc.rt_frame(), "cpu")
    o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), sc.fovy, SIZE, SIZE, "cpu"))
    o2, d2 = _bounce(rt, o, d, 3)
    return rt.tri_table, rt.n_tri, {"camera": (o[:-40], d[:-40]),
                                    "bounce": (o2[:-40], d2[:-40])}


def _adversarial():
    """A table and rays on every edge of the test: two triangles that share
    the diagonal of the unit square at z = 1, a copy of the first (a tie
    that the lower row must win), a zero row inside the loop bound, a
    triangle behind; rays along +z through the shared edge, a vertex, each
    interior, and rays with d = 0, NaN or +-inf components; then seeded
    random rays. (table (5,12), 5, orig (N,3), d (N,3))."""
    v = np.array([[[0, 0, 1], [1, 0, 1], [0, 1, 1]],
                  [[1, 1, 1], [0, 1, 1], [1, 0, 1]],
                  [[0, 0, 1], [1, 0, 1], [0, 1, 1]],
                  [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
                  [[0, 0, 3], [2, 0, 3], [0, 2, 3]]], np.float32)
    valid = np.array([True, True, True, False, True])
    table = mt_tri_table(*(torch.from_numpy(np.ascontiguousarray(v[:, k]))
                           for k in range(3)), torch.from_numpy(valid))
    inf, nan = np.inf, np.nan
    orig = [[0.5, 0.5, 0], [0, 0, 0], [1, 0, 0], [0.25, 0.25, 0], [0.75, 0.75, 0],
            [0.3, 0.3, 0], [0.3, 0.3, 0], [nan, 0.3, 0], [0.3, 0.3, 0], [0.3, 0.3, 0],
            [-inf, 0.3, 0], [0.3, 0.3, 0], [1.5, 0.2, 0]]
    d = [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1],
         [0, 0, 0], [0, nan, 1], [0, 0, 1], [inf, 0, 1], [0, -inf, 1],
         [0, 0, 1], [0, 0, -inf], [0, 0, 1]]
    g = np.random.RandomState(8)
    orig += (g.rand(27, 3) * 2 - [0.5, 0.5, 1.0]).tolist()
    d += (g.rand(27, 3) * 2 - [1.0, 1.0, -0.2]).tolist()
    return (table, 5, torch.tensor(np.asarray(orig, np.float32)),
            torch.tensor(np.asarray(d, np.float32)))


SETS = ["adversarial", "cornell bounce", "cornell camera"]


@functools.lru_cache(maxsize=None)
def _set(name):
    """(table, n_tri, orig, d) of one of SETS, made once a process."""
    if name == "adversarial":
        return _adversarial()
    table, n_tri, rays = _cornell()
    return (table, n_tri, *rays[name.split()[1]])


def _brute_nearest(table, n_tri, o, d, rays):
    """Kernel #2's tally from its launch layout itself: block b of 128
    threads, thread k holding rays b * 128 * rays + k + j * 128; every
    warp of the grid, every slot, every row < n_tri a warp-step."""
    n = o.shape[0]
    ok1 = tk.mt_stage1_plane(o, d, table[:n_tri]).numpy()              # (n, n_tri)
    zero = tk.mt_stage1_plane(torch.zeros((1, 3)), torch.zeros((1, 3)),
                              table[:n_tri]).numpy()[0]
    threads = 128
    work = np.zeros(tk.TALLY_ENTRIES, np.int64)
    for b in range(-(-n // (threads * rays))):
        for w in range(threads // 32):
            for j in range(rays):
                lane_rays = [b * threads * rays + w * 32 + lane + j * threads
                             for lane in range(32)]
                present = [r for r in lane_rays if r < n]
                pas = np.zeros(n_tri, bool)
                for r in lane_rays:
                    pas |= ok1[r] if r < n else zero
                work[0] += n_tri
                work[1] += int(pas.sum())
                work[2] += len(present) * n_tri
                work[3] += len(present) * int(pas.sum())
                work[7] += sum(int(ok1[r].sum()) for r in present)
    return tuple(int(x) for x in work)


@pytest.mark.parametrize("rays", [1, 2, 4])
@pytest.mark.parametrize("name", SETS)
def test_nearest_tally_model_equals_a_brute_count(name, rays):
    table, n_tri, o, d = _set(name)
    work = tt.nearest_tally_plain(table, n_tri, o, d, rays=rays)
    assert work == _brute_nearest(table, n_tri, o, d, rays)
    steps, voted, tests, full, slabs, pairs, skipped, passes = work
    assert 0 < voted < steps and 0 < passes <= full < tests
    assert slabs == pairs == skipped == 0
    assert tests == o.shape[0] * n_tri
    if rays == tk.NEAREST_RAYS:
        # the entry point adds the model on the CPU
        tally = torch.zeros(tk.TALLY_ENTRIES, dtype=torch.int64)
        tk.trace_nearest_vpu(table, n_tri, o, d, tally=tally)
        tk.trace_nearest_vpu(table, n_tri, o, d, tally=tally)
        assert tuple(tally.tolist()) == tuple(2 * x for x in work)


def test_nearest_warp_layout():
    ids = tt.nearest_warp_rays(300, 2, "cpu")        # 256 rays a block of 128 threads
    assert ids.shape == (8, 2, 32)
    assert ids[1, 1, 3].item() == 32 + 3 + 128
    assert ids[4, 0, 0].item() == 256 and ids[5, 0, 11].item() == 299
    assert ids[5, 0, 12].item() == -1 and (ids[4:, 1] == -1).all()
    assert sorted(ids[ids >= 0].tolist()) == list(range(300))
    # the camera rays of one slot's warp are 32 consecutive rays
    assert (ids[:4, :, 1:] - ids[:4, :, :-1] == 1).all()


@pytest.mark.parametrize("name", SETS)
def test_two_stage_sweep_equals_the_plain_sweep(name):
    table, n_tri, o, d = _set(name)
    staged = tk.mt_plane_two_stage(o, d, table[:n_tri])
    assert torch.equal(staged.view(torch.int32), tk.mt_plane(o, d, table[:n_tri])
                       .view(torch.int32))
    ct, cf = tk.plane_winner(staged)
    hit, idx, t = tk.trace_nearest_vpu_plain(table, n_tri, o, d)
    assert torch.equal(t.view(torch.int32), ct.view(torch.int32))
    assert torch.equal(idx, torch.where(hit, cf, -1))
    assert bool(hit.any()) and bool((~hit).any())
    if name == "adversarial":
        # the shared edge is hit by its lower row, the copy of row 0 loses
        # the tie, the zero row never wins; d = 0, NaN and inf rays miss
        assert idx[:5].tolist() == [0, 0, 0, 0, 1]
        assert not hit[5:12].any() and idx[12].item() == 4
        assert not bool(((idx == 2) | (idx == 3)).any())


def test_jax_vpu_trace_agrees_with_the_plain_version():
    table, n_tri, o, d = _set("adversarial")
    got = [x.numpy() for x in tk.trace_nearest_vpu(table, n_tri, o, d)]
    want = [np.asarray(x) for x in jpt.trace_nearest_vpu(
        jnp.asarray(table.numpy()), jnp.asarray(n_tri, jnp.int32), jnp.asarray(o.numpy()),
        jnp.asarray(d.numpy()), interpret=True)]
    finite = np.isfinite(o.numpy()).all(axis=1) & np.isfinite(d.numpy()).all(axis=1)
    # rays with a NaN or an inf component miss on both sides
    assert not got[0][~finite].any() and not want[0][~finite].any()
    same = got[1] == want[1]
    edge = mt_knife_edge_rays(table.numpy(), o.numpy()[finite], d.numpy()[finite],
                              got[1][finite], want[1][finite])
    assert edge[~same[finite]].all(), np.flatnonzero(~same & finite)
    assert np.array_equal(got[0][same], want[0][same])
    assert same.mean() >= 0.9


@pytest.fixture(scope="module")
def stress():
    """stress_cornell at levels 2 and 3 (576 and 2,304 triangles) with
    camera rays and bounce rays at 32x32, less 40 (a short last block)."""
    out = {}
    for levels in (2, 3):
        sc = stress_cornell(build_cornell_scene, subdivide_mesh, levels)
        sc.set_ndc_matrix(STRESS_SIZE, STRESS_SIZE)
        rt = ti.prepare_rt_scene(sc.rt_geometry(), sc.rt_frame(), "cpu")
        o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), sc.fovy, STRESS_SIZE,
                                                    STRESS_SIZE, "cpu"))
        o2, d2 = _bounce(rt, o, d, 9)
        out[levels] = (rt, {"camera": (o[:-40], d[:-40]), "bounce": (o2[:-40], d2[:-40])})
    return out


def _brute_listed(rt, o, d, block, listed):
    """Kernel #7's tally from its launch layout (thread k of a block holds
    rays k + j * threads): every warp of ray block b sweeps every row of
    every chunk of listed[b] with each of its slots."""
    n = o.shape[0]
    threads = min(block, 256)
    rays = next(r for r in (1, 2, 4, 8) if r * threads >= block)
    table = rt.tri_table
    n_rows = table.shape[0]
    ok1 = tk.mt_stage1_plane(o, d, table).numpy()
    zero = tk.mt_stage1_plane(torch.zeros((1, 3)), torch.zeros((1, 3)), table).numpy()[0]
    work = np.zeros(tk.TALLY_ENTRIES, np.int64)
    for b in range(-(-n // block)):
        for w in range(threads // 32):
            for c in listed[b]:
                r0, r1 = c * rt.cull_chunk, min((c + 1) * rt.cull_chunk, n_rows)
                for j in range(rays):
                    lane_rays = [b * block + w * 32 + lane + j * threads
                                 if w * 32 + lane + j * threads < block else n
                                 for lane in range(32)]
                    present = [r for r in lane_rays if r < n]
                    pas = np.zeros(r1 - r0, bool)
                    for r in lane_rays:
                        pas |= ok1[r, r0:r1] if r < n else zero[r0:r1]
                    work[0] += r1 - r0
                    work[1] += int(pas.sum())
                    work[2] += len(present) * (r1 - r0)
                    work[3] += len(present) * int(pas.sum())
                    work[7] += sum(int(ok1[r, r0:r1].sum()) for r in present)
    return tuple(int(x) for x in work)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("block", [32, 64, 2048])
@pytest.mark.parametrize("levels", [2, 3])
def test_listed_model_without_vote_equals_the_listed_sweep(stress, levels, block, kind):
    rt, rays = stress[levels]
    o, d = rays[kind]
    counts, lists = tt.chunk_lists(tt.cull_prepass_plain(rt.chunk_lo, rt.chunk_hi, o, d,
                                                         block))
    want = tt.trace_listed_plain(rt.tri_table, counts, lists, o, d, rt.cull_chunk, block)
    got, work = tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, counts, lists,
                                     o, d, rt.cull_chunk, block, vote=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    assert bool(got[0].any())
    listed = [lists[b, :int(counts[b])].tolist() for b in range(counts.shape[0])]
    assert work == _brute_listed(rt, o, d, block, listed)
    steps, voted, tests, full, slabs, pairs, skipped, passes = work
    assert 0 < voted < steps and 0 < passes <= full < tests
    assert slabs == pairs == skipped == 0
    # the voted form sweeps no more rows than this one
    assert tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, counts, lists, o, d,
                                rt.cull_chunk, block)[1][0] <= steps
    if block == 64:
        # the entry point adds the model on the CPU
        tally = torch.zeros(tk.TALLY_ENTRIES, dtype=torch.int64)
        out = tt.trace_nearest_mm2(rt.tri_table, rt.chunk_lo, rt.chunk_hi, o, d,
                                   chunk=rt.cull_chunk, block=block, tally=tally)
        assert tuple(tally.tolist()) == work
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_jax_listed_tier_agrees_with_the_plain_version():
    table, lo, hi, orig, d = _torch_operands("300 in chunks of 64")
    counts, lists = tt.chunk_lists(tt.cull_prepass(lo, hi, orig, d, BLOCK))
    got, work = tt.listed_warp_plain(table, lo, hi, counts, lists, orig, d, 64, BLOCK,
                                     vote=False)
    assert all(torch.equal(a, b) for a, b in zip(
        got, tt.trace_listed_plain(table, counts, lists, orig, d, 64, BLOCK)))
    _, coef, jlo, jhi, jo, jd = _jax_operands("300 in chunks of 64")
    want = jpt.trace_nearest_mm2(coef, jlo, jhi, jo, jd, chunk=64, block=BLOCK,
                                 interpret=True)
    g_idx, w_idx = got[1].numpy(), np.asarray(want[1])
    same = g_idx == w_idx
    assert same.mean() >= 0.995, int((~same).sum())
    edge = mt_knife_edge_rays(table.numpy(), orig.numpy(), d.numpy(), g_idx, w_idx)
    assert edge[~same].all()
    assert np.array_equal(got[0].numpy()[same], np.asarray(want[0])[same])
    assert work[4] == work[5] == work[6] == 0


def test_listed_tally_without_boxes_and_bad_operands():
    table, lo, hi, orig, d = _torch_operands("300 in chunks of 64")
    counts, lists = tt.chunk_lists(tt.cull_prepass(lo, hi, orig, d, BLOCK))
    with pytest.raises(ValueError, match="tally"):
        tt.trace_nearest_mm2(table, lo, hi, orig, d, chunk=64, block=BLOCK,
                             tally=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="int64"):
        tk.trace_nearest_vpu(table, 300, orig, d, tally=torch.zeros(tk.TALLY_ENTRIES))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tt.launch_trace_listed(table, counts, lists, orig, d, 64, BLOCK,
                               tally=torch.zeros(tk.TALLY_ENTRIES, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.launch_trace_nearest(table, 300, orig, d,
                                tally=torch.zeros(tk.TALLY_ENTRIES, dtype=torch.int64))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _same(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + ["stress 3 camera", "stress 3 bounce"])
def test_nearest_kernel_equals_plain_and_its_tally_model(card, stress, name):
    if name.startswith("stress"):
        rt, rays = stress[3]                       # 2,304 rows: read through the cache
        o, d = rays[name.split()[-1]]
        table, n_tri = rt.tri_table, rt.n_tri
        assert n_tri > 1024
    else:
        table, n_tri, o, d = _set(name)
    plain = tk.trace_nearest_vpu_plain(table, n_tri, o, d)
    table, o, d = table.to(card), o.to(card), d.to(card)
    launches = tk.LAUNCHES
    got = tk.trace_nearest_vpu(table, n_tri, o, d)
    tally = torch.zeros(tk.TALLY_ENTRIES, dtype=torch.int64, device=card)
    counted = tk.trace_nearest_vpu(table, n_tri, o, d, tally=tally)
    assert tk.LAUNCHES == launches + 2
    assert _same(got, plain) and _same(counted, plain), name
    assert tuple(tally.tolist()) == tt.nearest_tally_plain(table, n_tri, o, d)
    # a table off a 16-byte boundary is copied, not misread
    shifted = torch.empty(table.numel() + 1, device=card)[1:].view(table.shape)
    shifted.copy_(table)
    assert _same(tk.trace_nearest_vpu(shifted, n_tri, o, d), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 1024])
def test_listed_kernel_equals_plain_kernel_2_and_its_tally_model(card, stress, block):
    for levels in (2, 3):
        rt, rays = stress[levels]
        table, lo, hi = (x.to(card) for x in (rt.tri_table, rt.chunk_lo, rt.chunk_hi))
        for kind, (o, d) in rays.items():
            o, d = o.to(card), d.to(card)
            counts, lists = tt.chunk_lists(tt.cull_prepass(lo, hi, o, d, block))
            tally = torch.zeros(tk.TALLY_ENTRIES, dtype=torch.int64, device=card)
            launches = tt.LAUNCHES_MM2
            got = tt.launch_trace_listed(table, counts, lists, o, d, rt.cull_chunk, block,
                                         tally=tally)
            assert tt.LAUNCHES_MM2 == launches + 1
            plain, work = tt.listed_warp_plain(table, lo, hi, counts, lists, o, d,
                                               rt.cull_chunk, block, vote=False)
            assert _same(got, plain), (levels, kind)
            assert _same(got, tt.trace_listed_plain(table, counts, lists, o, d,
                                                    rt.cull_chunk, block))
            assert tuple(tally.tolist()) == work, (levels, kind)
            assert _same(tt.trace_nearest_mm2(table, lo, hi, o, d, chunk=rt.cull_chunk,
                                              block=block), plain)
            ref = tk.trace_nearest_vpu(table, rt.n_tri, o, d)
            off = (got[1] != ref[1]).cpu().numpy()
            if off.any():
                from torch_scenes import slab_knife_edge_rays

                proof = slab_knife_edge_rays(rt.chunk_lo.numpy(), rt.chunk_hi.numpy(),
                                             rt.cull_chunk, o.cpu().numpy()[off],
                                             d.cpu().numpy()[off], ref[1].cpu().numpy()[off])
                assert proof.all(), (levels, kind)
