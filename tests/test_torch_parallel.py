"""The port's sharded renders (software_rasterizer_tpu_torch/parallel) on a
group of 4 CPU ranks, against the port's single-rank renders and the JAX
package's sharded renders.

One process group of 4 gloo ranks (spawned once for the module, one
PyTorch thread each) runs every case of `torch_shards.cpu_cases`; the
tests here assert on what the ranks sent back. Each rank builds its own
scene and renders its slice through the kernels' wrappers, which run the
plain versions on CPU tensors.

Equalities held:
  * path, tile axis only ((1, 4)): bit for bit the single-rank
    `path_render`, on the camera-kernel route and the blocked wavefront
    (each lane's samples are summed in the same order, keyed by absolute
    pixel, sample and block);
  * path, (2, 2): bit for bit the two partial sums over samples [0, 2)
    and [2, 4) added (a two-rank all-reduce is one commutative
    addition), and within the JAX test's rtol = atol = 1e-4 of the
    single-rank render (float32 reassociation); (4, 1): that tolerance
    only, as gloo sums four ranks in an order of its own;
  * Whitted with one and two emitters, with stats and `_exact`: bit for
    bit the single-rank `whitted_render`, and the stats equal;
  * raster, deferred and shaded: image and z-buffer bit for bit the
    whole frame, `bin_dropped` equal.

Against the JAX package's sharded renders on a (2, 2) mesh of its
virtual CPU devices, with the tolerances of the monolithic parity tests
(tests/test_torch_whitted.py, test_torch_raster.py,
test_torch_path_kernel.py) and their knife-edge proofs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_shards as ts
from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.ops import intersect as ji
from software_rasterizer_tpu.ops import raster as jr
from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.ops.shading import ShaderType as JShaderType
from software_rasterizer_tpu.parallel import make_render_mesh as jmesh
from software_rasterizer_tpu.parallel import (
    sharded_path_render as jsharded_path,
    sharded_raster_render as jsharded_raster,
    sharded_whitted_render as jsharded_whitted,
)
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.scenes.stress import subdivide_mesh as jsubdivide
from software_rasterizer_tpu.utils.texture import Texture as JTexture
from software_rasterizer_tpu_torch.ops import raster as tr
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.path import path_render, path_render_accumulate
from software_rasterizer_tpu_torch.ops.path_kernel import path_camera_render
from software_rasterizer_tpu_torch.ops.raster_kernel import raster_tiles_fused
from software_rasterizer_tpu_torch.ops.whitted import whitted_render
from software_rasterizer_tpu_torch.parallel import (
    gather_image,
    initialize,
    make_render_mesh,
    process_info,
)
from torch_scenes import edge_tie_pixels, raster_cornell, raster_knife_edge_pixels, two_emitter_cornell

WORLD = 4
W, H, SPP, BOUNCES, BLOCK = ts.W, ts.H, ts.SPP, ts.BOUNCES, ts.BLOCK
SHARD_RTOL = SHARD_ATOL = 1e-4           # tests/test_parallel.py:56
EMITTERS_TOL, EMITTERS_SHARE = 5e-3, 0.99         # test_torch_whitted_emitters.py
LANE_RTOL, LANE_ATOL, LIT_SHARE = 1e-4, 1e-5, 0.80  # test_torch_path_kernel.py
WINNER_SHARE = 0.999                                 # test_torch_raster.py


@pytest.fixture(scope="module")
def ranks():
    return ts.run_ranks(WORLD, ts.cpu_cases)


@functools.lru_cache(maxsize=None)
def _cornell():
    return ts.cornell_rt(W, "cpu")


def _jmesh22():
    return jmesh(n_spp=2, n_tile=2, devices=jax.devices()[:WORLD])


# --------------------------------------------------------------- meshes


def test_mesh_rank_order(ranks):
    """Rank r sits at (r // n_tile, r % n_tile): the JAX mesh's spp-major
    device order. The default n_tile is world // n_spp."""
    for r, res in enumerate(ranks):
        for (n_spp, n_tile), coord in res["coords"].items():
            assert coord == (r // n_tile, r % n_tile, WORLD)
        assert res["default_mesh"] == (2, 2)
        assert res["one"] == (1, True)


def test_one_rank_mesh_in_process():
    """A (1, 1) mesh needs no process group, as the JAX one-device mesh."""
    m = make_render_mesh(1, 1, device="cpu")
    assert (m.n_spp, m.n_tile, m.n_devices, m.mesh, m.index) == (1, 1, 1, None, 0)
    assert m.device == torch.device("cpu")
    assert make_render_mesh(device="cpu").n_devices == 1


@pytest.mark.parametrize("case,args", [
    ("spp3", dict(n_spp=3)), ("2x4", dict(n_spp=2, n_tile=4))])
def test_bad_mesh_raises_the_jax_message(ranks, case, args):
    want = ""
    try:
        jmesh(devices=jax.devices()[:WORLD], **args)
    except ValueError as e:
        want = str(e)
    assert want and all(r["bad_mesh"][case] == want for r in ranks)


def test_mesh_must_span_every_rank(ranks):
    assert all("covers 2 of 4 ranks" in r["bad_mesh"]["2x1"] for r in ranks)


def test_bad_mesh_without_a_group():
    with pytest.raises(ValueError, match="1 devices not divisible by spp=2"):
        make_render_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        make_render_mesh(1, 2, device="cpu")


# ----------------------------------------------------------------- path


@functools.lru_cache(maxsize=None)
def _mono_path(fused):
    rt, fovy = _cornell()
    return path_render(rt, W, H, fovy, ts.PATH_SEED, spp=SPP, max_bounces=BOUNCES,
                       block=BLOCK, fused=fused).numpy()


def _partial_sums(fused):
    """(sum over samples [0, 2)) + (sum over [2, 4)) / 4, each part a
    single-rank render of the whole frame."""
    rt, fovy = _cornell()
    half = SPP // 2
    if fused:
        parts = [path_camera_render(rt, ts.PATH_SEED, W, H, fovy, half, start_sample=s,
                                    max_bounces=BOUNCES).T for s in (0, half)]
    else:
        o, d = (x.contiguous() for x in camera_rays(rt.eye.numpy(), fovy, W, H, "cpu"))
        parts = [path_render_accumulate(rt, o, d, ts.PATH_SEED, torch.zeros((W * H, 3)), s,
                                        half, max_bounces=BOUNCES, block=BLOCK, fused=False)
                 for s in (0, half)]
    return ((parts[0] + parts[1]) / float(SPP)).reshape(H, W, 3).numpy()


@pytest.mark.parametrize("shape", ts.MESHES)
@pytest.mark.parametrize("fused", [True, False], ids=["camera", "wavefront"])
def test_path_matches_single_rank(ranks, shape, fused):
    frames = [r["path"][shape, fused] for r in ranks]
    for f in frames[1:]:
        assert np.array_equal(f, frames[0])          # every rank has the frame
    got = frames[0]
    mono = _mono_path(fused)
    assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.max() > 0
    if shape == (1, 4):
        assert np.array_equal(got, mono)
    else:
        if shape == (2, 2):
            assert np.array_equal(got, _partial_sums(fused))
        np.testing.assert_allclose(got, mono, rtol=SHARD_RTOL, atol=SHARD_ATOL)


def test_fused_path_matches_jax_sharded(ranks):
    """The (2, 2) camera-kernel route against the JAX package's sharded
    fused render (interpret mode) at tests/test_parallel.py's 16x16,
    spp 4, 6 bounces: the lane rules of test_torch_path_kernel.py."""
    w = ts.FUSED_W
    scene = jcornell()
    scene.set_ndc_matrix(w, w)
    jrt = jax.tree_util.tree_map(jnp.asarray, jprepare(scene.rt_geometry(), scene.rt_frame()))
    want = np.asarray(jsharded_path(jrt, _jmesh22(), w, w, scene.fovy,
                                    jax.random.PRNGKey(ts.FUSED_SEED), spp=SPP,
                                    max_bounces=ts.FUSED_BOUNCES, fused=True))
    got = ranks[0]["path_jax"]
    want, got = want.reshape(-1, 3), got.reshape(-1, 3)
    lane_ok = np.isclose(got, want, rtol=LANE_RTOL, atol=LANE_ATOL).all(axis=1)
    lit = (got != 0).any(axis=1) | (want != 0).any(axis=1)
    assert lane_ok[~lit].all() and lit.sum() > 20
    assert lane_ok[lit].mean() >= LIT_SHARE, (int((~lane_ok).sum()), int(lit.sum()))


# -------------------------------------------------------------- Whitted


def _whitted_scene_rt(name):
    if name == "one":
        return ts.cornell_rt(W, "cpu")
    return ts.cornell_rt(W, "cpu", ts.two_emitter_scene)


@pytest.mark.parametrize("name", ["one", "two"], ids=["one_emitter", "two_emitters"])
def test_whitted_matches_single_rank(ranks, name):
    rt, fovy = _whitted_scene_rt(name)
    spp = 1 if name == "one" else ts.WHITTED_SPP
    mono, mst = whitted_render(rt, W, H, fovy, ts.WHITTED_SEED, spp=spp,
                               max_depth=ts.WHITTED_DEPTH, with_stats=True)
    mono = mono.numpy()
    assert mono.max() > 0
    for r in ranks:
        img, st, exact, ex_st, plain = r["whitted"][name]
        for frame in (img, exact, plain):
            assert np.array_equal(frame, mono)
        for stats in (st, ex_st):
            assert set(stats) == set(mst)
            for k, v in mst.items():
                assert np.array_equal(stats[k], v.numpy()), k


def test_whitted_matches_jax_sharded(ranks):
    """Two emitters on (2, 2) against the JAX sharded wavefront at
    lossless queue capacity, by tests/test_torch_whitted_emitters.py's
    rule for this scene and size: pixels agree within 5e-3 on >= 99% of
    the pixels off the knife edges, and every pixel that does not is one
    (its camera ray meets an edge shared by two triangles, or its primary
    hit is a specular sphere); the ray counts within 1%."""
    scene = two_emitter_cornell(jmodels, jcornell)
    scene.set_ndc_matrix(W, H)
    jrt = jprepare(scene.rt_geometry(), scene.rt_frame())
    md = ts.WHITTED_DEPTH
    want, wst = jsharded_whitted(jrt, _jmesh22(), W, H, scene.fovy,
                                 jax.random.PRNGKey(ts.WHITTED_SEED), spp=ts.WHITTED_SPP,
                                 max_depth=md, queue_factor=2 ** md, queue_shrink=1.0,
                                 with_stats=True)
    assert int(wst["dropped_rays"]) == 0
    want = np.asarray(want)
    got, st = ranks[0]["whitted"]["two"][:2]
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    orig, dirs = jcamera_rays(arrays["eye"], scene.fovy, W, H)
    first = ji.nearest_hit(jrt, orig, dirs)
    specular = (np.asarray(first.hit) & (np.asarray(first.mat_type) != 0)).reshape(H, W)
    knife = edge_tie_pixels(arrays, np.asarray(dirs)).reshape(H, W) | specular
    ok = np.isclose(got, want, rtol=EMITTERS_TOL, atol=EMITTERS_TOL).all(-1)
    assert ok[~knife].mean() >= EMITTERS_SHARE, int((~ok & ~knife).sum())
    assert knife[~ok].all(), np.argwhere(~ok & ~knife)
    for k in ("rays_main", "rays_shadow"):
        assert abs(int(st[k]) - int(wst[k])) <= 0.01 * int(wst[k]), (k, st[k], wst[k])


# --------------------------------------------------------------- raster


@pytest.fixture(scope="module")
def raster_mono():
    scene, active = ts.lit_raster_scene()
    g = tr.prepare_raster_geometry(scene.raster_geometry(), "cpu")
    frame = scene.raster_frame()
    out = {}
    for shaded in (False, True):
        img, z, st = tr.render_raster_frame(g, frame, ts.RASTER_SIZE, ts.RASTER_SIZE,
                                            active_types=active, shaded=shaded,
                                            with_stats=True)
        out[shaded] = (img.numpy(), z.numpy(), int(st["bin_dropped"]), st["kernel"])
    return out


@pytest.mark.parametrize("shaded", [False, True], ids=["deferred", "shaded"])
def test_raster_matches_single_rank(ranks, raster_mono, shaded):
    img, z, dropped, kernel = raster_mono[shaded]
    assert np.isfinite(z).mean() > 0.4
    for r in ranks:
        got = r["raster"][shaded]
        assert np.array_equal(got[0], img) and np.array_equal(got[1], z)
        assert got[2] == dropped and got[3] == kernel


def _jax_winners(geom, frame, height, width, row0, tile):
    """The JAX XLA route's winners of rows [row0, row0 + height): the
    front half of its `render_raster_frame` and `rasterize_tiles`."""
    pos, _ = jr.raster_vertex_stage(geom.positions, geom.normals, geom.vertex_mesh,
                                    frame.ndc_mvp, frame.normal_mat, frame.z_scale,
                                    frame.z_offset)
    tri_pos = pos[geom.faces]
    keep = jr.face_cull_mask(tri_pos, frame.eye, geom.face_valid)
    coef, zrow = jr.triangle_setup(tri_pos[..., :2], tri_pos[..., 2])
    xy = tri_pos[..., :2]
    bbox = jnp.concatenate([xy.min(axis=1), xy.max(axis=1)], axis=1)
    idx, _ = jr.rasterize_tiles(coef, zrow, keep, height, width, tile, 512, bbox, row0=row0)
    return np.asarray(idx)


def test_raster_matches_jax_sharded(ranks):
    """The deferred (2, 2) frame against the JAX package's sharded raster
    (XLA route): winners agree on >= 99.9% of pixels and every other
    one is a coverage or depth knife edge at its absolute row; on the
    agreeing pixels image and depth agree within test_torch_raster.py's
    rtol 1e-3 and 1e-4."""
    size = ts.RASTER_SIZE
    scene = raster_cornell(jmodels, jcornell, jsubdivide, JShaderType, JTexture,
                           ts.RASTER_LEVELS)
    scene.set_ndc_matrix(size, size)
    geom, frame = scene.raster_geometry(), scene.raster_frame()
    active = tuple(sorted(set(int(t) for t in geom.shader_type)))
    jimg, jz = (np.asarray(a) for a in jsharded_raster(geom, frame, _jmesh22(), size, size,
                                                       active_types=active))
    img, z = ranks[0]["raster"][False][:2]

    g = tr.prepare_raster_geometry(geom, "cpu")
    geo, attr, bbox, keep = tr.raster_tables(g, tr.prepare_raster_frame(frame, "cpu"))
    shard_h = size // WORLD
    differ, knife = [], []
    for dev in range(WORLD):
        row0 = dev * shard_h
        mine = raster_tiles_fused(geo, attr, bbox, keep, shard_h, size, row0=row0)
        mine = mine["best_idx"].numpy()
        theirs = _jax_winners(geom, frame, shard_h, size, row0, (shard_h, 128))
        differ.append(mine != theirs)
        knife.append(raster_knife_edge_pixels(geo.numpy(), mine, theirs, row0=row0))
    differ, knife = np.concatenate(differ), np.concatenate(knife)
    assert (~differ).mean() >= WINNER_SHARE, int(differ.sum())
    assert knife[differ].all(), int((differ & ~knife).sum())
    both = ~differ & np.isfinite(z) & np.isfinite(jz)
    assert both.mean() > 0.4 and np.array_equal(np.isfinite(z)[~differ], np.isfinite(jz)[~differ])
    np.testing.assert_allclose(img[both], jimg[both], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(z[both], jz[both], rtol=1e-4)


# ----------------------------------------------------- rules and runtime


@pytest.mark.parametrize("case,pattern", [
    ("spp", "spp"),
    ("pixels", "pixels not divisible by tile axis 4"),
    ("block", "block must divide"),
    ("whitted_pixels", "930 pixels not divisible by 4 devices"),
])
def test_validation_errors(ranks, case, pattern):
    for r in ranks:
        assert pattern in r["bad_args"][case]


def test_raster_height_rule(ranks):
    for r in ranks:
        assert r["raster_bad"] == "height 62 not divisible by 4 devices"


def test_gather_image_and_process_info(ranks):
    want = np.repeat(np.arange(WORLD, dtype=np.float32), 2)[:, None] * np.ones((1, 3))
    for r, res in enumerate(ranks):
        assert res["info"] == {"process_index": r, "process_count": WORLD,
                               "local_devices": 1, "global_devices": WORLD,
                               "backend": "gloo"}
        assert np.array_equal(res["gather"], want)


def test_gather_image_of_a_sharded_frame(ranks):
    """A sharded render's frame is whole on every rank: `gather_image`
    gives it back as one (H, W, 3) frame (the JAX `process_allgather` of
    a global array), not stacked once a rank; row blocks still stack
    (test_gather_image_and_process_info)."""
    for res in ranks:
        for fused in (True, False):
            got = res["gather_path", fused]
            assert got.shape == (H, W, 3)
            assert np.array_equal(got, res["path"][(2, 2), fused])
        for name in ("one", "two"):
            img, ex = res["gather_whitted", name]
            assert img.shape == ex.shape == (H, W, 3)
            assert np.array_equal(img, res["whitted"][name][0])
            assert np.array_equal(ex, res["whitted"][name][2])
        for shaded in (False, True):
            img, zb = res["gather_raster", shaded]
            assert img.shape == (ts.RASTER_SIZE, ts.RASTER_SIZE, 3)
            assert zb.shape == (ts.RASTER_SIZE, ts.RASTER_SIZE)
            assert np.array_equal(img, res["raster"][shaded][0])
            assert np.array_equal(zb, res["raster"][shaded][1])


def test_single_process_is_left_alone():
    assert initialize(device="cpu") is False
    assert process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                              "global_devices": 1, "backend": None}
    img = torch.ones((4, 4, 3))
    out = gather_image(img)
    assert isinstance(out, np.ndarray) and out.shape == (4, 4, 3)


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_ranks_on_the_cards():
    """On the machine's cards, max(2, cards) ranks: two ranks sharing one
    card (gloo), or one rank a card (NCCL), by `initialize`'s rule. Path
    (camera kernel) and Whitted on a 64x64 Cornell box equal the
    single-rank renders bit for bit on a (1, world) mesh (Whitted on a
    (world, 1) one too; the path there within SHARD_RTOL); one launch of
    each kernel per rank and call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    w, cards = 64, torch.cuda.device_count()
    world = max(2, cards)
    results = ts.run_ranks(world, ts.card_cases, (w,), device="cuda")
    rt, fovy = ts.cornell_rt(w, "cuda")
    mono_p = path_render(rt, w, w, fovy, ts.PATH_SEED, spp=SPP,
                         max_bounces=BOUNCES).cpu().numpy()
    mono_w = whitted_render(rt, w, w, fovy, ts.WHITTED_SEED,
                            max_depth=ts.WHITTED_DEPTH).cpu().numpy()
    assert [r["device"] for r in results] == [f"cuda:{i % cards}" for i in range(world)]
    for res in results:
        assert res["backend"] == ("nccl" if world <= cards else "gloo")
        path, whitted, p_launches, w_launches = res[1, world]
        assert np.array_equal(path, mono_p) and np.array_equal(whitted, mono_w)
        assert (p_launches, w_launches) == (1, 1)
        path, whitted, _, _ = res[world, 1]
        np.testing.assert_allclose(path, mono_p, rtol=SHARD_RTOL, atol=SHARD_ATOL)
        assert np.array_equal(whitted, mono_w)
