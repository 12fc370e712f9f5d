"""Whitted scenes with several emitters: the port's per-lane tree walk
with its emitter picks against the JAX package's wavefront.

The scene is `torch_scenes.two_emitter_cornell` (Cornell, a mirror and a
glass sphere, and a small sphere light beside the ceiling light), at
32x32 and max_depth 3. Both sides get the identical scene (the JAX
`RTScene` arrays, through `rt_scene_from_numpy`) and the same
`jax.random.PRNGKey`; the JAX target is `whitted_render_exact(uber=False)`,
the wavefront with its overflow pass, so no ray is dropped.

The picks are integers keyed by (key, depth, sample, ray id) and are
equal on both sides; the Phong terms follow the same formulas. So the
rule is the one of tests/test_torch_whitted.py: pixels agree within 5e-3
(the golden's tolerance), and every pixel that does not is a knife edge:
its camera ray meets an edge shared by two triangles, or its primary hit
is a specular sphere, behind which a child ray's flipped winner changes
the whole chain. At 32x32 the box's diagonals run through pixel centres
(35 of the 1024 camera rays meet a shared edge, and float32 rounding
flips a third of them), so the >= 99% share is taken over the pixels off
the knife edges.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.ops import intersect as ji
from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.whitted import whitted_render_exact as jexact
from software_rasterizer_tpu.render.raytracer import RayTracing as JRayTracing
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.utils.rng import lane_uniforms as jlane_uniforms
from software_rasterizer_tpu_torch import models as tmodels
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
from software_rasterizer_tpu_torch.ops.intersect import (
    prepare_rt_scene,
    rt_scene_from_numpy,
)
from software_rasterizer_tpu_torch.ops.whitted import (
    check_whitted_scene,
    whitted_render,
)
from software_rasterizer_tpu_torch.render import RayTracing, pipeline_from_config
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.utils.rng import prng_key
from torch_scenes import edge_tie_pixels, two_emitter_cornell

W = H = 32
DEPTH = 3
KEY = 3
PIX_TOL, PIX_SHARE = 5e-3, 0.99


@functools.lru_cache(maxsize=None)
def _setup():
    scene = two_emitter_cornell(jmodels, jcornell)
    scene.set_ndc_matrix(W, H)
    jrt = ji.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    return scene.fovy, jrt, arrays, rt_scene_from_numpy(arrays, "cpu")


@functools.lru_cache(maxsize=None)
def _both(spp):
    fovy, jrt, arrays, trt = _setup()
    want, wst = jexact(jrt, W, H, fovy, jax.random.PRNGKey(KEY), spp=spp,
                       max_depth=DEPTH, uber=False, return_stats=True)
    launches = wk.LAUNCHES
    got, st = whitted_render(trt, W, H, fovy, seed=KEY, spp=spp,
                             max_depth=DEPTH, with_stats=True)
    assert wk.LAUNCHES == launches          # CPU tensors: the plain version
    return got.numpy(), st, np.asarray(want), wst


@pytest.mark.parametrize("spp", [1, 4])
def test_two_emitters_match_jax_wavefront(spp):
    fovy, jrt, arrays, trt = _setup()
    assert trt.n_emitters == 2
    got, st, want, wst = _both(spp)
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    ok = np.isclose(got, want, rtol=PIX_TOL, atol=PIX_TOL).all(-1)
    orig, dirs = jcamera_rays(arrays["eye"], fovy, W, H)
    edge = edge_tie_pixels(arrays, np.asarray(dirs)).reshape(H, W)
    first = ji.nearest_hit(jrt, orig, dirs)
    specular = (np.asarray(first.hit) & (np.asarray(first.mat_type) != 0)
                ).reshape(H, W)
    knife = edge | specular
    assert ok[~knife].mean() >= PIX_SHARE, int((~ok & ~knife).sum())
    assert knife[~ok].all(), np.argwhere(~ok & ~knife)
    assert ok.mean() >= 1.0 - knife.mean()
    assert int(st["dropped_rays"]) == 0 and not bool(st["dropped_px"].any())
    for k in ("rays_main", "rays_shadow"):
        assert abs(int(st[k]) - int(wst[k])) <= 0.01 * int(wst[k]), (
            k, int(st[k]), int(wst[k]))
    # the specular spheres are in view: child rays pick emitters too
    assert int(st["rays_main"]) > W * H


def test_picks_differ_with_key_and_spp():
    fovy, _, _, trt = _setup()
    one = _both(1)[0]
    four = _both(4)[0]
    assert not np.array_equal(one, four)
    other = whitted_render(trt, W, H, fovy, seed=KEY + 1, spp=1,
                           max_depth=DEPTH).numpy()
    assert not np.array_equal(one, other)
    again = whitted_render(trt, W, H, fovy, seed=prng_key(KEY), spp=1,
                           max_depth=DEPTH).numpy()
    assert np.array_equal(one, again)            # a seed is its PRNGKey
    # with 4 picks a pixel sees a blend of the two lights more often
    diff = np.abs(one - four).max(-1)
    assert (diff > 1e-3).mean() > 0.2


@pytest.mark.parametrize("depth", [0, 2])
def test_picks_equal_jax_as_integers(depth):
    """The emitter each ray id picks at a depth, sample by sample."""
    n_e, spp = 3, 4
    seeds = wk.pick_seed_table(KEY, DEPTH, spp)
    assert seeds.shape == (DEPTH + 1, spp) and seeds.dtype == np.int32
    g = np.random.default_rng(depth)
    rid = np.concatenate([np.arange(64), g.integers(0, 2 ** 32, 1000)]
                         ).astype(np.uint32)
    key_d = jax.random.fold_in(jax.random.PRNGKey(KEY), depth)
    for s in range(spp):
        u = jlane_uniforms(key_d, jnp.asarray(rid.view(np.int32)), s)
        want = np.minimum(np.floor(np.asarray(u) * np.float32(n_e)).astype(np.int64),
                          n_e - 1)
        got = wk._pick_emitter(torch.from_numpy(rid.astype(np.int64)),
                               int(seeds[depth, s]), n_e).numpy()
        assert np.array_equal(got, want), (depth, s)
        assert set(np.unique(got)) == {0, 1, 2}


def test_lane_offset_keys_the_picks_by_absolute_pixel():
    """A window of the frame traced apart, with `lane_offset` its first
    pixel, reproduces the frame's pixels."""
    from software_rasterizer_tpu_torch.ops.camera import camera_rays

    fovy, _, _, trt = _setup()
    o, d = camera_rays(trt.eye.numpy(), fovy, W, H, "cpu")
    whole, _ = wk.whitted_uber_trace(trt, o, d, DEPTH, key=KEY, spp=2)
    lo, n = 11 * W, 6 * W
    part, _ = wk.whitted_uber_trace(trt, o[lo:lo + n].contiguous(),
                                    d[lo:lo + n].contiguous(), DEPTH, key=KEY,
                                    spp=2, lane_offset=lo)
    assert torch.equal(part, whole[lo:lo + n])
    moved, _ = wk.whitted_uber_trace(trt, o[lo:lo + n].contiguous(),
                                     d[lo:lo + n].contiguous(), DEPTH, key=KEY,
                                     spp=2)
    assert not torch.equal(moved, part)


def test_raytracing_draws_two_emitters_and_splits_its_key():
    """`RayTracing.draw()` renders the scene (it raised before the emitter
    picks were ported), and two draws of one pipeline differ, as the JAX
    package's do: the key is split for every scene drawn."""
    cfg = RenderConfig(width=W, height=H, spp=1, seed=KEY)
    render = pipeline_from_config(cfg, "whitted", device="cpu")
    assert isinstance(render, RayTracing)
    scene = two_emitter_cornell(tmodels, build_cornell_scene)
    scene.max_depth = DEPTH
    render.add_scene(scene)
    render.draw()
    first = render.frame.copy()
    assert first.shape == (H, W, 3) and np.isfinite(first).all()
    st = render.last_stats[scene.name]
    assert st["dropped_rays"] == 0 and st["rays_main"] > W * H
    render.draw()
    assert not np.array_equal(first, render.frame)

    # the first draw uses split(PRNGKey(seed))[1], as the JAX pipeline does
    # when its key is a threefry PRNGKey
    ref = JRayTracing(W, H, spp=1, seed=KEY)
    ref.key = jax.random.PRNGKey(KEY)
    jscene = two_emitter_cornell(jmodels, jcornell)
    jscene.max_depth = DEPTH
    ref.add_scene(jscene)
    ref.draw()
    ok = np.isclose(first, ref.frame, rtol=PIX_TOL, atol=PIX_TOL).all(-1)
    assert ok.mean() >= PIX_SHARE, int((~ok).sum())

    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    check_whitted_scene(rt, DEPTH)               # no emitter cap any more
    with pytest.raises(ValueError, match="stack bound"):
        check_whitted_scene(rt, wk.MAX_DEPTH + 1)


def test_one_emitter_frame_reads_neither_key_nor_spp():
    scene = build_cornell_scene()
    scene.set_ndc_matrix(W, H)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    base = whitted_render(rt, W, H, scene.fovy, max_depth=DEPTH)
    other, st = whitted_render(rt, W, H, scene.fovy, seed=9, spp=4,
                               max_depth=DEPTH, with_stats=True)
    assert torch.equal(base, other)
    # one emitter-table row: a diffuse hit is one shadow evaluation
    assert int(st["rays_shadow"]) <= int(st["rays_main"])
