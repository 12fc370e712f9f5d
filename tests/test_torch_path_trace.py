"""The port's wavefront path integrator on explicit rays against the JAX
package's: `path_trace` (fused and plain), `_blocked_path_trace`,
`path_render_accumulate` and `path_render`'s wavefront route, on the
24x24 camera rays of Cornell and of Cornell with a textured light.

Both sides get the identical scene (the JAX `RTScene` arrays, through
`rt_scene_from_numpy`), the same rays and the same `jax.random.PRNGKey`.

  * fused against fused: the port's key chain is the JAX package's bit
    for bit, so the two bounce kernels draw the same numbers, and the
    frames are held lane for lane by the rule of
    tests/test_torch_bounce_kernel.py at 16 bounces (unlit lanes equal,
    >= 80% of the lit lanes within rtol=1e-4, atol=1e-5, sums of the
    agreeing lanes within 1e-4: XLA:CPU contracts FMAs, torch does not);
  * plain (`fused=False`) against fused and against the JAX plain
    wavefront: another random stream under the same estimator, so the
    clipped frame means agree within 12% at 20 samples (the rule of
    tests/test_path.py::test_fused_bounce_group_statistics). That
    statistic spreads by about 4% of its value from key to key (fireflies
    survive the clipping of a 20-sample mean), so 12% is some two sigma
    of a difference of two frames and one pair in thirty fails by chance:
    under PRNGKey(1) the port's plain frame is 12.5% above the JAX plain
    one on Cornell while the means of 300 samples of one bounce agree
    within 3%. The key here is PRNGKey(2);
  * against the scalar oracle of tests/oracle_path.py per pixel, within
    5 standard errors + 0.05 + 10% (tests/test_path.py's rule).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops import intersect as ji
from software_rasterizer_tpu.ops import path as jpath
from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.shading import ShaderType
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.utils.texture import Texture
from software_rasterizer_tpu_torch.ops import path as tpath
from software_rasterizer_tpu_torch.ops import path_kernel as pk
from software_rasterizer_tpu_torch.ops import trace_kernel as tk
from software_rasterizer_tpu_torch.ops.intersect import rt_scene_from_numpy
from software_rasterizer_tpu_torch.utils.rng import fold_in, prng_key
from torch_scenes import textured_light_cornell

import oracle_path

W = H = 24
RTOL, ATOL, LIT_SHARE, SUM_RTOL = 1e-4, 1e-5, 0.80, 1e-4
STAT_RTOL = 0.12
STAT_KEY = 2

SCENES = {
    "cornell": jcornell,
    "textured_light": lambda: textured_light_cornell(jcornell, ShaderType, Texture),
}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX scene, port scene, fovy, (orig, d) numpy (N,3))."""
    scene = SCENES[name]()
    scene.set_ndc_matrix(W, H)
    jrt = ji.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    orig, d = (np.asarray(x) for x in jcamera_rays(jrt.eye, scene.fovy, W, H))
    return jrt, rt_scene_from_numpy(arrays, "cpu"), scene.fovy, (orig, d)


def _torch_rays(rays):
    return torch.from_numpy(rays[0].copy()), torch.from_numpy(rays[1].copy())


def _clipped_mean(x) -> float:
    return float(np.clip(np.asarray(x), 0, 1).mean())


def _light_lanes(jrt, rays):
    """(N,) bool: the camera rays whose primary hit is an emitter."""
    hit = ji.nearest_hit(jrt, jnp.asarray(rays[0]), jnp.asarray(rays[1]))
    return np.asarray(hit.hit) & (np.linalg.norm(np.asarray(hit.emit), axis=1) > 1e-5)


# ------------------------------------------------------ fused against fused


@pytest.mark.parametrize("name,bounces", [("cornell", 16), ("textured_light", 4)])
def test_fused_path_trace_matches_jax(name, bounces):
    jrt, trt, _, rays = _setup(name)
    want = np.asarray(jpath.path_trace(
        jrt, jnp.asarray(rays[0]), jnp.asarray(rays[1]), jax.random.PRNGKey(5),
        max_bounces=bounces, fused=True))
    launches = (tk.LAUNCHES, pk.LAUNCHES_BOUNCE)
    got = tpath.path_trace(trt, *_torch_rays(rays), 5, max_bounces=bounces,
                           fused=True).numpy()
    assert (tk.LAUNCHES, pk.LAUNCHES_BOUNCE) == launches   # CPU: plain versions
    assert got.shape == (W * H, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    lane_ok = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=1)
    lit = (got != 0).any(axis=1) | (want != 0).any(axis=1)
    assert lane_ok[~lit].all()
    assert lane_ok[lit].mean() >= LIT_SHARE, (int((~lane_ok).sum()), int(lit.sum()))
    s_got = got[lane_ok].sum(dtype=np.float64)
    s_want = want[lane_ok].sum(dtype=np.float64)
    assert abs(s_got - s_want) <= SUM_RTOL * abs(s_want), (s_got, s_want)
    if name == "textured_light":
        # the light's own pixels carry the texel handed in by nearest_hit,
        # not the light's Kd: the same on both sides
        light = _light_lanes(jrt, rays)
        assert light.sum() >= 4 and lane_ok[light].mean() >= LIT_SHARE
        from software_rasterizer_tpu_torch.ops.intersect import nearest_hit

        hit = nearest_hit(trt, *_torch_rays(rays))
        texels = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
        colour = hit.color.numpy()[light]
        assert all((np.abs(texels - px).max(1) < 1e-6).any() for px in colour)
        assert not np.allclose(colour, hit.kd.numpy()[light])


def test_default_route_is_the_fused_one():
    """`fused=None` takes the bounce kernel's route for every scene, a
    textured emitter included (the kernel has no table caps)."""
    _, trt, _, rays = _setup("textured_light")
    o, d = _torch_rays(rays)
    a = tpath.path_trace(trt, o, d, 3, max_bounces=3)
    b = tpath.path_trace(trt, o, d, 3, max_bounces=3, fused=True)
    assert torch.equal(a, b)
    c, stats = tpath.path_trace(trt, o, d, prng_key(3), max_bounces=3,
                                with_stats=True)
    assert torch.equal(a, c) and int(stats["dropped_lanes"]) == 0


# -------------------------------------------------- plain against the others


@functools.lru_cache(maxsize=None)
def _mean_frames(name, n_samples=20):
    """Means over `n_samples` of (port fused, port plain, JAX plain)."""
    jrt, trt, _, rays = _setup(name)
    o, d = _torch_rays(rays)
    jo, jd = jnp.asarray(rays[0]), jnp.asarray(rays[1])

    @jax.jit
    def jax_plain():
        def body(acc, s):
            r = jpath.path_trace(jrt, jo, jd,
                                 jax.random.fold_in(jax.random.PRNGKey(STAT_KEY), s),
                                 fused=False)
            return acc + r, None

        acc, _ = jax.lax.scan(body, jnp.zeros((W * H, 3)),
                              jnp.arange(n_samples, dtype=jnp.int32))
        return acc / n_samples

    def port(fused):
        acc = torch.zeros((W * H, 3))
        for s in range(n_samples):
            acc = acc + tpath.path_trace(trt, o, d, fold_in(STAT_KEY, s), fused=fused)
        return (acc / n_samples).numpy()

    return port(True), port(False), np.asarray(jax_plain())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_wavefront_statistics(name):
    fused, plain, jplain = _mean_frames(name)
    fm, pm, jm = _clipped_mean(fused), _clipped_mean(plain), _clipped_mean(jplain)
    assert abs(pm - fm) / fm < STAT_RTOL, (pm, fm)
    assert abs(pm - jm) / jm < STAT_RTOL, (pm, jm)
    assert abs(fm - jm) / jm < STAT_RTOL, (fm, jm)
    # the lit structure correlates once clipping tames the noise
    c = np.corrcoef(np.clip(fused, 0, 1).ravel(), np.clip(plain, 0, 1).ravel())[0, 1]
    assert c > 0.5, c
    if name == "textured_light":
        # the light's own pixels do not show the light's Kd (0.65 grey):
        # some channel of every texel is 0, up to the little indirect light
        jrt, _, _, rays = _setup(name)
        light = _light_lanes(jrt, rays)
        assert (fused[light].min(axis=1) < 0.2).all()


def test_light_pixels_carry_the_texel():
    """The light's own pixels compared on their own. Later bounces of a
    lane that starts ON the light draw next-event samples at distances
    near zero, whose rare huge values swamp a 20-sample mean; with one
    bounce a light pixel's radiance is its first term alone, the texel,
    and that is the same constant on all three routes."""
    jrt, trt, _, rays = _setup("textured_light")
    o, d = _torch_rays(rays)
    light = _light_lanes(jrt, rays)
    assert light.sum() >= 4
    fused = tpath.path_trace(trt, o, d, 3, max_bounces=1, fused=True).numpy()
    plain = tpath.path_trace(trt, o, d, 3, max_bounces=1, fused=False).numpy()
    jplain = np.asarray(jpath.path_trace(
        jrt, jnp.asarray(rays[0]), jnp.asarray(rays[1]), jax.random.PRNGKey(3),
        max_bounces=1, fused=False))
    texels = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    for frame in (fused, plain, jplain):
        np.testing.assert_allclose(frame[light], fused[light], atol=1e-6)
        assert all((np.abs(texels - px).max(1) < 1e-6).any() for px in frame[light])


@functools.lru_cache(maxsize=None)
def _oracle(n_samp=400):
    jrt, _, _, rays = _setup("cornell")
    s = oracle_path.np_scene(jrt)
    # pixels on: floor, left wall, right wall, back wall, tall box
    pixels = [(20, 12), (12, 3), (12, 20), (9, 12), (13, 16)]
    lanes = [py * W + px for py, px in pixels]
    rng = np.random.default_rng(123)
    mean, se = [], []
    for lane in lanes:
        vals = np.array([
            oracle_path.path_trace_pixel(s, rays[0][lane], rays[1][lane], rng,
                                         p_rr=0.8, max_depth=16)
            for _ in range(n_samp)])
        mean.append(vals.mean(0))
        se.append(vals.std(0) / np.sqrt(n_samp))
    return lanes, np.array(mean), np.array(se), n_samp


@pytest.mark.parametrize("fused", [True, False])
def test_integrator_matches_scalar_oracle(fused):
    """Every selected pixel's ray is repeated `n_samp` times as lanes of
    one wavefront: lanes draw independently (by lane id on the fused
    route, by position in the generator's stream on the plain one)."""
    lanes, o_mean, o_se, n_samp = _oracle()
    _, trt, _, rays = _setup("cornell")
    idx = np.repeat(lanes, n_samp)
    o = torch.from_numpy(rays[0][idx].copy())
    d = torch.from_numpy(rays[1][idx].copy())
    r = tpath.path_trace(trt, o, d, 9, p_rr=0.8, max_bounces=16, fused=fused,
                         compact_schedule=(1.0,)).numpy()
    r = r.reshape(len(lanes), n_samp, 3).astype(np.float64)
    w_mean = r.mean(1)
    w_se = r.std(1) / np.sqrt(n_samp)
    tol = 5.0 * np.sqrt(o_se ** 2 + w_se ** 2) + 0.05 + 0.1 * np.abs(o_mean)
    assert (np.abs(w_mean - o_mean) < tol).all(), (w_mean, o_mean, tol)


# ------------------------------------------------ compaction, blocks, resume


def test_path_overflow_accounting():
    """A schedule tighter than the survival curve REPORTS its dropped live
    lanes; the default schedule reports none on Cornell; the fused route
    never drops."""
    scene = jcornell()
    scene.set_ndc_matrix(64, 64)
    jrt = ji.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    trt = rt_scene_from_numpy({k: np.asarray(v) for k, v in jrt._asdict().items()},
                              "cpu")
    o, d = (torch.from_numpy(np.asarray(x).copy())
            for x in jcamera_rays(jrt.eye, scene.fovy, 64, 64))
    # no roulette kill and a 256-lane floor after ONE bounce
    _, stats = tpath.path_trace(trt, o, d, 0, p_rr=1.0, max_bounces=2,
                                compact_schedule=(1.0, 0.01), with_stats=True,
                                fused=False)
    _, jstats = jpath.path_trace(jrt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                 jax.random.PRNGKey(0), p_rr=1.0, max_bounces=2,
                                 chunk=128, compact_schedule=(1.0, 0.01),
                                 with_stats=True, fused=False)
    assert int(stats["dropped_lanes"]) > 0
    # the same lanes survive one roulette-free bounce on both sides, bar
    # the few whose bounce ray another stream sends into the light
    assert abs(int(stats["dropped_lanes"]) - int(jstats["dropped_lanes"])) \
        <= 0.1 * int(jstats["dropped_lanes"])
    _, stats0 = tpath.path_trace(trt, o, d, 0, p_rr=0.8, max_bounces=8,
                                 with_stats=True, fused=False)
    assert int(stats0["dropped_lanes"]) == 0
    _, stats1 = tpath.path_trace(trt, o, d, 0, p_rr=1.0, max_bounces=2,
                                 compact_schedule=(1.0, 0.01), with_stats=True)
    assert int(stats1["dropped_lanes"]) == 0


def test_compact_perm_is_a_stable_partition():
    g = np.random.default_rng(0)
    live = torch.from_numpy(g.random(1000) < 0.3)
    perm, n_live = tpath.compact_perm(live, 512)
    want = np.flatnonzero(live.numpy())
    assert int(n_live) == want.size <= 512
    assert np.array_equal(perm.numpy()[:want.size], want)
    perm, n_live = tpath.compact_perm(live, 100)          # overflow: cut
    assert int(n_live) == want.size
    assert np.array_equal(perm.numpy(), want[:100])


@pytest.mark.parametrize("fused", [True, False])
def test_accumulate_resumes(fused):
    """2 + 2 samples equal 4: sample indices key the streams."""
    _, trt, _, rays = _setup("cornell")
    o, d = _torch_rays(rays)
    zero = torch.zeros((W * H, 3))
    kw = dict(max_bounces=6, fused=fused)
    mono = tpath.path_render_accumulate(trt, o, d, 7, zero, 0, 4, **kw)
    a = tpath.path_render_accumulate(trt, o, d, 7, zero, 0, 2, **kw)
    b = tpath.path_render_accumulate(trt, o, d, 7, a, 2, 2, **kw)
    np.testing.assert_allclose(b.numpy(), mono.numpy(), rtol=1e-5, atol=1e-5)
    # sample s is path_trace under fold_in(fold_in(key, s), block 0)
    one = tpath.path_render_accumulate(trt, o, d, 7, zero, 3, 1, **kw)
    want = tpath.path_trace(trt, o, d, fold_in(fold_in(7, 3), 0), **kw)
    assert torch.equal(one, want)


def test_blocks_are_keyed_by_absolute_index():
    _, trt, _, rays = _setup("cornell")
    o, d = _torch_rays(rays)
    kw = dict(key=prng_key(11), p_rr=0.8, max_bounces=4)
    mono = tpath._blocked_path_trace(trt, o, d, block=256, fused=False, **kw)
    apart = tpath._blocked_path_trace(trt, o[256:512], d[256:512], block=256,
                                      block_offset=1, fused=False, **kw)
    assert torch.equal(mono[256:512], apart)
    assert not torch.equal(mono[0:256], apart)
    # the fused route takes the whole wavefront in one call whatever
    # `block` is, keyed by the block offset alone
    whole = tpath._blocked_path_trace(trt, o, d, block=100, fused=True, **kw)
    assert torch.equal(whole, tpath.path_trace(trt, o, d, fold_in(11, 0),
                                               max_bounces=4, fused=True))


# ------------------------------------------------------- path_render's routes


def test_path_render_routes():
    """`fused=None`: the camera kernel where it is exact, the wavefront
    with its bounce kernel for a textured emitter; `fused=True` raises for
    such a scene; `fused=False` is the plain wavefront."""
    _, trt, fovy, rays = _setup("textured_light")
    o, d = _torch_rays(rays)
    assert trt.tex_on_emitter and not tpath.camera_kernel_exact(trt)
    img = tpath.path_render(trt, W, H, fovy, 2, spp=2, max_bounces=4)
    acc = tpath.path_render_accumulate(trt, o, d, 2, torch.zeros((W * H, 3)),
                                       0, 2, max_bounces=4)
    assert torch.equal(img, (acc / 2.0).reshape(H, W, 3))
    with pytest.raises(ValueError, match="textured emitter"):
        tpath.path_render(trt, W, H, fovy, 2, spp=1, fused=True)
    plain = tpath.path_render(trt, W, H, fovy, 2, spp=2, max_bounces=4,
                              fused=False)
    assert plain.shape == (H, W, 3) and not torch.equal(plain, img)

    _, crt, cfovy, _ = _setup("cornell")
    assert tpath.camera_kernel_exact(crt)
    cam = tpath.path_render(crt, W, H, cfovy, 2, spp=2, max_bounces=4)
    want = pk.path_camera_render(crt, 2, W, H, cfovy, 2, max_bounces=4)
    assert torch.equal(cam, (want.T / 2.0).reshape(H, W, 3))
