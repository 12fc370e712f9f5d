"""The plain PyTorch bounce kernel against the JAX bounce kernel.

Both sides get the identical scene (the JAX `RTScene` arrays, through
`rt_scene_from_numpy`), the same (18,N) wavefront state (made by the JAX
`nearest_hit` on the 24x24 camera rays), the same `live` flags and the
same 32-bit seed. The JAX side is `fused_bounce_group(...,
interpret=True)`, the Pallas kernel run on the CPU as the JAX package's
own tests run it.

Tolerances. The two sides draw the same random numbers bit for bit and
follow the same arithmetic, but XLA's CPU backend contracts multiplies
and adds into FMAs while torch rounds every operation on its own (as the
CUDA kernel does, built with -fmad=false); see
tests/test_torch_path_kernel.py. After ONE bounce the two sides are held
lane for lane: `live` equal, `acc` and the live lanes' state within
rtol=1e-4, atol=1e-5, on >= 99% of the lanes (a bounce origin offset by
1e-6*N can re-hit its own surface at t within ulps of the 1e-6
threshold, and such a lane takes another branch). Sixteen bounces
compound that, so there the camera kernel's rule applies: unlit lanes
equal, >= 80% of the lit lanes within the same tolerance, and the sum
over the agreeing lanes within 1e-4 relative. The state of a dead lane
is not compared: the JAX kernel goes on updating it and the port freezes
it at the bounce the lane died in, and nothing reads it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.models.scene import Scene as JScene
from software_rasterizer_tpu.ops import intersect as ji
from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.pallas_path import fused_bounce_group as jfused
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu_torch.ops import path_kernel as pk
from software_rasterizer_tpu_torch.ops.intersect import rt_scene_from_numpy
from torch_scenes import spheres

W = H = 24
RTOL, ATOL = 1e-4, 1e-5
ONE_BOUNCE_SHARE, LIT_SHARE, SUM_RTOL = 0.99, 0.80, 1e-4
# a seed with the top bit set: the JAX side reads it as a negative int32
SEED = 0x9E3779B9


def _cornell_two_lights():
    """Cornell with a diffuse ball and a second, spherical emitter: the
    sphere stage of the dual trace, NEE toward a sphere and the pick among
    two emitters."""
    sc = jcornell()
    sc.add_graphic_obj(jmodels.SphereObject(
        (0.1, -0.15, 0.05), 0.07, jmodels.Material(Kd=(0.6, 0.5, 0.4))), "ball")
    sc.add_graphic_obj(jmodels.SphereLight(
        (-0.12, 0.12, 0.1), (1.0,) * 3, 0.04,
        jmodels.Material(Kd=(1.0, 1.0, 1.0), emission=(6.0, 5.0, 4.0))), "bulb")
    return sc


SCENES = {
    "cornell": jcornell,
    "cornell_spheres": _cornell_two_lights,
    "emissive_sphere": lambda: spheres(jmodels, JScene),
}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX scene, port scene, state (18,N) f32, live (N,) bool)."""
    scene = SCENES[name]()
    scene.set_ndc_matrix(W, H)
    jrt = ji.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    orig, d = jcamera_rays(jrt.eye, scene.fovy, W, H)
    hit = ji.nearest_hit(jrt, orig, d)
    ones = np.ones((W * H, 1), np.float32)
    state = np.concatenate(
        [np.asarray(x, np.float32) for x in
         (hit.coords, hit.normal, hit.kd, hit.emit, hit.color)] + [ones] * 3,
        axis=1).T.copy()
    return jrt, rt_scene_from_numpy(arrays, "cpu"), state, np.asarray(hit.hit)


def _both(name, n_bounces):
    jrt, trt, state, live = _setup(name)
    want = jfused(jrt, jnp.asarray(state), jnp.asarray(live),
                  jnp.asarray(np.uint32(SEED).astype(np.int32)), n_bounces,
                  p_rr=0.8, interpret=True)
    launches = pk.LAUNCHES_BOUNCE
    got = pk.fused_bounce_group(trt, torch.from_numpy(state.copy()),
                                torch.from_numpy(live.copy()), SEED, n_bounces,
                                p_rr=0.8)
    assert pk.LAUNCHES_BOUNCE == launches      # CPU tensors: the plain version
    return [np.asarray(x) for x in want], [x.numpy() for x in got], state, live


@pytest.mark.parametrize("name", sorted(SCENES))
def test_one_bounce_matches_jax_lane_for_lane(name):
    (w_acc, w_state, w_live), (g_acc, g_state, g_live), state, live = _both(name, 1)
    assert g_acc.shape == (3, W * H) and g_acc.dtype == np.float32
    assert g_state.shape == (18, W * H) and g_live.dtype == np.bool_
    assert np.isfinite(g_acc).all()
    ok = (g_live == w_live) & np.isclose(g_acc, w_acc, rtol=RTOL, atol=ATOL).all(0)
    both = g_live & w_live
    ok &= ~both | np.isclose(g_state, w_state, rtol=RTOL, atol=ATOL).all(0)
    assert ok.mean() >= ONE_BOUNCE_SHARE, (name, int((~ok).sum()))
    # lanes that were dead on entry gather nothing, stay dead and keep
    # their state
    assert (g_acc[:, ~live] == 0).all() and not g_live[~live].any()
    assert np.array_equal(g_state[:, ~live], state[:, ~live])
    if name == "emissive_sphere":
        # a primary hit on an emissive SPHERE shades black (its stored
        # colour is 0) and the lane's bounce ray decides whether it lives
        on_light = live & (np.linalg.norm(state[9:12], axis=0) > 1e-5)
        assert on_light.any() and (g_acc[:, on_light] == 0).all()
        assert (w_acc[:, on_light] == 0).all()
    else:
        assert (g_acc != 0).any() and g_live.any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sixteen_bounces_match_jax(name):
    (w_acc, _, w_live), (g_acc, _, g_live), _, live = _both(name, 16)
    assert np.isfinite(g_acc).all()
    lane_ok = np.isclose(g_acc, w_acc, rtol=RTOL, atol=ATOL).all(axis=0)
    lit = (g_acc != 0).any(axis=0) | (w_acc != 0).any(axis=0)
    assert lane_ok[~lit].all()
    if lit.any():
        assert lane_ok[lit].mean() >= LIT_SHARE, (
            name, int((~lane_ok).sum()), int(lit.sum()))
    s_got = g_acc[:, lane_ok].sum(dtype=np.float64)
    s_want = w_acc[:, lane_ok].sum(dtype=np.float64)
    assert abs(s_got - s_want) <= SUM_RTOL * abs(s_want), (s_got, s_want)
    # Russian roulette at 0.8 leaves about 0.8^16 = 3% of the lanes
    assert g_live.mean() <= 0.1 and (g_live == w_live).mean() >= 0.97


def test_split_groups_equal_one_call():
    """The kernel's counters are per call (draw k of bounce b is 12 b + k
    + 1), so 2 bounces in one call are NOT two calls of 1; but the state
    handed from one call to the next carries everything else: a second
    call continues the first's lanes, and `acc` of dead lanes stays 0."""
    _, trt, state, live = _setup("cornell")
    st, lv = torch.from_numpy(state.copy()), torch.from_numpy(live.copy())
    a1, s1, l1 = pk.fused_bounce_group_plain(trt, st, lv, SEED, 1)
    a2, s2, l2 = pk.fused_bounce_group_plain(trt, s1, l1, SEED + 1, 1)
    assert (a2[:, ~l1] == 0).all() and not l2[~l1].any()
    assert torch.equal(s2[:, ~l1], s1[:, ~l1])
    assert (l2 <= l1).all() and (l1 <= lv).all()
    stats = {}
    pk.fused_bounce_group_plain(trt, st, lv, SEED, 16, stats=stats)
    assert stats["lane_bounces"] >= int(lv.sum())


def test_bounce_launch_on_cpu_tensors_raises():
    t = torch.zeros((1, 12))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pk.launch_path_bounce(
            t, torch.zeros((1, 16)), t, torch.zeros((1, 4)),
            torch.zeros((18, 4)), torch.zeros(4, dtype=torch.bool), n_tri=1,
            n_sph=0, n_emitters=1, seed=0, n_bounces=1, p_rr=0.8)


@pytest.mark.parametrize("bad", ["rows", "live", "dtype"])
def test_bad_state_raises(bad):
    _, trt, state, live = _setup("cornell")
    st, lv = torch.from_numpy(state.copy()), torch.from_numpy(live.copy())
    if bad == "rows":
        st, err = st[:17], ValueError
    elif bad == "live":
        lv, err = lv[:-1], ValueError
    else:
        st, err = st.double(), TypeError
    with pytest.raises(err):
        pk.fused_bounce_group(trt, st, lv, SEED, 1)
