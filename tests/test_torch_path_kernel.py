"""The plain PyTorch camera kernel against the JAX camera kernel.

Both sides get the identical scene (the JAX `RTScene` arrays, through
`rt_scene_from_numpy`) and the same threefry key. The JAX side is
`fused_path_camera_render(..., interpret=True)`, the Pallas kernel run
on the CPU as the JAX package's own tests run it.

Tolerances. The two sides draw the same random numbers bit for bit and
follow the same arithmetic, but XLA's CPU backend contracts multiplies
and adds into FMAs where it likes (measured: `jit(a + b * c)` equals the
fused result on every one of 1e5 random inputs), while torch rounds
every operation on its own (as the CUDA kernel does, built with
-fmad=false). The last bits then differ, and a path that meets a knife
edge takes another branch and changes its whole lane. Such edges are
common here: rays are traced in post-projection space with model-space
normals, so a bounce origin offset by 1e-6*N can sit under its own
surface and re-hit it at t within ulps of the 1e-6 threshold (traced:
t = 1.097e-6 on one side, a miss on the other). So, per case:
  * unlit lanes (zero on both sides) are equal;
  * at least 80% of the lit lanes agree within rtol=1e-4, atol=1e-5 on
    every channel (measured: cornell 62/67, cornell_window 30/31,
    cornell_spheres 99/113; a wrong draw slot, constant or branch gives
    agreement only on the few lanes that see the light directly);
  * summed over the agreeing lanes, the radiance agrees within 1e-4
    relative (a systematic error would show here; one diverged lane can
    move the whole-frame sum by percents, as it may hold an NEE
    firefly).
Resume (start_sample 0+3 == 6) is checked on the port alone, within the
float32 reassociation tolerance of tests/test_path.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.models.scene import Scene as JScene
from software_rasterizer_tpu.ops.intersect import RTScene as JRTScene
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.ops.pallas_path import fused_path_camera_render
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu_torch.ops.intersect import rt_scene_from_numpy
from software_rasterizer_tpu_torch.ops.path_kernel import (
    path_camera_render,
    path_camera_render_plain,
)

LANE_RTOL, LANE_ATOL, LIT_SHARE = 1e-4, 1e-5, 0.80
SUM_RTOL = 1e-4


def _sphere_scene():
    sc = JScene("spherelight", eye=(0.0, 0.0, -0.9))
    lm = jmodels.Material(type=jmodels.MaterialType.DIFFUSE_AND_GLOSSY,
                          Kd=(1.0, 0.3, 0.2), emission=(30.0, 30.0, 30.0))
    sc.add_graphic_obj(
        jmodels.SphereLight((0.0, 0.0, 50.0), (1.0,) * 3, 20.0, lm), "light")
    return sc


def _cornell_spheres():
    """Cornell with a diffuse ball and a second, spherical emitter: sphere
    hits and normals, NEE toward a sphere, and the pick among 2 emitters."""
    sc = jcornell()
    sc.add_graphic_obj(jmodels.SphereObject(
        (0.1, -0.15, 0.05), 0.07, jmodels.Material(Kd=(0.6, 0.5, 0.4))),
        "ball")
    sc.add_graphic_obj(jmodels.SphereLight(
        (-0.12, 0.12, 0.1), (1.0,) * 3, 0.04,
        jmodels.Material(Kd=(1.0, 1.0, 1.0), emission=(6.0, 5.0, 4.0))),
        "bulb")
    return sc


def _scene_arrays(scene):
    scene.set_ndc_matrix(16, 16)
    rt = jprepare(scene.rt_geometry(), scene.rt_frame())
    return scene.fovy, {k: np.asarray(v) for k, v in rt._asdict().items()}


# name -> (scene builder, key, spp, max_bounces, lane_offset, n_lanes)
CASES = {
    "cornell": (jcornell, 42, 6, 8, 0, None),
    "cornell_window": (jcornell, 42, 6, 8, 100, 100),
    "emissive_sphere": (_sphere_scene, 0, 4, 4, 0, None),
    "cornell_spheres": (_cornell_spheres, 7, 4, 8, 0, None),
}


def _render_both(name):
    build, key, spp, mb, off, nl = CASES[name]
    fovy, arrays = _scene_arrays(build())
    jrt = JRTScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = np.asarray(fused_path_camera_render(
        jrt, jax.random.PRNGKey(key), 16, 16, fovy, spp,
        lane_offset=off, n_lanes=nl, p_rr=0.8, max_bounces=mb,
        interpret=True))
    got = path_camera_render_plain(
        rt_scene_from_numpy(arrays, "cpu"), key, 16, 16, fovy, spp,
        lane_offset=off, n_lanes=nl, p_rr=0.8, max_bounces=mb)
    return want, got.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name):
    want, got = _render_both(name)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    lane_ok = np.isclose(got, want, rtol=LANE_RTOL, atol=LANE_ATOL).all(axis=0)
    lit = (got != 0).any(axis=0) | (want != 0).any(axis=0)
    assert lane_ok[~lit].all()
    if lit.any():
        share = lane_ok[lit].mean()
        assert share >= LIT_SHARE, (name, int((~lane_ok).sum()), int(lit.sum()))
    s_got = got[:, lane_ok].sum(dtype=np.float64)
    s_want = want[:, lane_ok].sum(dtype=np.float64)
    assert abs(s_got - s_want) <= SUM_RTOL * abs(s_want), (s_got, s_want)
    if name == "emissive_sphere":
        # the light disk covers the image centre: a primary hit on an
        # emissive SPHERE shades black (the sphere color quirk)
        assert np.abs(got[:, 7 * 16 + 7]).max() < 1e-5
        assert np.abs(want[:, 7 * 16 + 7]).max() < 1e-5


def test_resume_matches_monolithic():
    fovy, arrays = _scene_arrays(jcornell())
    rt = rt_scene_from_numpy(arrays, "cpu")
    kw = dict(width=16, height=16, fovy_deg=fovy, max_bounces=8)
    mono = path_camera_render(rt, 42, spp=6, **kw)
    a = path_camera_render(rt, 42, spp=3, start_sample=0, **kw)
    b = path_camera_render(rt, 42, spp=3, start_sample=3, **kw)
    np.testing.assert_allclose(mono.numpy(), (a + b).numpy(), rtol=2e-5,
                               atol=1e-5)
