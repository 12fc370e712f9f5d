"""The port's device scene against the JAX package's `prepare_rt_scene`.

Float fields are computed by torch on one side and XLA on the other;
XLA's CPU backend may contract a multiply and an add into one FMA, so
they are compared with allclose(rtol=1e-6, atol=1e-7) — a few float32
ulps. Integer and boolean fields, the loop bounds n_tri and n_sph, the triangle
table and the emitter table's rows must be equal. The kernel operand
tables built from the same arrays must be equal too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.models.scene import Scene as JScene
from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.ops.pallas_path import pack_scene_tables as jpack
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu_torch import models as tmodels
from software_rasterizer_tpu_torch.models.scene import Scene as TScene
from software_rasterizer_tpu_torch.ops.camera import camera_rays as tcamera_rays
from software_rasterizer_tpu_torch.ops.intersect import (
    RTScene,
    prepare_rt_scene,
    rt_scene_from_numpy,
)
from software_rasterizer_tpu_torch.ops.path_kernel import pack_scene_tables
from software_rasterizer_tpu_torch.scenes import build_cornell_scene as tcornell
from torch_scenes import spheres

FLOAT_FIELDS = ["v0", "v1", "v2", "n0", "n1", "n2", "sph_c", "sph_r",
                "mat_kd", "mat_emit", "background", "eye", "emitter_cr"]
EXACT_FIELDS = ["tri_mat", "tri_valid", "sph_mat", "sph_valid", "mat_type",
                "tri_table"]


SCENES = {
    "cornell": (jcornell, tcornell),
    "spheres": (lambda: spheres(jmodels, JScene),
                lambda: spheres(tmodels, TScene)),
}


def _both(name):
    jbuild, tbuild = SCENES[name]
    js, ts = jbuild(), tbuild()
    js.set_ndc_matrix(16, 16)
    ts.set_ndc_matrix(16, 16)
    jrt = jprepare(js.rt_geometry(), js.rt_frame())
    trt = prepare_rt_scene(ts.rt_geometry(), ts.rt_frame(), "cpu")
    return jrt, trt


@pytest.mark.parametrize("name", sorted(SCENES))
def test_prepare_rt_scene_matches(name):
    jrt, trt = _both(name)
    for f in FLOAT_FIELDS:
        want = np.asarray(getattr(jrt, f))
        got = getattr(trt, f).numpy()
        assert got.shape == want.shape and got.dtype == np.float32, f
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f)
    for f in EXACT_FIELDS:
        want = np.asarray(getattr(jrt, f))
        got = getattr(trt, f).numpy()
        assert got.shape == want.shape and np.array_equal(got, want), f
    assert trt.n_tri == int(jrt.n_tri)
    assert trt.n_sph == int(jpack(jax.tree_util.tree_map(jnp.asarray, jrt))[2])
    assert trt.n_emitters == int(jrt.n_emitters)
    assert trt.emitter_cr.shape[0] == jrt.emitter_cr.shape[0]
    assert trt.tex_on_emitter == bool(jrt.tex_on_emitter.shape[0])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_rt_scene_from_numpy_round_trips(name):
    jrt, _ = _both(name)
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    rt = rt_scene_from_numpy(arrays, "cpu")
    assert isinstance(rt, RTScene)
    for f in FLOAT_FIELDS + EXACT_FIELDS:
        assert np.array_equal(getattr(rt, f).numpy(), arrays[f]), f
    assert rt.n_tri == int(arrays["n_tri"])
    assert rt.n_emitters == int(arrays["n_emitters"])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_scene_tables_equal(name):
    jrt, _ = _both(name)
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    attr, sph, n_sph = pack_scene_tables(rt_scene_from_numpy(arrays, "cpu"))
    jattr, jsph, jn_sph = jpack(jax.tree_util.tree_map(jnp.asarray, jrt))
    assert np.array_equal(attr.numpy(), np.asarray(jattr))
    assert np.array_equal(sph.numpy(), np.asarray(jsph))
    assert n_sph == int(jn_sph)


@pytest.mark.parametrize("size", [(16, 16), (24, 12)])
def test_camera_rays_match(size):
    w, h = size
    eye = np.array([0.1, -0.2, -0.9], np.float32)
    jo, jd = jcamera_rays(jnp.asarray(eye), 45.0, w, h)
    to, td = tcamera_rays(eye, 45.0, w, h, "cpu")
    assert np.array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)


def test_cuda_scene_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ts = tcornell()
    ts.set_ndc_matrix(8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_rt_scene(ts.rt_geometry(), ts.rt_frame(), "cuda")
