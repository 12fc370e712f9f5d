"""The port's device scene against the JAX package's `prepare_rt_scene`.

Float fields are computed by torch on one side and XLA on the other;
XLA's CPU backend may contract a multiply and an add into one FMA, so
they are compared with allclose(rtol=1e-6, atol=1e-7) — a few float32
ulps. Integer and boolean fields, the loop bounds n_tri and n_sph, the triangle
table, the emitter table's rows and the texture atlas must be equal. The
kernel operand tables built from the same arrays (the path kernel's, and
the Whitted kernel's against the JAX über-kernel's un-chunked rows) must
be equal too."""

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
from software_rasterizer_tpu.ops.pallas_whitted import pack_uber_tables
from software_rasterizer_tpu.ops.shading import ShaderType as JShaderType
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.utils.texture import Texture as JTexture
from software_rasterizer_tpu_torch import models as tmodels
from software_rasterizer_tpu_torch.models.scene import Scene as TScene
from software_rasterizer_tpu_torch.ops.camera import camera_rays as tcamera_rays
from software_rasterizer_tpu_torch.ops.intersect import (
    RTScene,
    prepare_rt_scene,
    rt_scene_from_numpy,
)
from software_rasterizer_tpu_torch.ops.path_kernel import pack_scene_tables
from software_rasterizer_tpu_torch.ops.shading import ShaderType as TShaderType
from software_rasterizer_tpu_torch.ops.whitted_kernel import pack_whitted_tables
from software_rasterizer_tpu_torch.scenes import build_cornell_scene as tcornell
from software_rasterizer_tpu_torch.utils.texture import Texture as TTexture
from torch_scenes import mirror_glass_cornell, spheres, textured_cornell

FLOAT_FIELDS = ["v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "sph_c", "sph_r", "mat_ka", "mat_kd", "mat_ks", "mat_spec",
                "mat_ior", "mat_emit", "background", "eye", "emitter_cr"]
EXACT_FIELDS = ["tri_mat", "tri_tex", "tri_valid", "sph_mat", "sph_valid",
                "mat_type", "tri_table", "textures", "tex_wh"]


SCENES = {
    "cornell": (jcornell, tcornell),
    "spheres": (lambda: spheres(jmodels, JScene),
                lambda: spheres(tmodels, TScene)),
    "textured": (lambda: textured_cornell(jcornell, JShaderType, JTexture),
                 lambda: textured_cornell(tcornell, TShaderType, TTexture)),
    "mirror_glass": (lambda: mirror_glass_cornell(jmodels, jcornell),
                     lambda: mirror_glass_cornell(tmodels, tcornell)),
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


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_whitted_tables_equal(name):
    jrt, _ = _both(name)
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    tri, attr, sph, n_tri, n_sph = pack_whitted_tables(
        rt_scene_from_numpy(arrays, "cpu"))
    _, attr_c, _, _, jsph, _, _ = pack_uber_tables(
        jax.tree_util.tree_map(jnp.asarray, jrt))
    f = arrays["v0"].shape[0]
    jattr = np.asarray(attr_c).transpose(0, 2, 1).reshape(-1, attr.shape[1])[:f]
    assert np.array_equal(attr.numpy(), jattr)
    assert np.array_equal(sph.numpy(), np.asarray(jsph))
    assert np.array_equal(tri.numpy(), arrays["tri_table"])
    assert n_tri == int(arrays["n_tri"])
    assert n_sph == int(jpack(jax.tree_util.tree_map(jnp.asarray, jrt))[2])
    if name == "textured":
        assert (attr.numpy()[:n_tri, 32] >= 0).any()


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
