"""The port's device scene against the JAX package's `prepare_rt_scene`.

Float fields are computed by torch on one side and XLA on the other;
XLA's CPU backend may contract a multiply and an add into one FMA, so
they are compared with allclose(rtol=1e-6, atol=1e-7) — a few float32
ulps. Integer and boolean fields, the loop bounds n_tri and n_sph, the triangle
table, the emitter table's rows and the texture atlas must be equal. The
kernel operand tables built from the same arrays (the path kernel's, and
the Whitted kernel's against the JAX über-kernel's un-chunked rows) must
be equal too."""

import dataclasses

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
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.models.scene import Scene as TScene
from software_rasterizer_tpu_torch.ops.camera import camera_rays as tcamera_rays
from software_rasterizer_tpu_torch.ops.intersect import (
    DeviceRTGeometry,
    RTScene,
    prepare_rt_geometry,
    prepare_rt_scene,
    rt_scene_from_numpy,
)
from software_rasterizer_tpu_torch.ops.path_kernel import pack_scene_tables
from software_rasterizer_tpu_torch.ops.shading import ShaderType as TShaderType
from software_rasterizer_tpu_torch.ops.whitted_kernel import pack_whitted_tables
from software_rasterizer_tpu_torch.render import pathtracer as pathtracer_mod
from software_rasterizer_tpu_torch.render import rasterizer as rasterizer_mod
from software_rasterizer_tpu_torch.render import raytracer as raytracer_mod
from software_rasterizer_tpu_torch.render.pipeline import pipeline_from_config
from software_rasterizer_tpu_torch.scenes import build_cornell_scene as tcornell
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from software_rasterizer_tpu_torch.utils.texture import Texture as TTexture
from torch_scenes import (
    mirror_glass_cornell,
    raster_cornell,
    spheres,
    stress_cornell,
    textured_cornell,
    textured_light_cornell,
    two_emitter_cornell,
)

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


# ---- the device geometry: made once, then only the frame goes up


def _turn(scene, degrees):
    """Turn every mesh of a Cornell scene about y (keeping its scale), and
    swing and grow every sphere, as a turning scene's frames do."""
    for name, _ in scene.meshes():
        scene.set_model_matrix(name, (0.0, 1.0, 0.0), degrees, (0.0, 0.0, 0.0),
                               (0.25,) * 3)
    for name, _ in scene.spheres():
        scene.set_model_matrix(name, (0.0, 1.0, 0.0), degrees,
                               (0.001 * degrees, 0.0, 0.0),
                               (1.0 + degrees / 100.0,) * 3)


GEOMETRY_SCENES = {
    "cornell": tcornell,
    "two_emitter": lambda: two_emitter_cornell(tmodels, tcornell),
    "mirror_glass": lambda: mirror_glass_cornell(tmodels, tcornell),
    "textured_light": lambda: textured_light_cornell(tcornell, TShaderType,
                                                     TTexture),
    "stress2": lambda: stress_cornell(tcornell, subdivide_mesh, 2),
}


def _emitter_bounds_by_object(rt, n_obj):
    """Each object's bbox center and |diagonal|/2 over its valid
    triangles' corners and valid spheres' boxes, one object at a time."""
    tv = torch.stack([rt.v0, rt.v1, rt.v2], dim=1)
    big = torch.tensor(1e30)
    centers, radii = [], []
    for o in range(n_obj):
        tmask = ((rt.tri_obj == o) & rt.tri_valid)[:, None, None]
        smask = ((rt.sph_obj == o) & rt.sph_valid)[:, None]
        lo = torch.minimum(torch.where(tmask, tv, big).amin(dim=(0, 1)),
                           torch.where(smask, rt.sph_c - rt.sph_r[:, None],
                                       big).amin(dim=0))
        hi = torch.maximum(torch.where(tmask, tv, -big).amax(dim=(0, 1)),
                           torch.where(smask, rt.sph_c + rt.sph_r[:, None],
                                       -big).amax(dim=0))
        centers.append((lo + hi) * 0.5)
        radii.append(torch.sqrt(((hi - lo) ** 2).sum()) * 0.5)
    return torch.stack(centers), torch.stack(radii)


@pytest.mark.parametrize("name", sorted(GEOMETRY_SCENES))
def test_device_geometry_route_matches_host_route(name):
    """Two frames of a turning scene drawn from one `DeviceRTGeometry`
    equal `prepare_rt_scene` on the host geometry in every field, bit for
    bit; the emitter bounds' segment reduction equals a loop over the
    objects."""
    scene = GEOMETRY_SCENES[name]()
    scene.set_ndc_matrix(16, 16)
    geom = scene.rt_geometry()
    dgeom = prepare_rt_geometry(geom, "cpu")
    assert isinstance(dgeom, DeviceRTGeometry)
    firsts = []
    for degrees in (0.0, 23.0):
        _turn(scene, degrees)
        frame = scene.rt_frame()
        want = prepare_rt_scene(geom, frame, "cpu")
        got = prepare_rt_scene(dgeom, frame, "cpu")
        for f in dataclasses.fields(RTScene):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                assert torch.equal(a, b), f.name
            else:
                assert type(a) is type(b) and a == b, f.name
        n_obj = len(geom.obj_emissive)
        centers, radii = _emitter_bounds_by_object(got, n_obj)
        assert torch.equal(got.emitter_center, centers)
        assert torch.equal(got.emitter_radius, radii)
        order = np.argsort(~np.asarray(geom.obj_emissive, bool), kind="stable")
        rows = torch.cat([centers, radii[:, None]], dim=1)[order]
        assert torch.equal(got.emitter_cr, rows[: max(got.n_emitters, 1)])
        firsts.append(got.v0)
    assert not torch.equal(*firsts)       # the turn moved the meshes
    if name in ("two_emitter", "mirror_glass"):
        assert scene.spheres() and n_obj > len(scene.meshes())


PIPELINE_KINDS = ("path", "whitted", "raster")


def _pipeline(kind):
    cfg = RenderConfig(width=8, height=8, spp=1, max_bounces=1, max_depth=1)
    pipe = pipeline_from_config(cfg, kind, device="cpu")
    if kind == "raster":
        scene = raster_cornell(tmodels, tcornell, subdivide_mesh, TShaderType,
                               TTexture, 0)
        module, build = rasterizer_mod, "prepare_raster_geometry"
    else:
        scene = tcornell()
        module = pathtracer_mod if kind == "path" else raytracer_mod
        build = "prepare_rt_geometry"
    pipe.add_scene(scene)
    return pipe, scene, module, build


@pytest.mark.parametrize("kind", PIPELINE_KINDS)
def test_geometry_goes_up_once(kind, monkeypatch):
    """Two draws build the scene's device geometry once and reuse the same
    object; the ray-traced draws hand `prepare_rt_scene` that object, so
    only the frame's arrays go up."""
    pipe, scene, module, build = _pipeline(kind)
    builds, scenes_given = [], []
    real = getattr(module, build)
    monkeypatch.setattr(module, build,
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    if kind != "raster":
        real_scene = module.prepare_rt_scene

        def spy(geom, frame, device):
            scenes_given.append(geom)
            return real_scene(geom, frame, device)
        monkeypatch.setattr(module, "prepare_rt_scene", spy)
    pipe.draw()
    first = pipe._geometry(scene)
    pipe.draw()
    assert pipe._geometry(scene) is first
    assert len(builds) == 1
    if kind != "raster":
        assert [g is first for g in scenes_given] == [True, True]
        assert isinstance(first, DeviceRTGeometry)


@pytest.mark.parametrize("kind", PIPELINE_KINDS)
def test_invalidate_drops_the_geometry(kind):
    """`invalidate(name)` and `invalidate()` drop the cached geometry (and
    PathTracing's accumulator); the rasterizer also rebuilds when a mesh
    is added."""
    pipe, scene, _, _ = _pipeline(kind)
    pipe.draw()
    first = pipe._geometry(scene)
    if kind == "path":
        pipe.accumulate(scene.name, 1)
        assert pipe.samples_done(scene.name) == 1
    pipe.invalidate(scene.name)
    assert scene.name not in pipe._geom_cache
    if kind == "path":
        assert pipe.samples_done(scene.name) == 0
        pipe.accumulate(scene.name, 1)
    pipe.draw()
    second = pipe._geometry(scene)
    assert second is not first
    pipe.invalidate()
    assert pipe._geom_cache == {}
    if kind == "path":
        assert pipe.samples_done(scene.name) == 0
    if kind == "raster":
        pipe.draw()
        third = pipe._geometry(scene)
        assert pipe._geometry(scene) is third
        scene.add_graphic_obj(
            tmodels.MeshObject(scene.get_mesh_obj("shortbox").data), "extra")
        assert pipe._geometry(scene) is not third
