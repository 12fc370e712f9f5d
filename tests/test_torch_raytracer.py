"""The port's Whitted pipeline on the CPU, and its no-fallback rules.

  * RayTracing through pipeline_from_config -> draw() at 64x64 equals the
    JAX package's RayTracing.draw() by the rule of
    tests/test_torch_whitted.py (>= 99.5% of pixels within rtol=1e-4,
    atol=1e-5; every other pixel's camera ray on an edge shared by two
    triangles, where float32 rounding picks the wall), with the same
    last_stats keys and dropped_rays == 0;
  * a scene with two emitters renders as the JAX pipeline's does;
  * a max_depth above the kernel's stack bound, a CUDA request without CUDA, a launch on CPU tensors and a
    kernel build without nvcc each raise.
"""

import numpy as np
import pytest
import torch

from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.render.raytracer import RayTracing as JRayTracing
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu_torch import models as tmodels
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
from software_rasterizer_tpu_torch.ops.whitted import whitted_render
from software_rasterizer_tpu_torch.render import RayTracing, pipeline_from_config
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.utils import cuda_build
from torch_scenes import edge_tie_pixels

W = H = 64


def test_draw_matches_jax_raytracer():
    cfg = RenderConfig(width=W, height=H, spp=1, seed=0)
    render = pipeline_from_config(cfg, "whitted", device="cpu")
    assert isinstance(render, RayTracing) and render.max_depth == cfg.max_depth
    scene = build_cornell_scene()
    render.add_scene(scene)
    launches = wk.LAUNCHES
    render.draw()
    assert wk.LAUNCHES == launches
    got = render.frame
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    got[0, 0] = got[0, 0]                   # a writable copy

    ref = JRayTracing(W, H, spp=1, seed=0)
    jscene = jcornell()
    ref.add_scene(jscene)
    ref.draw()
    want = ref.frame
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert ok.mean() >= 0.995, int((~ok).sum())
    rt = jprepare(jscene.rt_geometry(), jscene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in rt._asdict().items()}
    edge = edge_tie_pixels(
        arrays, np.asarray(jcamera_rays(arrays["eye"], jscene.fovy, W, H)[1]))
    assert edge.reshape(H, W)[~ok].all()

    st, jst = render.last_stats[scene.name], ref.last_stats[jscene.name]
    assert sorted(st) == sorted(jst) == ["dropped_rays", "rays_main", "rays_shadow"]
    assert st["dropped_rays"] == 0
    assert st == jst, (st, jst)
    assert all(type(v) is int for v in st.values())


def test_two_emitters_render():
    """A scene with two emitters renders (it raised before the emitter
    picks were ported): Cornell plus a sphere light, against the JAX
    pipeline under the same threefry key by the rule above."""
    import jax

    from software_rasterizer_tpu import models as jmodels

    def build(models, cornell):
        scene = cornell()
        scene.add_graphic_obj(models.SphereLight(
            (-0.12, 0.12, 0.1), (1.0,) * 3, 0.04,
            models.Material(Kd=(1.0, 1.0, 1.0), emission=(6.0, 5.0, 4.0))),
            "bulb")
        return scene

    render = RayTracing(32, 32, spp=2, seed=4, device="cpu")
    render.add_scene(build(tmodels, build_cornell_scene))
    render.draw()
    got = render.frame
    ref = JRayTracing(32, 32, spp=2, seed=4)
    ref.key = jax.random.PRNGKey(4)
    jscene = build(jmodels, jcornell)
    ref.add_scene(jscene)
    ref.draw()
    ok = np.isclose(got, ref.frame, rtol=1e-4, atol=1e-5).all(-1)
    rt = jprepare(jscene.rt_geometry(), jscene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in rt._asdict().items()}
    edge = edge_tie_pixels(
        arrays, np.asarray(jcamera_rays(arrays["eye"], jscene.fovy, 32, 32)[1])
    ).reshape(32, 32)
    # at 32x32 the box's diagonals run through pixel centres: the share is
    # taken off the shared-edge rays, and every differing pixel is one
    assert ok[~edge].mean() >= 0.995, int((~ok & ~edge).sum())
    assert edge[~ok].all()
    st, jst = render.last_stats["CornellBox"], ref.last_stats["CornellBox"]
    assert st["dropped_rays"] == jst["dropped_rays"] == 0
    assert st["rays_main"] == jst["rays_main"]
    # a shared-edge ray shades the wall on one side and the light on the
    # other: two emitter-table rows a diffuse hit at spp 2
    assert abs(st["rays_shadow"] - jst["rays_shadow"]) <= 0.01 * jst["rays_shadow"]


def test_max_depth_above_bound_raises():
    scene = build_cornell_scene()
    scene.max_depth = wk.MAX_DEPTH + 1
    render = RayTracing(8, 8, device="cpu")
    render.add_scene(scene)
    with pytest.raises(ValueError, match="stack bound"):
        render.draw()
    scene.set_ndc_matrix(8, 8)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    with pytest.raises(ValueError, match="stack bound"):
        whitted_render(rt, 8, 8, scene.fovy, max_depth=-1)
    # the bound itself renders
    img = whitted_render(rt, 8, 8, scene.fovy, max_depth=wk.MAX_DEPTH)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline_from_config(RenderConfig(width=8, height=8), "whitted",
                             device="cuda")


def test_launch_on_cpu_tensors_raises():
    scene = build_cornell_scene()
    scene.set_ndc_matrix(4, 4)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    tri, attr, sph, n_tri, n_sph = wk.pack_whitted_tables(rt)
    rays = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wk.launch_whitted_uber(
            tri, attr, sph, torch.zeros(8), rt.textures, rt.tex_wh, rays,
            rays, n_tri=n_tri, n_sph=n_sph, max_depth=5)


def test_whitted_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wk.build_kernel()

