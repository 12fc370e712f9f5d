"""The port's path-tracing pipeline on the CPU, and its no-fallback rules.

  * PathTracing through pipeline_from_config -> draw() reproduces the
    Cornell golden's clipped mean within 0.03 (tests/test_goldens.py's
    tolerance; the golden came from another random stream, so only the
    statistic is comparable);
  * accumulate 4 + 4 equals one 8-sample draw up to float32 summation
    order (rtol=2e-5, as tests/test_path.py's resume check);
  * checkpoints cross between the packages with the same keys and values;
  * a scene with a textured emitter renders through the wavefront
    integrator;
  * a CUDA request without CUDA, a missing or failing nvcc and a launch
    on CPU tensors each raise;
  * importing every module of the port imports no JAX.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from software_rasterizer_tpu.render.pathtracer import PathTracing as JPathTracing
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.ops import path_kernel as pk
from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
from software_rasterizer_tpu_torch.ops.path import path_render
from software_rasterizer_tpu_torch.render import PathTracing, pipeline_from_config
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.utils import cuda_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens" / "cornell_goldens.npz"


@pytest.fixture(scope="module")
def drawn():
    cfg = RenderConfig(width=48, height=48, spp=8, max_bounces=16, seed=0)
    render = pipeline_from_config(cfg, "path", device="cpu")
    scene = build_cornell_scene()
    render.add_scene(scene)
    render.draw()
    return render, scene, render.frame.copy()


def test_draw_matches_golden_mean(drawn):
    img = drawn[2]
    assert img.shape == (48, 48, 3) and np.isfinite(img).all()
    mean = float(np.clip(img, 0, 1).mean())
    assert abs(mean - float(np.load(GOLDENS)["path_mean"])) < 0.03


def test_accumulate_matches_draw(drawn):
    render, scene, frame = drawn
    render.accumulate(scene.name, 4)
    render.accumulate(scene.name, 4)
    assert render.samples_done(scene.name) == 8
    np.testing.assert_allclose(render.resolve(scene.name), frame,
                               rtol=2e-5, atol=1e-5)


def test_checkpoint_crosses_packages(tmp_path):
    scene = build_cornell_scene()
    port = PathTracing(8, 8, seed=3, device="cpu")
    port.add_scene(scene)
    port.accumulate(scene.name, 2)
    p1 = tmp_path / "port.npz"
    port.save_checkpoint(scene.name, str(p1))

    ref = JPathTracing(8, 8)
    ref.load_checkpoint(scene.name, str(p1))
    assert ref.samples_done(scene.name) == 2 and ref.seed == 3
    p2 = tmp_path / "jax.npz"
    ref.save_checkpoint(scene.name, str(p2))

    a, b = np.load(p1), np.load(p2)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k

    back = PathTracing(8, 8, device="cpu")
    back.load_checkpoint(scene.name, str(p2))
    assert back.seed == 3 and back.samples_done(scene.name) == 2
    np.testing.assert_array_equal(back.resolve(scene.name),
                                  port.resolve(scene.name))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline_from_config(RenderConfig(width=8, height=8), "path",
                             device="cuda")


def test_textured_emitter_renders():
    """A scene with a textured emitter, which the camera kernel cannot
    shade exactly, goes through the wavefront integrator on the camera's
    rays: draw() and accumulate() render it, 2 + 2 samples equal one
    4-sample draw, and the light's own pixels show texels, not its Kd."""
    from software_rasterizer_tpu_torch.ops.shading import ShaderType
    from software_rasterizer_tpu_torch.utils.texture import Texture
    from torch_scenes import textured_light_cornell

    cfg = RenderConfig(width=24, height=24, spp=4, max_bounces=6, seed=1)
    render = pipeline_from_config(cfg, "path", device="cpu")
    scene = textured_light_cornell(build_cornell_scene, ShaderType, Texture)
    render.add_scene(scene)
    launches = (pk.LAUNCHES, pk.LAUNCHES_BOUNCE)
    render.draw()
    assert (pk.LAUNCHES, pk.LAUNCHES_BOUNCE) == launches
    frame = render.frame.copy()
    assert frame.shape == (24, 24, 3) and np.isfinite(frame).all()
    render.accumulate(scene.name, 2)
    render.accumulate(scene.name, 2)
    assert render.samples_done(scene.name) == 4
    np.testing.assert_allclose(render.resolve(scene.name), frame,
                               rtol=2e-5, atol=1e-5)

    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    assert rt.tex_on_emitter
    with pytest.raises(ValueError, match="textured emitter"):
        path_render(rt, 24, 24, scene.fovy, 0, spp=1, fused=True)
    # the light's own pixels: with one bounce their radiance is the first
    # term alone, a texel (which has a zero channel; the light's grey Kd
    # has none)
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.ops.intersect import nearest_hit
    from software_rasterizer_tpu_torch.render import PathTracing

    first = PathTracing(24, 24, spp=1, max_bounces=1, device="cpu")
    first.add_scene(scene)
    first.draw()
    hit = nearest_hit(rt, *camera_rays(rt.eye.numpy(), scene.fovy, 24, 24, "cpu"))
    light = (hit.hit & (hit.emit.norm(dim=1) > 1e-5)).numpy()
    texels = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    colours = first.frame.reshape(-1, 3)[light]
    assert light.sum() >= 4
    assert all((np.abs(texels - px).max(1) < 1e-6).any() for px in colours)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_library("missing_nvcc", ["path_camera.cu"])


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no such target sm_90a' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such target sm_90a"):
        cuda_build.load_library("failing_build", ["path_camera.cu"])
    assert list((tmp_path / "build").glob("*.so")) == []


def test_launch_on_cpu_tensors_raises():
    t = torch.zeros((1, 12))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pk.launch_path_camera(
            t, torch.zeros((1, 16)), t, torch.zeros((1, 4)),
            torch.zeros(1, dtype=torch.int32), torch.zeros(8), n_tri=1,
            n_sph=0, n_emitters=1, lane_offset=0, n_lanes=4, width=2,
            height=2, p_rr=0.8, max_bounces=4)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import software_rasterizer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('software_rasterizer_tpu.') or m == 'software_rasterizer_tpu')\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
