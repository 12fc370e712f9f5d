"""The port's TraditionalRasterizer against the JAX class, on the CPU,
and the port's device rule.

Both classes render `tests/torch_scenes.raster_cornell` (equal scene
tables in both packages). The JAX class runs its XLA route on the CPU,
the port its tile kernels' plain versions; XLA:CPU contracts
multiply-adds into FMAs, so a pixel on a coverage knife edge may be
covered in one package only. Frames therefore agree in coverage to < 1%,
and in colour (rtol = atol = 1e-3) and depth (rtol 1e-4: each package
rounds its own triangle setup) on the pixels covered in both; everything
inside the port (draw_batch against draw, invalidate) is compared bit for
bit.
"""

import inspect

import numpy as np
import pytest
import torch

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.ops.shading import ShaderType as JShaderType
from software_rasterizer_tpu.render import Primitive as JPrimitive
from software_rasterizer_tpu.render import TraditionalRasterizer as JRasterizer
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.scenes.stress import subdivide_mesh as jsubdivide
from software_rasterizer_tpu.utils.texture import Texture as JTexture
from software_rasterizer_tpu_torch import models as tmodels
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.ops.shading import ShaderType
from software_rasterizer_tpu_torch.render import (
    PathTracing,
    Primitive,
    RayTracing,
    TraditionalRasterizer,
    pipeline_from_config,
)
from software_rasterizer_tpu_torch.scenes import build_cornell_scene as tcornell
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from software_rasterizer_tpu_torch.utils.texture import Texture
from torch_scenes import raster_cornell, set_raster_cornell_angle

SIZE = 96


def _jscene(variant="three", levels=1, name=None):
    s = raster_cornell(jmodels, jcornell, jsubdivide, JShaderType, JTexture,
                       levels, variant)
    if name:
        s.name = name
    return s


def _tscene(variant="three", levels=1, name=None):
    s = raster_cornell(tmodels, tcornell, subdivide_mesh, ShaderType, Texture,
                       levels, variant)
    if name:
        s.name = name
    return s


def _assert_frames_agree(render, ref):
    got_cov, want_cov = np.isfinite(render.zbuffer), np.isfinite(ref.zbuffer)
    assert (got_cov != want_cov).mean() < 0.01
    both = got_cov & want_cov
    assert both.mean() > 0.4
    np.testing.assert_allclose(render.frame[both], ref.frame[both],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(render.zbuffer[both], ref.zbuffer[both], rtol=1e-4)
    assert (render.frame[~got_cov] == 0).all()


@pytest.mark.parametrize("variant", ["three", "five"])
def test_draw_matches_jax_class(variant):
    render = pipeline_from_config(RenderConfig(width=SIZE, height=SIZE),
                                  "raster", device="cpu")
    assert isinstance(render, TraditionalRasterizer)
    scene = _tscene(variant)
    render.add_scene(scene)
    render.draw(Primitive.TRIANGLES)
    ref = JRasterizer(SIZE, SIZE)
    ref.add_scene(_jscene(variant))
    ref.draw(JPrimitive.TRIANGLES)
    assert render.frame.shape == (SIZE, SIZE, 3) and np.isfinite(render.frame).all()
    _assert_frames_agree(render, ref)
    assert render.last_stats == {scene.name: {"bin_dropped": 0,
                                              "kernel": "raster_tiles"}}


def test_shaded_draw_equals_deferred_and_names_its_kernel():
    frames = {}
    for shaded in (False, True):
        render = TraditionalRasterizer(SIZE, SIZE, shaded=shaded, device="cpu")
        scene = _tscene("three")
        render.add_scene(scene)
        render.draw()
        frames[shaded] = (render.frame, render.zbuffer)
        want = "raster_tiles_shaded" if shaded else "raster_tiles"
        assert render.last_stats[scene.name]["kernel"] == want
    assert np.array_equal(frames[True][1], frames[False][1])
    np.testing.assert_allclose(frames[True][0], frames[False][0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shaded", [False, True])
def test_draw_batch_is_bit_identical_to_draws(shaded):
    render = TraditionalRasterizer(SIZE, SIZE, shaded=shaded, device="cpu")
    scene = _tscene("three")
    render.add_scene(scene)
    frames, singles = [], []
    for i in range(3):
        set_raster_cornell_angle(scene, 8.0 + 25.0 * i)
        frames.append(scene.raster_frame())
        render.clear()
        render.draw(Primitive.TRIANGLES)
        singles.append((render.frame.copy(), render.zbuffer.copy()))
    imgs, zbufs = render.draw_batch(scene, frames)
    assert isinstance(imgs, torch.Tensor) and imgs.shape == (3, SIZE, SIZE, 3)
    assert zbufs.shape == (3, SIZE, SIZE)
    for i, (img, z) in enumerate(singles):
        assert np.array_equal(imgs[i].numpy(), img), f"frame {i} image differs"
        assert np.array_equal(zbufs[i].numpy(), z), f"frame {i} zbuf differs"
    assert not np.array_equal(singles[0][0], singles[1][0])
    assert int(render.last_stats[scene.name]["bin_dropped"]) == 0


def _add_front_quad(models, mesh_data_cls, scene_cls, name):
    """A second scene: one quad in front of part of the box."""
    s = scene_cls(name, eye=(0.0, 0.0, -0.75))
    v = np.asarray([[-0.1, -0.1, -0.2], [0.12, -0.1, -0.2], [0.12, 0.1, -0.2],
                    [-0.1, 0.1, -0.2]], np.float32)
    data = mesh_data_cls(
        name="quad", vertices=v,
        normals=np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (4, 1)),
        uvs=np.zeros((4, 2), np.float32),
        colors=np.tile(np.asarray([[0.9, 0.3, 0.2]], np.float32), (4, 1)),
        faces=np.asarray([[0, 2, 1], [0, 3, 2], [0, 1, 2], [0, 2, 3]], np.int32),
        material=None, bbox_min=v.min(0), bbox_max=v.max(0), had_normals=True)
    s.add_graphic_obj(models.MeshObject(data), "quad")
    s.add_light("L", models.PointLight((0.5, 0.5, -0.9), (80.0,) * 3))
    return s


def test_two_scenes_compose_through_the_shared_zbuffer():
    from software_rasterizer_tpu.models.scene import Scene as JScene
    from software_rasterizer_tpu.utils.obj_loader import MeshData as JMeshData
    from software_rasterizer_tpu_torch.models.scene import Scene
    from software_rasterizer_tpu_torch.utils.obj_loader import MeshData

    render = TraditionalRasterizer(SIZE, SIZE, device="cpu")
    render.add_scene(_tscene("three"))
    render.draw()
    box_only = render.frame.copy()
    render.clear()
    render.add_scene(_add_front_quad(tmodels, MeshData, Scene, "Quad"))
    render.draw()
    ref = JRasterizer(SIZE, SIZE)
    ref.add_scene(_jscene("three"))
    ref.add_scene(_add_front_quad(jmodels, JMeshData, JScene, "Quad"))
    ref.draw()
    _assert_frames_agree(render, ref)
    changed = (render.frame != box_only).any(-1)
    assert 0.005 < changed.mean() < 0.5      # the quad hides part of the box
    assert set(render.last_stats) == {"CornellBox", "Quad"}


def test_invalidate_picks_up_a_rebound_shader():
    render = TraditionalRasterizer(SIZE, SIZE, device="cpu")
    scene = _tscene("three")
    render.add_scene(scene)
    render.draw()
    first = render.frame.copy()
    scene.get_mesh_obj("left").shader = scene.get_mesh_obj("shortbox").shader  # NORMAL
    render.clear()
    render.draw()
    assert np.array_equal(render.frame, first)   # cached geometry: no change yet
    render.invalidate(scene.name)
    render.clear()
    render.draw()
    assert (render.frame != first).any()
    render.invalidate()
    assert render._geom_cache == {}


def test_lines_match_jax_class():
    render = TraditionalRasterizer(SIZE, SIZE, device="cpu")
    render.add_scene(_tscene("three"))
    img = render.display(Primitive.LINES)
    ref = JRasterizer(SIZE, SIZE)
    ref.add_scene(_jscene("three"))
    ref.draw(JPrimitive.LINES)
    cov, jcov = np.isfinite(render.zbuffer), np.isfinite(ref.zbuffer)
    # a sample within float32 rounding of a pixel boundary may land in the
    # neighbouring pixel
    assert (cov != jcov).mean() < 2e-3
    both = cov & jcov
    assert both.sum() > 300 and img.max() > 10
    np.testing.assert_allclose(render.zbuffer[both], ref.zbuffer[both],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not supported"):
        render.draw(7)


@pytest.mark.parametrize("entry", [pipeline_from_config, PathTracing, RayTracing,
                                   TraditionalRasterizer],
                         ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(entry):
    """The port runs on the card unless the caller asks for the CPU: the
    default device is "cuda", and without a card that raises."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = (RenderConfig(width=8, height=8), "raster") if entry is pipeline_from_config else (8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(*args)


@pytest.mark.parametrize("kind", ["raster", "whitted", "path"])
def test_every_kind_builds_on_the_cpu_when_asked(kind):
    render = pipeline_from_config(RenderConfig(width=8, height=8), kind, device="cpu")
    assert render.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown pipeline kind"):
        pipeline_from_config(RenderConfig(), "voxel", device="cpu")


@pytest.mark.parametrize("levels", [1, 2])
def test_subdivide_mesh_equals_jax(levels):
    jdata = jsubdivide(jcornell().get_mesh_obj("tallbox").data, levels)
    tdata = subdivide_mesh(tcornell().get_mesh_obj("tallbox").data, levels)
    assert tdata.faces.shape[0] == 12 * 4 ** levels
    for field in ("vertices", "normals", "uvs", "colors", "faces", "bbox_min",
                  "bbox_max"):
        a, b = getattr(jdata, field), getattr(tdata, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_build_stress_scene_needs_its_obj(tmp_path):
    from software_rasterizer_tpu_torch.scenes.stress import build_stress_scene

    with pytest.raises(OSError):
        build_stress_scene(str(tmp_path / "missing.obj"), levels=1)
