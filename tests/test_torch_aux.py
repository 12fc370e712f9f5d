"""The port's auxiliary subsystems (utils/metrics.py, utils/debug.py,
utils/profiling.py, config.py): the counterparts of tests/test_aux.py,
with the scene validators held against the JAX package's on the same
scene and the same corruption.

`debug_mode` is the counterpart of `jax_debug_nans`: a NaN in a
material's kd reaches the output of the bounce kernel's wrapper (or of
`path_trace` on the plain wavefront), which raises FloatingPointError;
clean Cornell renders of all three pipelines do not.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.utils import debug as jdebug
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
from software_rasterizer_tpu_torch.ops.path import path_trace
from software_rasterizer_tpu_torch.render import pipeline_from_config
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.utils import profiling
from software_rasterizer_tpu_torch.utils.debug import (
    debug_mode,
    nan_check,
    validate_raster_geometry,
    validate_rt_scene,
)
from software_rasterizer_tpu_torch.utils.metrics import FrameMetrics, MetricsRecorder

SIZE = 16


def _rt(scene=None):
    scene = scene or build_cornell_scene()
    scene.set_ndc_matrix(SIZE, SIZE)
    return prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")


def test_metrics_recorder(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    rec = MetricsRecorder(path)
    with rec.timed("raster", "s", 64, 64):
        pass
    rec.record(FrameMetrics("path", "s", 64, 64, draw_s=0.5, spp=8))
    assert len(rec.frames) == 2
    m = rec.frames[1]
    assert m.mpaths_per_s == pytest.approx(64 * 64 * 8 / 0.5 / 1e6)
    s = rec.summary()
    assert s["frames"] == 2 and s["min_s"] <= s["median_s"] <= s["max_s"]
    lines = [json.loads(line) for line in open(path)]
    assert lines[1]["mpaths_per_s"] == m.to_dict()["mpaths_per_s"]
    assert rec.summary("whitted") == {}


def test_validate_clean_scene():
    scene = build_cornell_scene()
    assert validate_rt_scene(_rt(scene)) == []
    assert validate_raster_geometry(scene.raster_geometry()) == []


def test_validate_detects_corruption_as_jax():
    """A corrupted RTScene (`dataclasses.replace`, where the JAX test
    calls `_replace`) gives the JAX validator's messages, which reads the
    same fields as numpy arrays."""
    rt = _rt()
    v0 = rt.v0.clone()
    v0[0, 0] = float("nan")
    bad = dataclasses.replace(rt, v0=v0, tri_mat=rt.tri_mat + 100)
    errs = validate_rt_scene(bad)
    assert any("v0" in e for e in errs) and any("tri_mat" in e for e in errs)
    as_np = types.SimpleNamespace(**{
        f.name: getattr(bad, f.name).numpy() if isinstance(getattr(bad, f.name), torch.Tensor)
        else getattr(bad, f.name) for f in dataclasses.fields(bad)})
    assert errs == jdebug.validate_rt_scene(as_np)


def test_validate_raster_geometry_corruption_as_jax():
    geom = build_cornell_scene().raster_geometry()
    faces = geom.faces.copy()
    faces[0, 0] = geom.positions.shape[0]
    uvs = geom.uvs.copy()
    uvs[1, 1] = np.inf
    bad = geom._replace(faces=faces, uvs=uvs, face_mesh=geom.face_mesh + 50)
    errs = validate_raster_geometry(bad)
    assert len(errs) == 3 and errs[0].startswith("uvs")
    jgeom = jcornell().raster_geometry()
    jbad = jgeom._replace(faces=faces, uvs=uvs, face_mesh=jgeom.face_mesh + 50)
    assert errs == jdebug.validate_raster_geometry(jbad)
    # tensors validate as arrays do
    as_t = bad._replace(**{k: torch.as_tensor(getattr(bad, k))
                           for k in ("positions", "faces", "uvs", "face_mesh")})
    assert validate_raster_geometry(as_t) == errs


@pytest.mark.parametrize("fused", [None, False])
def test_debug_mode_catches_nan(fused):
    scene = build_cornell_scene()
    scene.get_mesh_obj("left").material.Kd = (float("nan"), 0.0, 0.0)
    rt = _rt(scene)
    o, d = camera_rays(rt.eye.numpy(), scene.fovy, SIZE, SIZE, "cpu")
    out = path_trace(rt, o, d, 3, max_bounces=4, fused=fused)
    assert bool(torch.isnan(out).any())  # outside debug_mode: handed on
    stage = "fused_bounce_group" if fused is None else "path_trace"
    with pytest.raises(FloatingPointError, match=stage):
        with debug_mode():
            path_trace(rt, o, d, 3, max_bounces=4, fused=fused)
    with debug_mode(nans=False):
        path_trace(rt, o, d, 3, max_bounces=4, fused=fused)


@pytest.mark.parametrize("kind", ["path", "whitted", "raster"])
def test_debug_mode_is_silent_on_a_clean_render(kind):
    render = pipeline_from_config(RenderConfig(width=SIZE, height=SIZE, spp=2), kind,
                                  device="cpu")
    render.add_scene(build_cornell_scene())
    with debug_mode():
        render.draw()
    assert np.isfinite(render.frame).all()


def test_nan_check_reads_nothing_outside_debug_mode():
    nan = torch.tensor([float("nan"), float("inf")])
    out = {"a": nan, "b": (nan, torch.tensor([1]))}
    assert nan_check("stage", out) is out
    with debug_mode():
        with pytest.raises(FloatingPointError, match="NaN in the output of stage"):
            nan_check("stage", out)
        # inf and integer tensors pass: NaN only, as jax_debug_nans
        nan_check("stage", (torch.tensor([float("inf")]), torch.tensor([-1])))


def test_config_roundtrip():
    c = RenderConfig(width=256, spp=8, raster_tile=(64, 128))
    c2 = RenderConfig.from_json(c.to_json())
    assert c2 == c


def test_profiling_trace_on_cpu(tmp_path, capsys):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, device="cpu") as d:
        assert d == log_dir
        x = torch.arange(4096, dtype=torch.float32)
        (x * x).sum()
    rows = profiling.summarize_device_time(log_dir, top=5)
    assert 1 <= len(rows) <= 5
    assert all(isinstance(n, str) and s >= 0.0 and c >= 1 for n, s, c in rows)
    assert any(n.startswith("aten::") for n, _, _ in rows)
    profiling.print_summary(log_dir, top=5)
    assert "device-s" in capsys.readouterr().out
    assert profiling.summarize_device_time(str(tmp_path / "none")) == []
