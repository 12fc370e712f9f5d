"""The configuration `cornell_tess147k` at its own size on the CPU: the
Cornell box midpoint-subdivided 6 levels (36 x 4^6 = 147,456 triangles),
the scene of the benchmark cell `cornell_tess147k.path16`.

  * The scene comes from the configuration file's scene module and `levels`:
    147,456 triangles, one emitter.
  * `PathTracing.draw()` through `pipeline_from_config`, the cell's route,
    at 8x8 and 2 samples, takes the culled walk (one `pack_cull_tables` a
    draw) and matches the benchmark's plain reference
    (`benchmark/reference/path.render_pixels`, brute force over every
    triangle) on every pixel under the cell's own `atol` / `rtol`.
  * The cell, loaded by name as the benchmark's harness loads it, is one
    chip and reports the culled tier's metrics, not the full sweep's.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = "cornell_tess147k"
CELL = "cornell_tess147k.path16"
W = H = 8
SPP = 2
SEED = 2 ** 31 - 4099          # a frame seed is drawn from [0, 2**31)
TRIANGLES = 147_456


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch intra-op thread for this module, restored after: the
    draw and the reference are some 10^5 small operations on 64 lanes,
    and beside other test processes an intra-op pool on every core made
    them hundreds of times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _discover():
    """The benchmark's `harness.discover`, its packages on the import path."""
    if str(BENCH_DIR) not in sys.path:
        sys.path.append(str(BENCH_DIR))
    from harness import discover

    return discover


def _scene():
    """The cell's scene, built by the configuration's scene module."""
    discover = _discover()
    cfg = discover.load_json("configs", CONFIG)
    spec = cfg["scenes"][discover.load_json("workloads", CELL)["scene"]]
    scene = discover.load_module("scenes", spec["builder"]).build(**spec["args"])
    scene.rr = float(cfg["path"]["rr"])
    return scene


def test_scene_is_the_configurations_size():
    discover = _discover()
    from harness.inputs import scene_inputs
    from reference.scene import trace_space

    levels = discover.load_json("configs", CONFIG)["scenes"]["camera"]["args"]["levels"]
    scene = _scene()
    inputs = scene_inputs(scene)
    n_tri = sum(m["faces"].shape[0] for m in inputs["meshes"])
    assert levels == 6 and n_tri == 36 * 4 ** levels == TRIANGLES
    assert trace_space(inputs).n_emitters == 1
    assert not scene.spheres()


def test_draw_matches_the_plain_reference_on_every_pixel(monkeypatch):
    discover = _discover()
    from harness.inputs import scene_inputs
    from reference.path import render_pixels
    from reference.scene import trace_space
    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.render.pipeline import pipeline_from_config

    packed = []
    real_pack = pk.pack_cull_tables

    def counting_pack(scene):
        packed.append(scene.v0.shape[0])
        return real_pack(scene)

    monkeypatch.setattr(pk, "pack_cull_tables", counting_pack)
    bounces = int(discover.load_json("configs", CONFIG)["path"]["max_bounces"])
    scene = _scene()
    pipe = pipeline_from_config(RenderConfig(width=W, height=H, spp=SPP, max_bounces=bounces),
                                "path", device="cpu")
    pipe.add_scene(scene)
    inputs = scene_inputs(scene)     # after add_scene, as drivers/path_draw.py takes them
    pipe.seed = SEED
    pipe.draw()
    got = np.asarray(pipe.frame, np.float64).reshape(-1, 3)
    assert len(packed) == 1 and packed[0] >= TRIANGLES     # the culled walk, once

    ref = render_pixels(trace_space(inputs), SEED, W, H, inputs["fovy"], SPP, inputs["rr"],
                        bounces, torch.arange(W * H)).double().numpy()
    chk = discover.load_json("workloads", CELL)["check"]
    assert np.isfinite(got).all() and ref.max() > 0
    ok = (np.abs(got - ref) <= chk["atol"] + chk["rtol"] * np.abs(ref)).all(axis=1)
    assert ok.all(), np.flatnonzero(~ok)


REPORTED = ["mpaths_per_s.culled", "setup_s", "kernel_ms.path_camera_culled",
            "device_idle_pct.culled", "idle_ms.scene_upload.culled",
            "idle_ms.path_tables.culled", "idle_ms.readback.culled",
            "idle_ms.draw_rest.culled", "idle_ms.between_draws.culled",
            "setup_s.libraries", "setup_s.scene_geometry", "library_builds"]


@functools.lru_cache(maxsize=None)
def _cell():
    discover = _discover()
    return discover.cell(discover.load_benchmark(), CELL)


@pytest.mark.parametrize("metric", REPORTED)
def test_cell_reports_the_culled_tiers_metric(metric):
    spec = _cell()
    assert spec["entry"]["chips"] == 1 and spec["config"]["reduced"] == []
    assert metric in {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}


@pytest.mark.parametrize("metric", ["mpaths_per_s", "path_camera_roofline",
                                    "kernel_ms.path_camera", "device_idle_pct.path"])
def test_cell_does_not_report_the_full_sweeps_metric(metric):
    spec = _cell()
    assert metric not in {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
