"""Whole runs of every cell on the CPU at a tiny size, through the
program's plain route: the result line's schema, the frozen reference
against the program, the control (the reference in bfloat16 in the
program's place) and planted faults all judged not correct, and the
reference's random streams against the program's."""

import copy
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import cell, discover
from reference import rng as ref_rng

SEED = 2 ** 31 + 977


def with_every_traffic(bench: dict) -> dict:
    """`bench` with a one-chip entry for every traffic file under
    `workloads/` that it does not list (cells measured and left out),
    so that their drivers, scenes and references stay tested."""
    bench = copy.deepcopy(bench)
    listed = {w["name"] for w in bench["workloads"]}
    for f in sorted((discover.BENCH_DIR / "workloads").glob("*.json")):
        name = f.name[:-len(".json")]
        if name not in listed:
            t = json.loads(f.read_text())
            bench["workloads"].append({"name": name, "config": t["config"],
                                       "traffic": name.split(".", 1)[1], "chips": 1,
                                       "why": t["why"]})
    return bench


BENCH = with_every_traffic(discover.load_benchmark())
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(name: str) -> dict:
    """A frame of 16x16 (32x32 for raster), 2 samples, and the
    tessellated scenes at 2 levels (576 triangles: the culled walk)."""
    cfg = discover.cell(BENCH, name)["config"]
    scenes = {k: dict(v, args={**v["args"], "levels": 2} if "levels" in v["args"]
                      else v["args"]) for k, v in cfg["scenes"].items()}
    side = 32 if "raster" in name else 16
    return {"width": side, "height": side, "scenes": scenes,
            "path": dict(cfg["path"], spp=2)}


def run(name, seconds=0.3, traced=False, **kw):
    return cell.run_cell(BENCH, name, SEED, seconds, traced, time.perf_counter(),
                         device="cpu", overrides=small(name), log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("cell_name", CELLS)
def test_program_matches_reference_and_control_does_not(cell_name):
    r = run(cell_name, control_dtype=torch.bfloat16)
    limit = r["checks"]["off_px_share"]["limit"]
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["control"]["off_px_share"] > limit


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(traced):
    r = run("cornell_box.path16", traced=traced)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    line = json.loads(json.dumps(r))
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    want = {m["name"] for m in discover.cell(BENCH, "cornell_box.path16")[
        "per_layer" if traced else "end_to_end"]}
    if traced:
        # no device events on the CPU: only the idle share and the host
        # clock's frame tail read something
        assert set(line["metrics"]) == {"device_idle_pct.path", "frame_ms_p95.path"}
        assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == want
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _broken(fault: str):
    """A load_module whose drivers break the frame they return."""
    real = discover.load_module

    def load(kind, name):
        mod = real(kind, name)
        if kind != "drivers":
            return mod

        class Broken(mod.Driver):
            last = None

            def frame(self, i):
                if fault == "half_samples" and hasattr(self, "spp"):
                    self.pipe.spp = max(1, self.spp // 2)
                image, bad = super().frame(i)
                image = np.array(image, copy=True)
                if fault == "stale":
                    # the state handed back unchanged: the previous frame
                    out, self.last = (self.last if self.last is not None else image), image
                    return out, bad
                if fault == "half_samples" and not hasattr(self, "spp"):
                    image[image.shape[0] // 2:] = 0.0     # half the frame left out
                if fault == "altered":
                    image *= 1.01
                return image, bad
        return SimpleNamespace(Driver=Broken)
    return load


@pytest.mark.parametrize("cell_name,fault", [
    (c, f) for c in CELLS for f in ("stale", "half_samples", "altered")
    # one emitter and a still camera: every Whitted frame is the same image
    if not (c == "cornell_box.whitted" and f == "stale")])
def test_faults_are_not_correct(monkeypatch, cell_name, fault):
    monkeypatch.setattr(discover, "load_module", _broken(fault))
    r = run(cell_name, seconds=0.6)
    assert not r["correct"], (fault, r["checks"])


def test_reference_streams_match_the_program():
    from software_rasterizer_tpu_torch.utils import rng as prog_rng

    for seed in (0, 7, 2 ** 31 - 1, 123456789):
        np.testing.assert_array_equal(ref_rng.sample_seeds(seed, 16),
                                      prog_rng.sample_seeds(seed, 0, 16))
    g = torch.Generator().manual_seed(3)
    seed = torch.randint(-2 ** 31, 2 ** 31, (64,), generator=g)
    lane = torch.randint(0, 1 << 20, (64,), generator=g)
    ctr = torch.randint(0, 200, (64,), generator=g)
    assert torch.equal(ref_rng.lowbias32_uniform(seed, lane, ctr),
                       prog_rng.lowbias32_uniform(seed, lane, ctr))


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell through run.py on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(discover.BENCH_DIR / "run.py"),
                          "--workload", CELLS[0], "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=discover.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
