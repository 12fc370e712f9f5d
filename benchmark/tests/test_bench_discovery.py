"""BENCHMARK.json against the benchmark's contract, and every piece of
every cell found by its name: traffic, configuration, scene builder,
driver, metric readers."""

import json
import re

import pytest

from harness import discover

BENCH = discover.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (discover.ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert BENCH["command"][1] == "benchmark/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((discover.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16


def test_workloads():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e_names = {m["name"] for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e_names and TEXT.match(m["layer"])
        assert "workloads" in m
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in layer:
        # every listed cell reports the end-to-end metric this one moves
        moved = next(x for x in e2e if x["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
    for m in e2e + layer:
        if m["name"].startswith(("roofline", "mfu")) or "_roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_traffic_file_names_a_known_config_and_driver():
    configs = {f.name[:-5] for f in (discover.BENCH_DIR / "configs").glob("*.json")}
    for f in (discover.BENCH_DIR / "workloads").glob("*.json"):
        t = json.loads(f.read_text())
        assert t["config"] in configs and TEXT.match(t["why"])
        assert hasattr(discover.load_module("drivers", t["driver"]), "Driver")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    spec = discover.cell(BENCH, cell)
    t = spec["traffic"]
    assert {"config", "scene", "driver", "check", "why"} <= set(t)
    assert t["why"] == spec["entry"]["why"]
    assert t["scene"] in spec["config"]["scenes"]
    builder = spec["config"]["scenes"][t["scene"]]["builder"]
    assert callable(discover.load_module("scenes", builder).build)
    assert hasattr(discover.load_module("drivers", t["driver"]), "Driver")
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(discover.load_module("metrics", m["name"]).read)
    assert 0 <= t["check"]["limit"] < 1


@pytest.mark.parametrize("kind,name", [("drivers", "../run"), ("metrics", "a/b"),
                                       ("scenes", "no_such_builder"), ("nothing", "x")])
def test_bad_names_refused(kind, name):
    with pytest.raises((ValueError, FileNotFoundError)):
        discover.load_module(kind, name)


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        discover.cell(BENCH, "no_such.cell")
