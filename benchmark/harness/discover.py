"""Finding a cell's pieces by name: `BENCHMARK.json` at the root of the
checkout, `configs/<config>.json`, `workloads/<cell>.json`, and the Python
files `scenes/<builder>.py`, `drivers/<entry>.py` and `metrics/<metric>.py`
under the benchmark's folder. A name may hold dots, so modules are loaded
from their file path, not imported by name."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KINDS = ("configs", "workloads", "scenes", "drivers", "metrics")


def _path(kind: str, name: str, suffix: str) -> pathlib.Path:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if not NAME.match(name) or ".." in name:
        raise ValueError(f"bad {kind} name {name!r}")
    path = BENCH_DIR / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_json(kind: str, name: str) -> dict:
    return json.loads(_path(kind, name, ".json").read_text())


def load_module(kind: str, name: str) -> ModuleType:
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    """Everything a run of `workload` needs: its entry in BENCHMARK.json,
    its traffic file, its configuration file, and the end-to-end and
    per-layer metric entries it reports."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"workload {workload!r} is not in BENCHMARK.json")
    entry = entries[0]
    traffic = load_json("workloads", workload)
    if traffic["config"] != entry["config"]:
        raise ValueError(f"{workload}: traffic names config {traffic['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "entry": entry,
        "traffic": traffic,
        "config": load_json("configs", entry["config"]),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }
