"""Device-time profiling (SURVEY.md 5.1), the port of the JAX package's
utils/profiling.py.

The reference's profiling is ad-hoc chrono spans (PathTracing.cpp:42,
BVHAcceleration.cpp:63-77). Here: a `trace()` context manager over
`torch.profiler`, which writes a Chrome trace into a directory, and a
summarizer that aggregates per-op time from the newest trace there. On
the card the rows are the kernels CUPTI recorded, the hand-written
kernels launched through ctypes among them under their own names; on the
CPU (`device="cpu"`) they are the PyTorch operators.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

# the trace's event category summarized, by the device named in its file
_CATEGORY = {"cuda": "kernel", "cpu": "cpu_op"}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device="cuda"):
    """Profile the enclosed block with `torch.profiler` (the CPU activity,
    and the CUDA activity on the card) and write its Chrome trace into
    `log_dir` (default: `srtpu_trace` in the temporary directory) as
    `<time>-<pid>.<device>.trace.json.gz`. `device` is where the block
    runs: the card unless the caller asks for "cpu"; "cuda" raises
    without a card. Yields `log_dir`."""
    kind = torch.device(device).type
    if kind not in _CATEGORY:
        raise ValueError(f"unsupported device {device}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "srtpu_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if kind == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        if kind == "cuda":
            torch.cuda.synchronize()
    name = f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.{kind}.trace.json.gz"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def summarize_device_time(log_dir: str, top: int = 20) -> List[Tuple[str, float, int]]:
    """Aggregate per-op wall time from the newest trace under `log_dir`:
    the kernels of a trace taken on the card, the PyTorch operators of
    one taken on the CPU. Returns [(op_name, total_seconds, count)]
    sorted by time."""
    files = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        return []
    kind = files[-1].rsplit(".", 4)[-4]
    if kind not in _CATEGORY:
        raise ValueError(f"{files[-1]}: no device in the file name")
    with gzip.open(files[-1]) as f:
        tr = json.load(f)
    dur: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e and e.get("cat") == _CATEGORY[kind]:
            dur[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    rows = [(name, us / 1e6, cnt[name]) for name, us in dur.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def print_summary(log_dir: str, top: int = 20) -> None:
    rows = summarize_device_time(log_dir, top)
    if not rows:
        print("no device events captured")
        return
    total = sum(r[1] for r in rows)
    print(f"{'device-s':>10}  {'count':>7}  op")
    for name, s, c in rows:
        print(f"{s:10.4f}  {c:7d}  {name[:80]}")
    print(f"{total:10.4f}  (top-{len(rows)} total)")
