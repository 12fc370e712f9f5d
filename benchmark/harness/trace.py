"""The traced run: `torch.profiler` over the window (CPU and CUDA
activities, no shapes, no stacks), reduced in memory to device intervals,
host events and the window's bounds.

The harness marks its own spans with `record_function` names that start
with `bench.`: `bench.window` around the whole window, and the drivers'
spans around each call into the program (`bench.draw`, ...). Device
events are the kernels, copies and fills CUPTI recorded; their times are
on the same clock as the host's events.
"""

from __future__ import annotations

import collections
import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from harness import stats

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_KINDS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def kernel_name(name: str) -> str:
    """A kernel's name without the return type and the argument list that
    CUPTI's demangled names carry: `void (anonymous namespace)::
    path_camera_kernel<false>(Params)` -> `(anonymous namespace)::
    path_camera_kernel<false>`."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[5:] if name.startswith("void ") else name


def base_name(name: str) -> str:
    """`kernel_name` without its namespaces: the function's own name and
    template arguments (`path_camera_kernel<false>`)."""
    name, depth, start = kernel_name(name), 0, 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1, "(": 1, ")": -1}.get(ch, 0)
        if depth == 0 and name.startswith("::", i):
            start = i + 2
    return name[start:]


def named(*prefixes: str) -> Callable[[str], bool]:
    """A match for kernels whose name starts with one of `prefixes`."""
    return lambda name: base_name(name).startswith(prefixes)


@dataclass
class TraceRecord:
    """What a metric reader sees of a traced window. Times in us."""

    device: List[Tuple[str, float, float, str]]   # (name, start, end, kind)
    host: List[Tuple[str, float, float]]          # (name, start, end)
    lo: float
    hi: float
    frames: int
    kinds: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or fill ran."""
        return stats.union_length(((s, e) for _, s, e, _ in self.device),
                                  self.lo, self.hi) / 1e6

    def kernel_ms_per_frame(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device ms a frame of the kernels whose name `match`es, None
        where no such kernel ran in the window."""
        total, seen = 0.0, False
        for name, s, e, kind in self.device:
            if kind == "kernel" and match(name):
                total += min(e, self.hi) - max(s, self.lo)
                seen = True
        if not seen or self.frames == 0:
            return None
        return total / 1e3 / self.frames

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the device summed by the innermost host event around each gap
        (`host code in <span>` where only the harness's own span encloses
        it: Python or NumPy between operations)."""
        by_op: Dict[str, float] = collections.Counter()
        for name, s, e, _ in self.device:
            by_op[kernel_name(name)] += max(0.0, min(e, self.hi) - max(s, self.lo)) / 1e6
        idle = stats.gaps(((s, e) for _, s, e, _ in self.device), self.lo, self.hi)
        by_host: Dict[str, float] = collections.Counter()
        host = sorted((h for h in self.host if h[0] != WINDOW_SPAN), key=lambda h: h[1])
        active: list = []          # heap of (duration, end, name), started so far
        i = 0
        for g0, g1 in sorted(idle, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (g0 + g1)
            while i < len(host) and host[i][1] <= mid:
                name, s, e = host[i]
                heapq.heappush(active, (e - s, e, name))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            label = active[0][2] if active else "outside any host event"
            if label.startswith(SPAN_PREFIX):
                label = f"host code in {label}"
            by_host[label] += (g1 - g0) / 1e6
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in by_host.most_common(top)]}


def _kind(ev) -> str:
    """The event's activity kind. Where the event does not name it (older
    PyTorch), a device event is a copy or fill by its name, one of the
    harness's own spans (a `gpu_user_annotation`) by its prefix, else a
    kernel; every host event counts as `cpu_op`."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    if "cuda" in str(ev.device_type()).lower():
        name = ev.name()
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "gpu_user_annotation" if name.startswith(SPAN_PREFIX) else "kernel"
    return "cpu_op"


def _from_kineto(prof) -> Tuple[list, list, Dict[str, int]]:
    device, host, kinds = [], [], collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        kinds[kind] += 1
        if hasattr(ev, "start_ns"):
            s, dur = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
        else:
            s, dur = float(ev.start_us()), float(ev.duration_us())
        if kind in DEVICE_KINDS:
            device.append((ev.name(), s, s + dur, kind))
        elif kind in HOST_KINDS:
            host.append((ev.name(), s, s + dur))
    return device, host, dict(kinds)


class Tracer:
    """`torch.profiler` (CPU activity, and CUDA with `cuda`) around the
    `bench.window` span, started and stopped by the caller. `raw` gets
    "device", "host" and "kinds" at `stop`. Disabled, it does nothing."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda, self.raw, self.running = enabled, cuda, {}, False

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts, record_shapes=False, with_stack=False)
        self.prof.start()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.running = True

    def stop(self) -> None:
        if not self.running:
            return
        import torch

        self.span.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.running = False
        self.raw["device"], self.raw["host"], self.raw["kinds"] = _from_kineto(self.prof)
        del self.prof


def record(raw: dict, frames: int) -> TraceRecord:
    """The TraceRecord of a stopped `Tracer`: the window is its host span
    `bench.window`, in which `frames` frames came back."""
    spans = [(s, e) for name, s, e in raw["host"] if name == WINDOW_SPAN]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} {WINDOW_SPAN} spans in the trace")
    lo, hi = spans[0]
    return TraceRecord(raw["device"], raw["host"], lo, hi, frames, raw["kinds"])
