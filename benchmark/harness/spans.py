"""The program's own spans in a run: what the per-layer metrics of its
stages read.

The program marks its stages with `software_rasterizer_tpu_torch.utils.
profiling.span`: host events named `srt.<stage>` on the profiler's clock,
which a traced window carries in `TraceRecord.host` beside PyTorch's
operators and the CUDA runtime's calls, and a process-wide table of
counts and host seconds (`span_totals()`) that set-up, before the window
opens, is read from. A frame is one `srt.draw`; the stages inside it are
`srt.scene_upload`, `srt.path_tables`, `srt.launch.path_camera` and
`srt.readback`.

Every reader returns None where there is nothing to read: no traced
window, a window without device events (a run on the CPU), or a program
without these spans and counters.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from harness import stats

DRAW = "srt.draw"
# the part of a frame that each span's inside belongs to; the inside of
# `srt.draw` outside these is "draw_rest", and outside every `srt.draw`
# "between_draws" (the caller between frames)
PARTS = {
    "srt.scene_upload": "scene_upload",
    "srt.path_tables": "path_tables",
    "srt.launch.path_camera": "path_tables",
    "srt.readback": "readback",
    DRAW: "draw_rest",
}
BETWEEN = "between_draws"
PART_NAMES = ("scene_upload", "path_tables", "readback", "draw_rest", BETWEEN)
# host calls that put work on the device's queues
ENQUEUE = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def frame_trace(ctx):
    """`ctx.trace` where its window holds device events and the program's
    `srt.draw` spans, else None."""
    rec = ctx.trace
    if rec is None or not rec.device or rec.frames <= 0:
        return None
    if not any(name == DRAW for name, _, _ in rec.host):
        return None
    return rec


def _segments(rec) -> List[Tuple[float, float, str]]:
    """[lo, hi) of the window cut where a part span starts or ends, each
    piece with the part of the innermost part span around it (the one
    that started last; of two that started together, the shorter)."""
    spans = sorted((max(s, rec.lo), min(e, rec.hi), PARTS[name])
                   for name, s, e in rec.host
                   if name in PARTS and min(e, rec.hi) > max(s, rec.lo))
    cuts = sorted({rec.lo, rec.hi} | {t for s, e, _ in spans for t in (s, e)})
    out, active, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(spans) and spans[i][0] <= a:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[1] > a]
        part = max(active, key=lambda sp: (sp[0], -sp[1]))[2] if active else BETWEEN
        out.append((a, b, part))
    return out


def idle_split(rec) -> Dict[str, float]:
    """The device's idle time in the window, us, split exactly among the
    parts of `PART_NAMES`: each idle stretch is cut where a part span
    starts or ends, and each piece goes to the innermost part span around
    it. The parts sum to the window's idle time."""
    out = dict.fromkeys(PART_NAMES, 0.0)
    segs = _segments(rec)
    j = 0
    for g0, g1 in stats.gaps(((s, e) for _, s, e, _ in rec.device), rec.lo, rec.hi):
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, part = segs[k]
            out[part] += min(b, g1) - max(a, g0)
            k += 1
    return out


def idle_ms_per_frame(ctx, part: str) -> Optional[float]:
    """Device idle ms a frame inside `part` (one of `PART_NAMES`)."""
    rec = frame_trace(ctx)
    if rec is None:
        return None
    return idle_split(rec)[part] / 1e3 / rec.frames


def _inside(rec, name: str) -> List[Tuple[float, float]]:
    return sorted((s, e) for n, s, e in rec.host
                  if n == name and e > rec.lo and s < rec.hi)


def enqueues_per_frame(ctx, name: str) -> Optional[float]:
    """Host calls a frame that put work on the device (`ENQUEUE`) made
    inside the span `name`; None where the window has no such span."""
    rec = frame_trace(ctx)
    spans = [] if rec is None else _inside(rec, name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for ev, s, e in rec.host:
        if ev.startswith(ENQUEUE):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= spans[i][1]:
                n += 1
    return n / rec.frames


def host_ms_per_frame(ctx, name: str) -> Optional[float]:
    """Host ms a frame spent inside the span `name` in the window; None
    where the window has no such span."""
    rec = frame_trace(ctx)
    spans = [] if rec is None else _inside(rec, name)
    if not spans:
        return None
    return sum(min(e, rec.hi) - max(s, rec.lo) for s, e in spans) / 1e3 / rec.frames


def _on_card(ctx) -> bool:
    return ctx.trace is not None and bool(ctx.trace.device)


def setup_seconds(ctx, name: str) -> Optional[float]:
    """Host seconds of every span `name` the run's process closed
    (`span_totals()`), in a traced run on the card; None where the
    program keeps no such table or closed no such span."""
    if not _on_card(ctx):
        return None
    from software_rasterizer_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None:
        return None
    entry = totals().get(name)
    return None if entry is None else float(entry[1])


def library_builds(ctx) -> Optional[float]:
    """Libraries the run's process built (`cuda_build.BUILDS`), in a
    traced run on the card; None where the program does not count them."""
    if not _on_card(ctx):
        return None
    from software_rasterizer_tpu_torch.utils import cuda_build

    builds = getattr(cuda_build, "BUILDS", None)
    return None if builds is None else float(sum(builds.values()))
