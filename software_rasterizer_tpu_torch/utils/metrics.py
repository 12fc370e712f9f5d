"""Structured per-frame metrics (SURVEY.md 5.5).

The reference logs ad-hoc chrono spans through spdlog
(src/PathTracing.cpp:42,90-94, src/BVHAcceleration.cpp:63-77) and its
README benchmarks time `draw()` only, excluding display
(README.md:615,639). This module makes that methodology first-class:
renders record `FrameMetrics` rows (wall time of the device step, derived
Mpixels/s / Mpaths/s / spp/s) which can stream to a JSONL file for the
benchmark harness.

The port's draws return before the card has finished, so `timed`
synchronizes the card (when CUDA is initialized) on entry and on exit:
`draw_s` is then the device step, not its enqueue.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

import torch


def _sync() -> None:
    """Wait for the card, if this process has touched it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class FrameMetrics:
    pipeline: str            # "raster" | "whitted" | "path"
    scene: str
    width: int
    height: int
    draw_s: float            # device step wall time (display excluded)
    spp: int = 1
    frame_index: int = 0
    extra: Optional[dict] = None

    @property
    def mpixels_per_s(self) -> float:
        return self.width * self.height / self.draw_s / 1e6

    @property
    def mpaths_per_s(self) -> float:
        return self.width * self.height * self.spp / self.draw_s / 1e6

    @property
    def fps(self) -> float:
        return 1.0 / self.draw_s

    def to_dict(self) -> dict:
        d = {
            "pipeline": self.pipeline,
            "scene": self.scene,
            "config": f"{self.width}x{self.height}@{self.spp}spp",
            "frame": self.frame_index,
            "draw_s": round(self.draw_s, 6),
            "mpixels_per_s": round(self.mpixels_per_s, 3),
            "fps": round(self.fps, 3),
        }
        if self.pipeline in ("whitted", "path"):
            d["mpaths_per_s"] = round(self.mpaths_per_s, 3)
        if self.extra:
            d.update(self.extra)
        return d


class MetricsRecorder:
    """Collects FrameMetrics; optionally appends JSONL to `path`."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.frames: List[FrameMetrics] = []

    def record(self, m: FrameMetrics):
        self.frames.append(m)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(m.to_dict()) + "\n")

    def timed(self, pipeline: str, scene: str, width: int, height: int,
              spp: int = 1, **extra):
        """Context manager timing one draw; records on exit. The card is
        synchronized on entry (earlier queued work is not counted) and on
        exit (the draw's device work is)."""
        rec = self

        class _Span:
            def __enter__(self):
                _sync()
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                if exc[0] is None:
                    _sync()
                    rec.record(FrameMetrics(
                        pipeline, scene, width, height,
                        time.perf_counter() - self.t0, spp,
                        frame_index=len(rec.frames), extra=extra or None,
                    ))

        return _Span()

    def summary(self, pipeline: Optional[str] = None) -> dict:
        """Median/p10/p90 of draw_s — the reference README's benchmark
        statistics (README.md:624-632)."""
        rows = [f for f in self.frames if pipeline is None or f.pipeline == pipeline]
        if not rows:
            return {}
        import numpy as np

        ts = np.array([f.draw_s for f in rows])
        return {
            "frames": len(rows),
            "median_s": float(np.median(ts)),
            "p10_s": float(np.percentile(ts, 10)),
            "p90_s": float(np.percentile(ts, 90)),
            "min_s": float(ts.min()),
            "max_s": float(ts.max()),
            "median_fps": float(1.0 / np.median(ts)),
        }
