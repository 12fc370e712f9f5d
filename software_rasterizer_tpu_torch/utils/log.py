"""Structured logging + per-frame metrics.

The reference logs through spdlog with ad-hoc chrono spans
(PathTracing.cpp:42,90-94, BVHAcceleration.cpp:63-77). Here: stdlib
logging plus a JSON metrics emitter — Mpixels/s, Mrays/s, spp/s are the
BASELINE north-star metrics (SURVEY.md section 5.5).
"""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from typing import Dict, Optional

logger = logging.getLogger("software_rasterizer_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


@contextmanager
def span(name: str, extra: Optional[Dict] = None, quiet: bool = False):
    """Wall-clock span, reported in seconds (replaces the reference's
    chrono spans around draw())."""
    t0 = time.perf_counter()
    rec: Dict = {"span": name}
    try:
        yield rec
    finally:
        rec["seconds"] = time.perf_counter() - t0
        if extra:
            rec.update(extra)
        if not quiet:
            logger.info("%s took %.3fs", name, rec["seconds"])


def emit_metrics(metrics: Dict) -> str:
    """Emit one JSON line of metrics (bench.py consumes the same format)."""
    line = json.dumps(metrics)
    logger.info("METRICS %s", line)
    return line


class FrameMetrics:
    """Accumulates per-frame numbers into the BASELINE metric set."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.frame_times = []

    def add_frame(self, seconds: float):
        self.frame_times.append(seconds)

    def summary(self) -> Dict:
        import numpy as np

        ts = np.asarray(self.frame_times)
        if ts.size == 0:
            return {}
        px = self.width * self.height
        med = float(np.median(ts))
        return {
            "frames": int(ts.size),
            "median_ms": med * 1e3,
            "p10_ms": float(np.percentile(ts, 10)) * 1e3,
            "p90_ms": float(np.percentile(ts, 90)) * 1e3,
            "min_ms": float(ts.min()) * 1e3,
            "max_ms": float(ts.max()) * 1e3,
            "fps": 1.0 / med,
            "mpixels_per_s": px / med / 1e6,
        }
