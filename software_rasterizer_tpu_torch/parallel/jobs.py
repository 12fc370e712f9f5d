"""Fault-tolerant render driver (SURVEY.md 5.3).

The reference has no failure handling — a crash loses the frame. Here a
frame is decomposed into restartable TILE JOBS (each renders a lane
range of the framebuffer); a failed job (device OOM, preemption,
transient runtime error) retries with exponential backoff, and completed
jobs are never recomputed. Combined with the spp-accumulator checkpoint
(render/pathtracer.py) this makes long offline renders resumable at
both the sample axis and the screen axis.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np


class TileJobRunner:
    """Run per-tile render closures with retries.

    render_tile(lane_start, lane_count) -> np.ndarray (lane_count, 3)
    """

    def __init__(self, n_lanes: int, tile_lanes: int,
                 retries: int = 3, backoff_s: float = 0.5):
        if n_lanes % tile_lanes:
            raise ValueError("tile_lanes must divide n_lanes")
        self.n_lanes = n_lanes
        self.tile_lanes = tile_lanes
        self.retries = retries
        self.backoff_s = backoff_s
        self.done: Dict[int, np.ndarray] = {}
        self.attempts: Dict[int, int] = {}

    @property
    def n_jobs(self) -> int:
        return self.n_lanes // self.tile_lanes

    def pending(self) -> List[int]:
        return [j for j in range(self.n_jobs) if j not in self.done]

    def run(self, render_tile: Callable[[int, int], np.ndarray],
            on_progress: Optional[Callable[[int, int], None]] = None) -> np.ndarray:
        for job in self.pending():
            start = job * self.tile_lanes
            delay = self.backoff_s
            for attempt in range(self.retries + 1):
                self.attempts[job] = self.attempts.get(job, 0) + 1
                try:
                    out = np.asarray(render_tile(start, self.tile_lanes))
                    if out.shape[0] != self.tile_lanes or not np.isfinite(out).all():
                        raise RuntimeError(
                            f"tile {job}: bad output "
                            f"(shape {out.shape}, finite={np.isfinite(out).all()})"
                        )
                    self.done[job] = out
                    break
                except Exception:
                    if attempt == self.retries:
                        raise
                    time.sleep(delay)
                    delay *= 2
            if on_progress:
                on_progress(len(self.done), self.n_jobs)
        return self.assemble()

    def assemble(self) -> np.ndarray:
        if len(self.done) != self.n_jobs:
            raise RuntimeError(f"{self.n_jobs - len(self.done)} tiles incomplete")
        return np.concatenate([self.done[j] for j in range(self.n_jobs)], axis=0)
