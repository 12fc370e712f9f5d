"""The correctness check: which frames of the window are compared (a
uniform sample, drawn from the run's seed, of every frame that came
back), which pixels of each (a uniform sample of the frame, drawn from the
seed), and the number compared: the share of those pixels whose colour
lies off the reference's by more than atol + rtol * |reference| in any
channel."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class Reservoir:
    """A uniform sample of `k` of the frames offered, drawn from `rng`.
    A frame is copied only when it is kept, so the window pays for
    about k * ln(frames) copies."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List[Tuple[int, dict, np.ndarray]] = []

    def offer(self, index: int, params: dict, image: np.ndarray) -> None:
        if self.seen < self.k:
            self.items.append((index, params, np.array(image, copy=True)))
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.k:
                self.items[slot] = (index, params, np.array(image, copy=True))
        self.seen += 1


def pixel_sample(rng: np.random.Generator, n_pixels: int, k: int) -> np.ndarray:
    """(k,) distinct row-major pixel ids, sorted."""
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False))


def off_pixels(image: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> int:
    """Pixels (rows of (P,3)) off the reference by more than the
    tolerance in some channel; a NaN anywhere in a pixel is off."""
    image, ref = image.double(), ref.double()
    ok = (image - ref).abs() <= atol + rtol * ref.abs()
    return int((~ok.all(dim=1)).sum())
