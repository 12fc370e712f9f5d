"""The port's fault-tolerant tile-job runner and its multihost no-op: the
cases of tests/test_jobs.py, pointed at software_rasterizer_tpu_torch."""

import numpy as np
import pytest
import torch

from software_rasterizer_tpu_torch.parallel.jobs import TileJobRunner
from software_rasterizer_tpu_torch.parallel.multihost import gather_image, initialize


def test_tile_jobs_complete_frame():
    n, tl = 1024, 128
    runner = TileJobRunner(n, tl)

    def render(start, count):
        return np.full((count, 3), float(start))

    out = runner.run(render)
    assert out.shape == (n, 3)
    for j in range(n // tl):
        assert (out[j * tl : (j + 1) * tl] == j * tl).all()


def test_tile_jobs_retry_transient_failure():
    runner = TileJobRunner(512, 128, retries=3, backoff_s=0.0)
    fails = {1: 2}  # job 1 fails twice then succeeds

    def render(start, count):
        job = start // 128
        if fails.get(job, 0) > 0:
            fails[job] -= 1
            raise RuntimeError("transient")
        return np.zeros((count, 3))

    out = runner.run(render)
    assert out.shape == (512, 3)
    assert runner.attempts[1] == 3


def test_tile_jobs_permanent_failure_raises():
    runner = TileJobRunner(256, 128, retries=1, backoff_s=0.0)

    def render(start, count):
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError):
        runner.run(render)


def test_tile_jobs_rejects_nonfinite():
    runner = TileJobRunner(128, 128, retries=0)

    def render(start, count):
        out = np.zeros((count, 3))
        out[0, 0] = np.nan
        return out

    with pytest.raises(RuntimeError, match="bad output"):
        runner.run(render)


def test_multihost_single_process_noop():
    assert initialize() is False  # no coordinator configured
    img = torch.ones((4, 4, 3))
    out = gather_image(img)
    assert out.shape == (4, 4, 3)
