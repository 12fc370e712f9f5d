"""The pipelines' read-back of a frame to the host
(`render/pipeline.readback`).

On the CPU: the array holds the bytes, dtype and shape of
`.cpu().numpy()` (a frame and a raster z-buffer with its +inf); a frame
a caller keeps from one `PathTracing.draw()` or `RayTracing.draw()` is
not changed by the next, and the Whitted frame stays writable (`clear()`
zeroes it in place).

On the card (marked `cuda`, skipped without one): the same bytes as the
old `.cpu().numpy()`, the array's base tensor page-locked, two frames
kept alive at once in separate memory, and a viewer that keeps only the
last frame asking the caching host allocator for no new block after its
first two draws. No JAX here: the card's tests run where it is absent.
"""

import numpy as np
import pytest
import torch

from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.render import pipeline_from_config
from software_rasterizer_tpu_torch.render.pipeline import readback
from software_rasterizer_tpu_torch.scenes import build_cornell_scene

W = 32


def _frame_and_zbuf(device):
    g = torch.Generator(device="cpu").manual_seed(7)
    frame = torch.rand((W, W + 8, 3), generator=g, dtype=torch.float32) * 4.0 - 1.0
    zbuf = torch.rand((W, W + 8), generator=g, dtype=torch.float32)
    zbuf[zbuf > 0.7] = float("inf")
    return frame.to(device), zbuf.to(device)


def _pipeline(kind, device, seed=3):
    cfg = RenderConfig(width=W, height=W, spp=1, max_bounces=2, seed=seed)
    render = pipeline_from_config(cfg, kind, device=device)
    render.add_scene(build_cornell_scene())
    return render


@pytest.mark.parametrize("which", ["frame", "zbuf"])
def test_readback_is_cpu_numpy_bit_for_bit(which):
    t = dict(zip(("frame", "zbuf"), _frame_and_zbuf("cpu")))[which]
    want = t.cpu().numpy()
    got = readback(t)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_path_frame_kept_is_not_changed_by_the_next_draw():
    render = _pipeline("path", "cpu")
    render.draw()
    kept = render.frame
    copy = kept.copy()
    render.seed += 1
    render.draw()
    assert render.frame is not kept and not np.shares_memory(render.frame, kept)
    assert np.array_equal(kept, copy)
    assert not np.array_equal(render.frame, copy)


def test_whitted_frame_kept_is_not_changed_and_stays_writable():
    render = _pipeline("whitted", "cpu")
    render.draw()
    kept = render.frame
    copy = kept.copy()
    assert kept.flags.writeable and kept.shape == (W, W, 3)
    render.draw()
    assert not np.shares_memory(render.frame, kept)
    assert np.array_equal(kept, copy)
    render.clear()
    assert not render.frame.any() and np.array_equal(kept, copy)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked memory is the card's")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["frame", "zbuf"])
def test_card_readback_is_the_old_copy_and_page_locked(card, which):
    t = dict(zip(("frame", "zbuf"), _frame_and_zbuf(card)))[which]
    want = t.cpu().numpy()
    got = readback(t)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got.flags.writeable and got.base.is_pinned()


@pytest.mark.cuda
def test_card_path_frame_is_the_old_copy_of_the_render(card, monkeypatch):
    from software_rasterizer_tpu_torch.render import pathtracer

    rendered, path_render = [], pathtracer.path_render

    def keep(*args, **kwargs):
        rendered.append(path_render(*args, **kwargs))
        return rendered[-1]

    monkeypatch.setattr(pathtracer, "path_render", keep)
    render = _pipeline("path", card)
    render.draw()
    [img] = rendered
    assert render.frame.tobytes() == img.cpu().numpy().tobytes()
    assert render.frame.shape == (W, W, 3) and render.frame.dtype == np.float32


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["path", "whitted"])
def test_card_frames_kept_alive_are_separate_and_page_locked(card, kind):
    render = _pipeline(kind, card)
    render.draw()
    first = render.frame
    copy = first.copy()
    if kind == "path":
        render.seed += 1
    render.draw()
    second = render.frame
    assert first.base.is_pinned() and second.base.is_pinned()
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, copy)


@pytest.mark.cuda
def test_card_viewer_settles_on_cached_blocks(card):
    """A viewer keeps the last frame while the next is drawn: after two
    draws the caching host allocator hands the same blocks round and
    makes no new page-locked block, so no draw waits on cudaHostAlloc."""
    render = _pipeline("path", card)
    for _ in range(2):
        render.seed += 1
        render.draw()
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(6):
        render.seed += 1
        render.draw()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
