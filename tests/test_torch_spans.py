"""The program's spans (utils/profiling.span) and build counter
(utils/cuda_build.BUILDS), on the CPU: a path draw under `torch.profiler`
records `srt.draw` around `srt.scene_upload` and `srt.readback` as
FUNCTION-scope host events, never user annotations; `span_totals()`
counts every span, from many threads at once; `build_once` counts what
it builds."""

import pathlib
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.render import pipeline_from_config
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.utils import cuda_build, profiling


def _pipeline():
    render = pipeline_from_config(RenderConfig(width=8, height=8, spp=1, max_bounces=2),
                                  "path", device="cpu")
    render.add_scene(build_cornell_scene())
    return render


def test_path_draw_records_nested_function_scope_spans():
    render = _pipeline()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render.draw()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("srt."):
            assert ev.device_type() == torch.autograd.DeviceType.CPU
            assert not ev.is_user_annotation(), ev.name()
            if hasattr(ev, "activity_type"):
                assert ev.activity_type() == "cpu_op", ev.name()
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    assert set(events) >= {"srt.draw", "srt.scene_upload", "srt.readback"}
    [(d0, d1)] = events["srt.draw"]
    for name in ("srt.scene_upload", "srt.readback", "srt.scene_geometry"):
        [(s, e)] = events[name]
        assert d0 <= s <= e <= d1, name
    (u0, u1), (r0, r1) = events["srt.scene_upload"][0], events["srt.readback"][0]
    assert u1 <= r0
    assert render.frame.shape == (8, 8, 3)


def test_span_totals_count_each_span():
    render = _pipeline()
    before = profiling.span_totals()
    render.draw()
    render.draw()
    after = profiling.span_totals()

    def added(name):
        return after[name][0] - before.get(name, (0, 0.0))[0]

    assert added("srt.draw") == 2
    assert added("srt.scene_upload") == 2
    assert added("srt.readback") == 2
    # the pipeline keeps a scene's geometry: built on the first draw only
    assert added("srt.scene_geometry") == 1
    assert after["srt.draw"][1] > before.get("srt.draw", (0, 0.0))[1]


def test_span_as_decorator_and_under_an_exception():
    @profiling.span("srt.test_decorated")
    def twice(x):
        """Doubles x."""
        return 2 * x

    before = profiling.span_totals().get("srt.test_decorated", (0, 0.0))[0]
    assert twice(3) == 6 and twice.__name__ == "twice" and twice.__doc__ == "Doubles x."
    with pytest.raises(ValueError):
        with profiling.span("srt.test_decorated"):
            raise ValueError("inside a span")
    count, seconds = profiling.span_totals()["srt.test_decorated"]
    assert count == before + 2 and seconds >= 0.0


def test_build_once_counts_its_builds(tmp_path):
    out, lock = tmp_path / "libstub-0.so", tmp_path / "stub_spans.lock"
    before = cuda_build.BUILDS.get("stub_spans", 0)
    assert cuda_build.build_once(out, lock, lambda tmp: pathlib.Path(tmp).write_bytes(b"lib"))
    assert cuda_build.BUILDS["stub_spans"] == before + 1
    # the file is there: nothing built, nothing counted
    assert not cuda_build.build_once(out, lock, lambda tmp: pytest.fail("built twice"))
    assert cuda_build.BUILDS["stub_spans"] == before + 1


def test_span_totals_lose_no_update_across_threads():
    n_threads, n_spans = 16, 500
    before = profiling.span_totals().get("srt.test_threads", (0, 0.0))[0]

    def work():
        for _ in range(n_spans):
            with profiling.span("srt.test_threads"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.span_totals()["srt.test_threads"][0] == before + n_threads * n_spans
