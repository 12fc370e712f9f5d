"""The metric arithmetic and the trace reduction, on hand-made numbers."""

import math

import pytest

from harness import stats, trace


def test_rate_over_whole_window():
    assert stats.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("n,expect", [(1, 0.0), (20, 18.0), (100, 94.0), (101, 95.0)])
def test_p95_nearest_rank_over_every_frame(n, expect):
    values = [float(i) for i in range(n)]
    got = stats.percentile(list(reversed(values)), 95)
    assert got == expect
    # the smallest value that at least 95% of the values do not exceed
    assert sum(v <= got for v in values) >= 0.95 * n
    assert sum(v < got for v in values) < 0.95 * n


def test_union_of_busy_intervals_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert stats.union_length(iv, 0, 10) == pytest.approx(2 + 1 + 1 + 2)
    assert stats.union_length(iv, 1, 5.5) == pytest.approx(2.5)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.gaps([], 0, 4) == [(0, 4)]
    assert stats.union_length([], 0, 1) == 0.0


def test_idle_share():
    assert stats.idle_pct(15.0, 20.0) == pytest.approx(25.0)
    assert stats.idle_pct(20.0, 20.0) == 0.0


def test_roofline_count_and_least_time():
    ops = stats.brute_force_ops(tests=1e9, stage1_passes=1e8, segments=1e7)
    assert ops == pytest.approx(28e9 + 30e8 + 150e7)
    t, by = stats.least_ms(ops, n_bytes=1e6)
    assert by == "operations" and t == pytest.approx(ops / 67e12 * 1e3)
    t, by = stats.least_ms(1.0, n_bytes=3.35e9)
    assert by == "bytes" and t == pytest.approx(1.0)


def test_kernel_names():
    assert trace.kernel_name("void path_camera_kernel<false>(Params)") == "path_camera_kernel<false>"
    cupti = "void (anonymous namespace)::path_camera_kernel<false>((anonymous namespace)::Params)"
    assert trace.kernel_name(cupti) == "(anonymous namespace)::path_camera_kernel<false>"
    assert trace.base_name(cupti) == "path_camera_kernel<false>"
    assert trace.base_name("void at::native::reduce_kernel<512, 1, at::native::Op<float> >(int)") \
        == "reduce_kernel<512, 1, at::native::Op<float> >"
    assert trace.base_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    assert trace.named("path_camera_kernel")(cupti)
    assert trace.named("path_camera_kernel")("path_camera_kernel<true>")
    assert not trace.named("coarse_bin_kernel", "raster_tile_kernel")("void at::native::elementwise")


def _record():
    # window [100, 1100) us, two frames
    device = [("void path_camera_kernel<false>(Params)", 100, 500, "kernel"),
              ("Memcpy DtoH (Device -> Pageable)", 500, 600, "gpu_memcpy"),
              ("path_camera_kernel<false>", 700, 1000, "kernel"),
              ("at::native::fill", 50, 150, "kernel")]
    host = [(trace.WINDOW_SPAN, 100, 1100), ("bench.draw", 100, 640),
            ("bench.draw", 640, 1090), ("aten::copy_", 600, 690),
            ("prepare_rt_scene", 610, 640)]
    return trace.TraceRecord(device, host, 100.0, 1100.0, 2)


def test_trace_record_busy_kernel_time_and_breakdown():
    rec = _record()
    assert rec.window_s == pytest.approx(1e-3)
    # 100-600 and 700-1000 inside the window
    assert rec.busy_s() == pytest.approx(800e-6)
    assert rec.kernel_ms_per_frame(trace.named("path_camera_kernel")) == pytest.approx(0.35)
    assert rec.kernel_ms_per_frame(trace.named("nothing")) is None
    b = rec.breakdown()
    assert b["device_ops"][0] == ["path_camera_kernel<false>", pytest.approx(700e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    idle = dict((n, s) for n, s in b["idle_gaps"])
    # gap 600-700 (mid 650: aten::copy_ is the innermost around it), 1000-1100
    assert idle["aten::copy_"] == pytest.approx(100e-6)
    assert idle["host code in bench.draw"] == pytest.approx(100e-6)
    assert math.isclose(sum(idle.values()), rec.window_s - rec.busy_s())


def test_every_metric_reader_reads_a_window_and_a_trace():
    from types import SimpleNamespace

    from harness import discover

    rec = _record()
    ctx = SimpleNamespace(frames=2, window_s=0.5, frame_ms=[240.0, 260.0], setup_s=8.0,
                          work_per_frame=1024 * 1024 * 16, min_bytes=1e6, trace=rec,
                          counts={"tests": 1e9, "stage1_passes": 1e8, "segments": 1e7})
    files = sorted((discover.BENCH_DIR / "metrics").glob("*.py"))
    assert files
    for f in files:
        value = discover.load_module("metrics", f.name[:-3]).read(ctx)
        assert value is None or math.isfinite(value), f.name
    untraced = SimpleNamespace(**{**vars(ctx), "trace": None})
    for f in files:
        traced_only = ("_pct." in f.name or "_roofline" in f.name
                       or f.name.startswith(("kernel_ms.", "torch_ops_ms.")))
        if traced_only:
            assert discover.load_module("metrics", f.name[:-3]).read(untraced) is None
