"""The readers of the program's spans (`harness/spans.py`) on a hand-made
traced window: the exact split of the device's idle time among nested
spans, the count of enqueueing calls inside a span, and the set-up
readers, each None where the program has no such span or counter."""

from types import SimpleNamespace

import pytest

from harness import discover, spans, stats, trace

PARTS = ("scene_upload", "path_tables", "readback", "draw_rest", "between_draws")


def _record():
    # window [0, 1000) us, two frames; the device busy in six stretches,
    # so the idle stretches straddle span boundaries
    device = [("path_camera_kernel<false>", -10, 50, "kernel"),
              ("elementwise", 200, 265, "kernel"),
              ("path_camera_kernel<false>", 320, 420, "kernel"),
              ("Memcpy DtoH (Device -> Pageable)", 470, 560, "gpu_memcpy"),
              ("elementwise", 700, 850, "kernel"),
              ("Memset (Device)", 990, 1010, "gpu_memset")]
    host = [(trace.WINDOW_SPAN, 0, 1000), ("bench.draw", 99, 501), ("bench.draw", 549, 951),
            ("srt.draw", 100, 500),
            ("srt.scene_upload", 120, 250),
            ("cudaLaunchKernel", 130, 135), ("cudaMemcpyAsync", 140, 150),
            ("aten::mul", 150, 160), ("cudaStreamSynchronize", 160, 170),
            ("srt.path_tables", 260, 300),
            ("srt.launch.path_camera", 300, 320), ("cuLaunchKernel", 305, 310),
            ("srt.readback", 400, 480), ("cudaMemcpyAsync", 405, 470),
            ("srt.draw", 550, 950),
            ("srt.scene_upload", 560, 700),
            ("cuLaunchKernel", 600, 605), ("cudaMemsetAsync", 610, 612),
            ("srt.readback", 850, 940)]
    return trace.TraceRecord(device, host, 0.0, 1000.0, 2)


def _ctx(rec):
    return SimpleNamespace(trace=rec)


def test_idle_time_split_exactly_among_nested_spans():
    rec = _record()
    got = spans.idle_split(rec)
    # idle [50,200) [265,320) [420,470) [560,700) [850,990), cut at the
    # span boundaries inside each: 50-100 between, 100-120 draw, 120-200
    # upload; 265-300 tables, 300-320 launch; 420-470 read-back; 560-700
    # upload; 850-940 read-back, 940-950 draw, 950-990 between
    assert got == pytest.approx({"scene_upload": 220.0, "path_tables": 55.0,
                                 "readback": 140.0, "draw_rest": 30.0,
                                 "between_draws": 90.0})
    idle_us = (rec.hi - rec.lo) - rec.busy_s() * 1e6
    assert sum(got.values()) == pytest.approx(idle_us)
    per_frame = [spans.idle_ms_per_frame(_ctx(rec), p) for p in PARTS]
    assert per_frame == pytest.approx([0.110, 0.0275, 0.070, 0.015, 0.045])
    assert sum(per_frame) == pytest.approx((rec.window_s - rec.busy_s()) * 1e3 / rec.frames)


def test_a_span_that_starts_with_its_parent_is_the_innermost():
    host = [("srt.draw", 0, 100), ("srt.scene_upload", 0, 60), ("srt.readback", 60, 100)]
    rec = trace.TraceRecord([("k", 90, 95, "kernel")], host, 0.0, 100.0, 1)
    assert spans.idle_split(rec) == pytest.approx(
        {"scene_upload": 60.0, "path_tables": 0.0, "readback": 35.0, "draw_rest": 0.0,
         "between_draws": 0.0})


def test_enqueues_and_host_time_inside_the_scene_upload():
    ctx = _ctx(_record())
    # cudaLaunchKernel, cudaMemcpyAsync; cuLaunchKernel, cudaMemsetAsync
    assert spans.enqueues_per_frame(ctx, "srt.scene_upload") == 2.0
    assert spans.enqueues_per_frame(ctx, "srt.readback") == 0.5
    assert spans.host_ms_per_frame(ctx, "srt.scene_upload") == pytest.approx(0.135)
    assert spans.enqueues_per_frame(ctx, "srt.no_such_span") is None


def test_nothing_to_read_without_the_programs_spans_or_a_device():
    rec = _record()
    without_spans = trace.TraceRecord(
        rec.device, [h for h in rec.host if not h[0].startswith("srt.")], rec.lo, rec.hi, 2)
    on_the_cpu = trace.TraceRecord([], rec.host, rec.lo, rec.hi, 2)
    for r in (None, without_spans, on_the_cpu):
        ctx = _ctx(r)
        assert all(spans.idle_ms_per_frame(ctx, p) is None for p in PARTS)
        assert spans.enqueues_per_frame(ctx, "srt.scene_upload") is None
        assert spans.host_ms_per_frame(ctx, "srt.scene_upload") is None


def test_setup_readers(monkeypatch):
    from software_rasterizer_tpu_torch.utils import cuda_build, profiling

    monkeypatch.setattr(profiling, "span_totals",
                        lambda: {"srt.load_library": (6, 1.5), "srt.scene_geometry": (1, 0.25)})
    monkeypatch.setattr(cuda_build, "BUILDS", {"path_camera": 1, "srt_native": 1})
    ctx = _ctx(_record())
    assert spans.setup_seconds(ctx, "srt.load_library") == 1.5
    assert spans.setup_seconds(ctx, "srt.scene_geometry") == 0.25
    assert spans.setup_seconds(ctx, "srt.no_such_span") is None
    assert spans.library_builds(ctx) == 2.0
    on_the_cpu = _ctx(trace.TraceRecord([], [], 0.0, 1.0, 1))
    assert spans.setup_seconds(on_the_cpu, "srt.load_library") is None
    assert spans.library_builds(on_the_cpu) is None
    # a program without the table and the counter
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(cuda_build, "BUILDS")
    assert spans.setup_seconds(ctx, "srt.load_library") is None
    assert spans.library_builds(ctx) is None


SPAN_METRICS = {
    "idle_ms.scene_upload.path": 0.110, "idle_ms.path_tables.path": 0.0275,
    "idle_ms.readback.path": 0.070, "idle_ms.draw_rest.path": 0.015,
    "idle_ms.between_draws.path": 0.045, "idle_ms.scene_upload.culled": 0.110,
    "idle_ms.path_tables.culled": 0.0275, "idle_ms.readback.culled": 0.070,
    "idle_ms.draw_rest.culled": 0.015, "idle_ms.between_draws.culled": 0.045,
    "launches.scene_upload.path": 2.0, "host_ms.scene_upload.path": 0.135,
    "setup_s.libraries": 1.5, "setup_s.scene_geometry": 0.25, "library_builds": 2.0,
}


def test_every_span_metric_reads_through_its_file(monkeypatch):
    from software_rasterizer_tpu_torch.utils import cuda_build, profiling

    monkeypatch.setattr(profiling, "span_totals",
                        lambda: {"srt.load_library": (6, 1.5), "srt.scene_geometry": (1, 0.25)})
    monkeypatch.setattr(cuda_build, "BUILDS", {"path_camera": 1, "srt_native": 1})
    entries = {m["name"]: m for m in discover.load_benchmark()["per_layer"]}
    ctx = _ctx(_record())
    for name, want in SPAN_METRICS.items():
        assert entries[name]["source"] in ("program_span", "program_counter")
        got = discover.load_module("metrics", name).read(ctx)
        assert got == pytest.approx(want), name
    # the five parts of each cell sum to the idle time a frame
    rec = ctx.trace
    idle_ms = stats.idle_pct(rec.busy_s(), rec.window_s) / 100 * rec.window_s * 1e3 / rec.frames
    for cell in ("path", "culled"):
        assert sum(SPAN_METRICS[f"idle_ms.{p}.{cell}"] for p in PARTS) == pytest.approx(idle_ms)
