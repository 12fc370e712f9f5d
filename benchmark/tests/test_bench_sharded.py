"""The four-card cell's pieces on the CPU: its metric readers on hand-made
traced windows (NCCL kernels by name, the all-reduce's roofline at the
stated link rate, the program's byte counter, None without device events
or without the program's counter), and its driver over gloo at a tiny
size (a frame equal to `path_draw`'s at all the frame's samples, a
killed worker making `frame()` raise within its deadline, `close()`
leaving no process, a program without the sharded pipeline or traffic
off the configuration's node refused before a process starts)."""

import multiprocessing as mp
import time
from types import SimpleNamespace

import numpy as np
import pytest

from harness import cell, discover, trace

CELL = "cornell_box.path16_sharded4"
BENCH = discover.load_benchmark()
SEED = 2 ** 31 + 4099
NEW = ("collective_ms.sharded4", "allreduce_roofline.sharded4",
       "collective_bytes.sharded4", "device_idle_pct.sharded4")
FRAME_BYTES = 1024 * 1024 * 3 * 4
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


def metric(name):
    return discover.load_module("metrics", name).read


def _record(device, frames=2):
    host = [(trace.WINDOW_SPAN, 0.0, 1000.0), ("srt.draw", 10.0, 400.0),
            ("srt.all_reduce", 300.0, 305.0), ("srt.draw", 500.0, 900.0)]
    return trace.TraceRecord(device, host, 0.0, 1000.0, frames)


def _ctx(rec, min_bytes=FRAME_BYTES):
    return SimpleNamespace(trace=rec, min_bytes=min_bytes, frames=2, counts={})


CARD = [("void (anonymous namespace)::path_camera_kernel<false>(Params)", 20.0, 300.0, "kernel"),
        (NCCL, 300.0, 341.94304, "kernel"),
        # c10d's annotation over the collective, a "kernel" where the
        # profiler's events carry no activity type: not counted
        ("nccl:all_reduce", 299.0, 342.0, "kernel"),
        ("Memcpy DtoH (Device -> Pageable)", 345.0, 390.0, "gpu_memcpy"),
        ("void (anonymous namespace)::path_camera_kernel<false>(Params)", 510.0, 800.0, "kernel"),
        (NCCL, 800.0, 841.94304, "kernel")]


def test_collective_ms_reads_the_nccl_kernels_by_name():
    got = metric("collective_ms.sharded4")(_ctx(_record(CARD)))
    assert got == pytest.approx(2 * 41.94304 / 1e3 / 2)


def test_allreduce_roofline_at_the_link_rate():
    mod = discover.load_module("metrics", "allreduce_roofline.sharded4")
    assert mod.LINK_BYTES_PER_S == 450e9 and mod.RANKS == 4
    # 3/4 of 12,582,912 B at 450 GB/s
    assert mod.least_ms(FRAME_BYTES) == pytest.approx(9437184 / 450e9 * 1e3)
    assert mod.least_ms(FRAME_BYTES) == pytest.approx(0.02097152)
    # an NCCL kernel of twice the least time a frame reads 50%
    assert mod.read(_ctx(_record(CARD))) == pytest.approx(50.0)
    assert mod.read(_ctx(_record(CARD), min_bytes=0)) is None


def test_device_idle_share_of_card_zero():
    rec = _record(CARD)
    assert metric("device_idle_pct.sharded4")(_ctx(rec)) == pytest.approx(
        100.0 * (1.0 - rec.busy_s() / rec.window_s))


def test_collective_bytes_from_the_program_counter(monkeypatch):
    from software_rasterizer_tpu_torch.utils import profiling

    read = metric("collective_bytes.sharded4")
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "srt.draw": (5, 0.1), "srt.all_reduce": (5, 0.01)})
    monkeypatch.setattr(profiling, "span_bytes", lambda: {"srt.all_reduce": 5 * FRAME_BYTES})
    assert read(_ctx(_record(CARD))) == FRAME_BYTES
    monkeypatch.setattr(profiling, "span_bytes", lambda: {
        "srt.all_reduce": 5 * FRAME_BYTES, "srt.gather": 5 * 64})
    assert read(_ctx(_record(CARD))) == FRAME_BYTES + 64
    # a program that ran no collective, or keeps no byte counter
    monkeypatch.setattr(profiling, "span_bytes", lambda: {})
    assert read(_ctx(_record(CARD))) is None
    monkeypatch.delattr(profiling, "span_bytes")
    assert read(_ctx(_record(CARD))) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name):
    read = metric(name)
    assert read(_ctx(None)) is None
    assert read(_ctx(_record([]))) is None              # no device events: the CPU


@pytest.mark.parametrize("name", NEW[:2])
def test_no_nccl_kernel_gives_none(name):
    # device events, but no NCCL kernel: the collective ran over gloo
    assert metric(name)(_ctx(_record([d for d in CARD if d[0] != NCCL]))) is None
    assert metric(name)(_ctx(_record([("gloo:all_reduce", 300.0, 350.0, "kernel")]))) is None


# ------------------------------------------------------------ the driver

def _small():
    cfg = discover.cell(BENCH, CELL)["config"]
    return dict(cfg, width=16, height=16, path=dict(cfg["path"], spp=2))


def _driver(name, config, traffic=None, module=None):
    spec = discover.cell(BENCH, CELL)
    traffic = traffic or spec["traffic"]
    scene_spec = config["scenes"][traffic["scene"]]
    scene_mod = discover.load_module("scenes", scene_spec["builder"])
    module = module or discover.load_module("drivers", name)
    return module.Driver(config, traffic, scene_mod.build(**scene_spec.get("args", {})),
                         scene_mod, SEED, "cpu")


@pytest.fixture
def sharded():
    d = _driver("sharded_path_draw", _small())
    procs = list(d.workers.procs)
    yield d
    d.close()
    assert procs and all(not p.is_alive() for p in procs)


def test_frame_is_path_draw_at_all_the_frames_samples(sharded):
    """Four ranks of 2 samples each: `path_draw`'s frame at 8 samples
    under the same seed, up to the order of the sum."""
    config = _small()
    single = _driver("path_draw", dict(config, path=dict(config["path"], spp=8)))
    assert sharded.spp == 8 and sharded.work_per_frame == 16 * 16 * 8
    assert sharded.min_bytes == 16 * 16 * 3 * 4
    for i in (0, 1):
        got, bad = sharded.frame(i)
        want, _ = single.frame(i)
        assert not bad and got.shape == (16, 16, 3) and got.max() > 0
        assert sharded.params(i) == single.params(i)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    single.close()


def test_a_killed_worker_makes_frame_raise(sharded):
    sharded.frame(0)
    victim = sharded.workers.procs[1]
    victim.kill()
    victim.join(10)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 exited"):
        sharded.frame(1)
    assert time.monotonic() - t0 < sharded.deadline_s


def test_a_worker_lost_mid_frame_makes_frame_raise():
    """A worker killed after it took the frame's seed, before it joins
    the all-reduce: rank 0's collective or its wait raises within the
    collective timeout."""
    spec = discover.cell(BENCH, CELL)
    d = _driver("sharded_path_draw", _small(),
                dict(spec["traffic"], collective_timeout_s=5))
    try:
        d.frame(0)
        send = d.workers.send

        def send_then_die(msg):
            send(msg)
            d.workers.procs[0].kill()
        d.workers.send = send_then_die
        t0 = time.monotonic()
        with pytest.raises(Exception):
            d.frame(1)
        assert time.monotonic() - t0 < d.deadline_s + 10
    finally:
        d.close()
    assert not mp.active_children()


def test_close_leaves_no_process():
    d = _driver("sharded_path_draw", _small())
    procs = list(d.workers.procs)
    assert len(procs) == 3 and all(p.is_alive() for p in procs)
    d.frame(0)
    d.close()
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    assert not mp.active_children()


def test_a_program_without_the_sharded_pipeline_is_refused_at_once(monkeypatch):
    mod = discover.load_module("drivers", "sharded_path_draw")

    class OldPathTracing:
        def __init__(self, width, height, spp=16, max_bounces=16, block=1 << 16,
                     chunk=512, seed=0, device="cuda"):
            pass

    monkeypatch.setattr(mod, "PathTracing", OldPathTracing)
    with pytest.raises(RuntimeError, match="takes no mesh="):
        _driver("sharded_path_draw", _small(), module=mod)
    assert not mp.active_children()


@pytest.mark.parametrize("change", [{"ranks": 2}, {"mesh": {"spp": 2, "tile": 2}},
                                    {"backend": "gloo"}])
def test_traffic_off_the_configurations_node_is_refused_at_once(change):
    spec = discover.cell(BENCH, CELL)
    assert spec["config"]["node"] == {"cards": spec["traffic"]["ranks"],
                                      "mesh": spec["traffic"]["mesh"],
                                      "backend": spec["traffic"]["backend"]}
    with pytest.raises(ValueError, match="configuration's node"):
        _driver("sharded_path_draw", _small(), dict(spec["traffic"], **change))
    assert not mp.active_children()


def test_traced_run_on_the_cpu_reads_none_of_the_new_metrics():
    cfg = _small()
    r = cell.run_cell(BENCH, CELL, SEED, 0.3, True, time.perf_counter(), device="cpu",
                      overrides={k: cfg[k] for k in ("width", "height", "path")},
                      log=lambda *a, **k: None)
    assert r["correct"], r["checks"]
    assert not set(NEW) & set(r["metrics"])
