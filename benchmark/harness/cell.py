"""One run of one cell: set-up, the timed window, the traced window's
reduction, the check against the reference, and the result.

Set-up builds the scene from its configuration, hands it to the cell's
driver (which makes the pipeline, loading the program's kernel libraries
and building them on first use into the program's own `_build/`), and
draws one frame to warm every shape the window uses. The window is a
closed loop of one user: frame i is asked for when frame i - 1 has come
back as a host image, until `seconds` have passed; the frame that is out
when they pass is finished and counted. After the window the program's
state is freed and the check runs the plain reference on a sample of the
window's own frames.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np

from harness import check, discover, trace

WARM_FRAME = 0
# a traced run profiles the first TRACE_SECONDS of its window: the
# profiler's host overhead grows with the events it records (about 60 us
# an event to reduce, 1e5 host events a second of Whitted frames)
TRACE_SECONDS = 10.0


def _metric(entry: dict, ctx) -> Optional[float]:
    value = discover.load_module("metrics", entry["name"]).read(ctx)
    if value is None:
        return None
    value = float(value)
    if not math.isfinite(value):
        raise ValueError(f"{entry['name']} read {value}")
    return value


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
             t0: float, device: str = "cuda", overrides: Optional[dict] = None,
             control_dtype=None, log=print) -> dict:
    """Run the cell once and return the result line's dict (its `checks`
    key last). `t0` is the process's start on the `time.perf_counter`
    clock. `overrides` replaces top-level keys of the configuration (the
    tests' small frames on the CPU). With `control_dtype` the result also
    has "control": the check's number for the reference computed in that
    dtype put in the program's place, on the same frames and pixels
    (`benchmark/control.py`; the benchmark's own runs never compute it)."""
    import torch

    spec = discover.cell(bench, workload)
    config = dict(spec["config"], **(overrides or {}))
    traffic = spec["traffic"]
    cuda = device == "cuda"
    rng_frames, rng_sample, rng_pixels = (np.random.default_rng(s) for s in
                                          np.random.SeedSequence(seed).spawn(3))

    scene_spec = config["scenes"][traffic["scene"]]
    scene_mod = discover.load_module("scenes", scene_spec["builder"])
    scene = scene_mod.build(**scene_spec.get("args", {}))
    driver = discover.load_module("drivers", traffic["driver"]).Driver(
        config, traffic, scene, scene_mod, int(rng_frames.integers(0, 2 ** 31)), device)
    driver.frame(WARM_FRAME)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reservoir = check.Reservoir(int(traffic["check"]["frames"]), rng_sample)
    frame_ms, failed, attempted, traced_frames = [], 0, 0, 0
    tracer = trace.Tracer(traced, cuda)
    tracer.start()
    start = time.perf_counter()
    end, trace_end = start + seconds, start + min(seconds, TRACE_SECONDS)
    now = start
    while now < end:
        if tracer.running and now >= trace_end:
            tracer.stop()
            traced_frames = len(frame_ms)
        attempted += 1
        try:
            image, bad = driver.frame(attempted - 1)
        except Exception as exc:  # a frame that raises is a failed frame
            if not failed:
                log(f"frame {attempted - 1} raised {exc!r}", file=sys.stderr)
            failed += 1
            now = time.perf_counter()
            continue
        done = time.perf_counter()
        frame_ms.append((done - now) * 1e3)
        if bad or bool(np.isnan(image.max())):   # max() is NaN where any value is
            failed += 1
        reservoir.offer(attempted - 1, driver.params(attempted - 1), image)
        now = time.perf_counter()
    window_s = now - start
    if tracer.running:
        tracer.stop()
        traced_frames = len(frame_ms)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    frames = len(frame_ms)
    if frames:
        log(f"window {window_s:.4f} s, {frames} frames, median frame "
            f"{statistics.median(frame_ms):.4f} ms")
    driver.close()
    rec = trace.record(tracer.raw, traced_frames) if traced else None

    # the check, once the program's state is freed
    chk = traffic["check"]
    n_pixels = config["width"] * config["height"]
    off, compared, counts, control_off = 0, 0, {}, 0
    check_t0 = time.perf_counter()
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for _, params, image in reservoir.items:
        pixels = check.pixel_sample(rng_pixels, n_pixels, int(chk["pixels"]))
        px = torch.as_tensor(pixels, device=device)
        ref, c = driver.reference(params, px, torch.float32, device)
        prog = torch.as_tensor(image.reshape(-1, image.shape[-1])[pixels], device=device)
        off += check.off_pixels(prog, ref, chk["atol"], chk["rtol"])
        if control_dtype is not None:
            low, _ = driver.reference(params, px, control_dtype, device)
            control_off += check.off_pixels(low, ref, chk["atol"], chk["rtol"])
        compared += len(pixels)
        for k, v in c.items():
            counts[k] = counts.get(k, 0.0) + float(v) * n_pixels / len(pixels) / len(reservoir.items)
    off_share = off / compared if compared else float("nan")
    log(f"check: {len(reservoir.items)} frames x {int(chk['pixels'])} pixels in "
        f"{time.perf_counter() - check_t0:.2f} s")
    checks = {"off_px_share": {"value": off_share, "limit": float(chk["limit"])}}
    correct = bool(compared) and failed == 0 and off_share <= chk["limit"]

    ctx = SimpleNamespace(
        frames=frames, window_s=window_s, frame_ms=frame_ms, setup_s=setup_s,
        work_per_frame=driver.work_per_frame, min_bytes=getattr(driver, "min_bytes", 0),
        trace=rec, counts=counts)
    metrics = {}
    for entry in spec["per_layer" if traced else "end_to_end"]:
        value = _metric(entry, ctx) if frames else None
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": int(spec["entry"]["chips"]) if cuda else 1,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if rec is not None:
        dev["busy_s"] = rec.busy_s()
        dev["window_s"] = rec.window_s
        result["breakdown"] = rec.breakdown()
        log(f"trace: {sum(rec.kinds.values())} events {rec.kinds}")
    if control_dtype is not None:
        result["control"] = {"off_px_share": control_off / compared if compared else None}
    result["checks"] = checks
    return result
