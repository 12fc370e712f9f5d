"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three pipelines and its explicit-ray layer at full
width (1024x1024) through their hand-written CUDA kernels, and holds each
kernel against its plain PyTorch version: Cornell-box path tracing at 16
spp, Whitted ray tracing at max_depth 5, the rasterizer on a lit,
tessellated Cornell box of 9,216 triangles, the wavefront path
integrator on the frame's 1,048,576 camera rays as explicit tensors, the
nearest hits of those rays on the box tessellated to 9,216 and to
147,456 triangles through the chunked trace tiers, and path tracing and
Whitted of those two large scenes through the kernels' chunk-culled walk.
Phases, one line each; any failure exits non-zero:

  1. device: CUDA present, card name and power limit, the six CUDA
     libraries built at once (one nvcc each);
  2. path: kernel vs plain on three 4096-lane windows of the full frame;
  3. path golden: 48x48 at 8 spp against tests/goldens path_mean;
  4. path main path: pipeline_from_config -> PathTracing.draw() -> save(),
     accumulate 8 + 8 == draw, and the kernel launch count;
  5. path times of the kernel and the plain version (CUDA events, median
     and range of 10), the bound, the loop's SIMT efficiency from the
     kernel's own tally against the static schedule's model on the plain
     version's per-lane iteration counts, and the issue floor from the
     SASS of the kernel's triangle loop (utils/sass.py);
  6. Whitted: kernel vs plain on Cornell, Cornell with a mirror and a
     glass sphere, and Cornell with a textured back wall;
  7. Whitted golden: 64x64 at max_depth 4 against tests/goldens whitted;
  8. Whitted main path: pipeline_from_config -> RayTracing.draw() ->
     save(), one kernel launch, the frame and stats of phase 6;
  9. Whitted times of the kernel and the plain version (CUDA events),
     the sweep's SIMT efficiency on Cornell from the kernel's (2, 3)
     tally (main and shadow rays apart) and the issue floor from the SASS
     of its row loop (utils/sass.py);
 10. raster: the fused tile kernel vs plain on the whole frame (winners,
     depth, attribute planes, ids), also at a list capacity of 16 that
     overflows (bin_dropped equal and non-zero); the kernels' own lists
     (the tile launch's and bin_triangles_device's) against plain
     bin_triangles entry for entry at both capacities;
 11. raster: the shaded tile kernel vs plain on the whole frame, the same
     two capacities and lists, and the shaded image against the deferred
     one;
 12. raster golden: Cornell 96x96 against tests/goldens raster / raster_z;
 13. raster main path: pipeline_from_config(cfg, "raster") on the default
     device -> TraditionalRasterizer.draw() -> save(), deferred and
     shaded, and draw_batch() of 8 turned frames; launch counts,
     bin_triangles calls on the card's tensors (none), bin_dropped,
     coverage; then the batch against 8 draw()s, and the
     JAX default raster_tile (128, 128) and (64, 32), rendered in the
     default kernel tile, against the (16, 32) frame bit for bit;
 14. raster times (CUDA events, median and range): the frame, each
     kernel's wrapper, bare launch and device-only time (a CUDA graph of
     20 launches), the kernels' binning alone, the stages around them,
     draw_batch per frame, and the plain versions; the bounds, the issue
     floor of the walk loop (utils/sass.py) and the binning's box tests;
     `raster_ab` against a parent tree unpacked under _checkout/parent,
     if there is one (else this tree alone); and the lit Cornell box at
     147,456 triangles: device lists == bin_triangles, frames == plain,
     times and bin_dropped;
 15. trace: the nearest-triangle kernel vs plain on all camera rays and
     on as many bounce rays from their hit points (winners and t
     identical), and `nearest_hit` over the kernel against `nearest_hit`
     over the plain version, field by field; its tally (warp-steps, voted
     steps, tests, full tests, stage-1 passes) against its plain model;
 16. bounce: the fused bounce kernel vs plain on the whole frame's state
     at 1 bounce and at 16 (acc, live and state lane for lane), and the
     model of its bounce-major schedule (bounce_major_plain) vs plain;
 17. wavefront main path: camera rays -> path_render_accumulate on the
     default device, 16 samples (16 + 16 launches), against the camera
     kernel's frame of phase 4 and the golden; PathTracing.draw() of
     Cornell with a textured light through pipeline_from_config, and at
     one bounce every pixel on the light a texel exactly; the
     plain wavefront (fused=False) on a quarter frame, nothing dropped;
 18. wavefront times (CUDA events, median and range): both kernels bare
     and wrapped, the trace kernel's device-only time (a CUDA graph of 20
     launches), nearest_hit and path_trace whole, the host's share,
     Mpaths/s beside the camera kernel's, the plain versions, the bounds
     (the trace kernel's from its tally) and the trace kernel's issue
     floor from the SASS of its row loop;
     the bounce kernel's loop efficiency (tally against the models of the
     per-lane loop and of the bounce-major schedule), its issue floor and
     its device clock bounce by bounce;
 19. Whitted with two emitters: kernel vs plain on the whole frame at
     spp 1 and 4, RayTracing.draw() through pipeline_from_config, two draws
     differ, times beside the one-emitter frame;
 20. large scenes: the tessellated Cornell boxes and their chunk tables
     on the card, camera rays and bounce rays from their hit points;
 21. the cull prepass kernel (#5) vs plain: the whole (ray block, chunk)
     mask on both scenes and both ray sets, the share that survives, and
     its tally (slab tests on super and chunk boxes, (warp, super) pairs,
     those skipped and those taken child by child, chunk votes) against its
     plain model; the streamed kernel (#6) on those masks' lists, its tally
     (warp-steps, voted steps, tests, full tests, slab tests, (warp, listed
     chunk) pairs and those skipped) against its plain model, s and w;
 22. the fused-cull, listed and streamed kernels: (hit, idx, t) bit for
     bit against the unculled trace kernel over the whole table and
     against their own plain versions, at every ray-block size (a ray that
     differs must be a proven knife edge of the slab test, and is printed);
     the fused cull's (#4) tally over the whole frame, and tally and (hit,
     idx, t) against its plain model on three windows of rays; the listed
     kernel's (#7) tally and (hit, idx, t) against its plain model;
 23. large-scene main path: nearest_hit, nearest_emit_hit and classify_hit
     with no backend named take the fused-cull kernel at 9,216 triangles
     and the prepass + streamed kernel at 147,456 (launch counts), every
     field equal to backend="vpu"; backend="mm2" takes the listed kernel;
 24. large-scene times (CUDA events, median and range): each kernel bare
     and wrapped (#4 and #5 bare on bounce rays too; #7 device-only), the
     list build, the unculled kernel on the same rays, nearest_hit whole,
     the ray-block sizes, and the bounds from this run's own masks, for
     #4, #5, #6 and #7 also from their tallies, with their issue floors
     from the SASS of their row loops and of #5's box loop (utils/sass.py);
 25. the unculled chunked sweep (kernel #8): (hit, idx, t) bit for bit
     against kernel #2 and its plain version on 1M camera and 1M bounce
     rays at 36, 9,216 and 147,456 triangles and three ray-block sizes,
     its tally against its plain model and s; nearest_hit(backend="mm")
     by launch count, every field equal to backend="vpu"; times, the
     bound, the bound from the tally, the issue floor;
 26. large-scene path tracing, the camera kernel: the culled walk (the
     warp walk: each (ray, chunk) pair tested by the whole warp) against
     the full sweep lane for lane at 1 spp (the whole frame at 9,216
     triangles, 65,536 lanes at 147,456), both against their plain
     versions on 4,096 lanes, the walk's tally of row tests, slab tests and
     row-test slots against the plain version's counts and the warp walk's
     model; the walk's SIMT efficiency (row tests / slots) beside the
     per-thread walk's (the model's count of that schedule); the 16-spp
     frame's times and its bound from the tally, beside an earlier
     reading;
 27. the same for the bounce kernel (16 bounces; the full sweep is the
     bounce-major launch), and path_trace's routes
     (fused=None: the culled bounce kernel; fused=False: the plain
     wavefront over the trace tiers) and the camera kernel against one
     wavefront sample of the frame, by time;
 28. the same for the Whitted kernel (dropped_rays 0; the warp walk
     under a warp-uniform DFS step), its tally against the plain version's
     counts, main and shadow rays apart, the walk's SIMT efficiency beside
     the models of both walks and the per-ray walk's earlier reading, the
     issue floor of the walk's row loop, and the kernel against its plain
     version on Cornell with mirror walls at max_depth 12 and 32 (the 16-
     and 32-entry stacks);
 29. the large-scene main path: pipeline_from_config -> PathTracing.draw()
     and RayTracing.draw() on both scenes at 1024x1024 through the culled
     kernels (launch counts), frames equal to phases 26 and 28, times,
     Mpaths/s beside the full sweep's, bounds;
 30. sharding on one card: 4 ranks spawned (torch.multiprocessing,
     "spawn") share the card in one process group (parallel.initialize's
     rule takes gloo), each rendering its slice through the port's
     sharded renders (parallel/): path on (1, 4) and (2, 2) meshes (#1)
     and on the 9,216-triangle box (#1b), Whitted on Cornell, two
     emitters at spp 1 and 4 (#9) and the large box (#9b), raster rows
     deferred (#10) and shaded (#11); every frame (and z-buffer, stats)
     bit for bit against the single-rank render (the (2, 2) path
     against its two partial sums), one launch a rank and call, each
     rank's kernel call, the sharded call and its collectives alone
     (CUDA events) beside the single-rank call; and NCCL's answer to two
     ranks on one card.
 31. the host layer and the entry point: on phase 20's scenes, the
     native (utils/native.py, C++) and Python build_bvh, host seconds, node
     and leaf order and boxes equal; debug_mode around Cornell
     PathTracing.draw(), RayTracing.draw() and TraditionalRasterizer.draw()
     on the card (silent), and around a path draw with a NaN kd
     (FloatingPointError from the camera kernel's wrapper);
     utils/profiling.trace around a path draw, whose summary lists
     path_camera_kernel; examples/cornell_pt at 256x256, 16 spp on the card:
     single shot, --batch 4 with a checkpoint, --tiles 4, each a PNG with a
     finite, nonzero mean.

The last lines are a JSON line of per-kernel results (time beside the
card's bound for the same work; the Whitted kernel's `launches` is phase
8's main path and `launches_two_emitters` phase 19's, its culled instance
under "culled"; the camera, bounce and Whitted kernels, full sweep and
culled, with their SIMT efficiency and, but for the culled path kernels,
their issue floor), the card's `nvidia-smi` name and power limit, and
`{"ok": true, "device": ...}`. Images go to chiprun_out/ under the
repository root.

`whitted_ab` and `trace_ab` (not run by `main`) time the Whitted kernel,
and the trace kernels #2, #4, #5, #6, #7 and #8, built from other sources
against each other in turns, e.g. this tree's against an earlier commit's;
`raster_ab` (run by phase 14) does the same for the raster kernels #10
and #11 with their binning.
"""

from __future__ import annotations

import functools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

WIDTH = HEIGHT = 1024
SPP = 16
MAX_BOUNCES = 16
SEED = 0
WINDOW = 4096
# kernel vs plain: both round every multiply and add on their own, so
# lanes differ only where a transcendental's last bit flips a knife edge
LANE_RTOL, LANE_ATOL, LANE_SHARE = 1e-3, 1e-4, 0.999
MEAN_RTOL = 1e-3
# accumulate 8 + 8 vs one 16-sample draw: float32 summation order only
ACC_RTOL, ACC_ATOL = 2e-5, 1e-5
GOLDEN_TOL = 0.03  # tests/test_goldens.py path_mean tolerance
PLAIN_FULL_LIMIT_S = 60.0
WHITTED_DEPTH = 5
# Whitted kernel vs plain: the same per-operation rounding, so pixels
# differ only where a transcendental's last bit flips a knife edge
PIX_RTOL, PIX_ATOL, PIX_SHARE = 1e-3, 1e-4, 0.999
RAYS_RTOL = 1e-3
# tests/test_goldens.py whitted rule
WG_TOL, WG_SHARE = 5e-3, 0.995
# raster: tessellation of each Cornell mesh (4: 36 x 256 = 9,216 triangles)
RASTER_LEVELS = 4
# the large raster scene of phase 14 (36 x 4^6 = 147,456 triangles)
RASTER_LARGE_LEVELS = 6
# the forced overflow of phases 10 and 11: a list capacity under the
# longest list
RASTER_SMALL_CAP = 16
RASTER_BATCH = 8
RASTER_COVERAGE_MIN = 0.40
# raster kernels vs plain: the same per-operation rounding, so the target
# is 0 differing pixels; winners may differ on at most 0.1% of the pixels
# and planes are held to rtol = atol = 1e-5 where the winners agree (only
# expf / logf in the shaded kernel could differ in a last bit)
RASTER_RTOL, RASTER_ATOL, RASTER_SHARE = 1e-5, 1e-5, 0.999
# tests/test_goldens.py raster rule
RG_COVER, RG_TOL = 0.01, 1e-3
# wavefront against the camera kernel: another random stream under the
# same estimator, 16 samples of a million lanes
WAVE_MEAN_RTOL = 0.02
# the plain wavefront's lanes on the card (a quarter frame)
PLAIN_WAVE_LANES = 1 << 18
WHITTED_EMITTER_SPP = 4
# large scenes: tessellation of each Cornell mesh (36 x 4^levels triangles:
# 9,216 for the fused-cull tier, 147,456 for the streamed tier), and the
# ray-block sizes held against each other (up to 256 threads of 1, 2, 4 or 8
# rays)
LARGE_LEVELS = (4, 6)
BLOCK_SIZES = (32, 64, 128, 512, 1024, 2048)
# a tier's plain version runs the whole frame up to this many (ray,
# triangle) tests, else windows of LARGE_WINDOW rays
PLAIN_TESTS_LIMIT = 3e10
LARGE_WINDOW = 1 << 16
# large-scene path tracing: the lanes of a kernel against plain comparison,
# kernel #8's ray blocks, and a Whitted depth beyond the old 8-entry stack
PLAIN_PATH_LANES = 4096
MM_BLOCKS = (256, 512, 1024, 2048)
DEEP_DEPTH = 12
# the card's published peaks (H100 SXM data sheet): float32 outside the
# tensor cores, and device memory
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# warp schedulers of an SM (Hopper), each issuing one instruction a cycle
SCHEDULERS_PER_SM = 4
# repeats of a timed kernel in phases 5 and 18
TIME_REPS = 10
# phase 30: ranks sharing the one card, the large scene's spp, repeats of
# each timed call, and the ranks of the NCCL probe
SHARD_RANKS = 4
SHARD_LARGE_SPP = 4
SHARD_REPS = 5
NCCL_PROBE_RANKS = 2
# phase 31: the entry point's frame side (the JAX example's default)
CORNELL_PT_SIZE = 256
# earlier readings of the culled path kernels on an NVIDIA H100 80GB HBM3 at
# 700 W (the kernel table of PERF.md, section 6), printed beside this run's:
# the 16-spp frame of the camera kernel and 16 bounces of the frame's primary
# hits, ms at 9,216 / 147,456 triangles
EARLIER_CULLED_MS = {"camera": {"mid": 191.745, "large": 486.851},
                     "bounce": {"mid": 13.388, "large": 30.862}}
# the SIMT efficiency (row tests / row-test slots) of the Whitted kernel's
# per-ray walk before its step was made warp-uniform, main and shadow rays
# over the whole max_depth-5 frame at 9,216 / 147,456 triangles, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6)
EARLIER_WHITTED_SIMT = {"mid": (0.8781, 0.8936), "large": (0.7371, 0.7946)}


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_times(fn, repeats: int = 3) -> list:
    """Wall times of fn() on the device in ms (CUDA events), sorted,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def cuda_ms(fn, repeats: int = 3) -> float:
    """Median of `cuda_times`."""
    return statistics.median(cuda_times(fn, repeats))


def spread(times: list) -> str:
    """'median [min-max]' of a sorted list of ms."""
    return f"{statistics.median(times):.3f} [{times[0]:.3f}-{times[-1]:.3f}]"


def bound(n_bytes: float, n_ops: float):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the float32 operations over the peak rate,
    and which of the two it is."""
    t_bytes = n_bytes / HBM_RATE * 1e3
    t_ops = n_ops / FP32_PEAK * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def wall_ms(fn):
    """fn() once: (its result, wall ms with the device drained)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def tests_bound_ms(table_bytes, tally):
    """Bound from a culled kernel's tally of (ray, row) tests and slab
    tests: ~58 float32 operations a row test, ~21 a slab test."""
    rows, slabs = (int(x) for x in tally[:2].tolist())
    return bound(table_bytes, 58.0 * rows + 21.0 * slabs), rows, slabs


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return float(proc.stdout.strip().splitlines()[0]) * 1e6


def issue_floor(library: str, kernel: str, n_rows: int, lane_iterations: int,
                rays: int = 2):
    """The issue floor of a kernel's row loop: the SASS instructions of its
    triangle loop a row (utils/sass.py; one row against `rays` rays: two
    in the path kernels' full sweeps, one in the Whitted kernel) x rows x
    the lane-iterations that sweep them, over every scheduler of the card
    issuing one warp-instruction (32 lanes) each cycle at the highest SM
    clock. Returns (ms, the loop's count from utils/sass.py)."""
    import torch

    from software_rasterizer_tpu_torch.utils import sass
    from software_rasterizer_tpu_torch.utils.cuda_build import library_path

    loop = sass.row_loop(sass.kernel_sass(library_path(library), kernel), rays)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SCHEDULERS_PER_SM * 32 * max_sm_clock_hz()
    return loop["per_row"] * n_rows * lane_iterations / rate * 1e3, loop


def loop_line(name: str, tally, want_active: int, model: dict) -> tuple:
    """The loop of a full-sweep kernel from its (5,) tally: (its SIMT
    efficiency, a line with the active lane-iterations against the plain
    version's, and the efficiency beside the models' of each schedule
    computed from the plain version's per-lane counts)."""
    active, slots = (int(x) for x in tally[3:5].tolist())
    eff = active / slots
    models = ", ".join(f"{k} {want_active / v:.4f} ({v} slots)" for k, v in model.items())
    return eff, (f"{name} loop: {active} active lane-iterations (plain {want_active}), "
                 f"{slots} lane-slots issued, SIMT efficiency {eff:.4f} (tally) against "
                 f"the model of {models}")


def build_kernels() -> float:
    """Build the six CUDA libraries at once (one nvcc each); returns the
    seconds it took."""
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import raster_kernel as rk
    from software_rasterizer_tpu_torch.ops import trace_kernel as tk
    from software_rasterizer_tpu_torch.ops import trace_tiers as tt
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk

    t0 = time.perf_counter()
    errors = []

    def build(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, after every build ends
            errors.append(e)

    threads = [threading.Thread(target=build, args=(fn,)) for fn in (
        pk.build_kernel, pk.build_bounce_kernel, tk.build_kernel,
        tt.build_kernel, wk.build_kernel, rk.build_kernel)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.ops.path import path_render
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils.cuda_build import BUILD_LOGS
    from software_rasterizer_tpu_torch.utils.rng import sample_seeds

    OUT_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 1. device + build (one nvcc per library, started together)
    build_s = build_kernels()
    ptxas = []
    for name in ("path_camera", "path_bounce", "trace_nearest", "trace_culled",
                 "whitted_uber", "raster_tiles"):
        log = BUILD_LOGS.get(name, "")
        (OUT_DIR / f"{name}_build.log").write_text(log)
        ptxas += [f"{name}: {ln.strip()}" for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
    phase(1, f"device {kind} x{torch.cuda.device_count()} | {card} | "
             f"torch {torch.__version__} cuda {torch.version.cuda} | "
             f"build {build_s:.1f}s | ptxas: {' / '.join(ptxas) or 'cached'}")

    # ---- 2. kernel vs plain at full width
    scene = build_cornell_scene()
    scene.set_ndc_matrix(WIDTH, HEIGHT)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
    args = (rt, SEED, WIDTH, HEIGHT, scene.fovy, SPP)
    kw = dict(p_rr=scene.rr, max_bounces=MAX_BOUNCES)
    n = WIDTH * HEIGHT
    full = pk.path_camera_render(*args, **kw)
    torch.cuda.synchronize()
    if full.shape != (3, n) or not bool(torch.isfinite(full).all()):
        fail(f"kernel frame has shape {tuple(full.shape)} or non-finite values")
    # the box fills the middle of the frame; the frame's own top and
    # bottom rows see only the black background, so the top and bottom
    # windows are the first and last rows of the lit region
    lit = torch.nonzero((full != 0).any(dim=0)).flatten()
    if lit.numel() == 0:
        fail("the kernel frame is black")
    first = int(lit[0]) // WIDTH * WIDTH
    last = min((int(lit[-1]) // WIDTH + 1) * WIDTH, n)
    windows = {"top": first, "centre": n // 2 - WINDOW // 2,
               "bottom": max(last - WINDOW, 0)}
    max_err = 0.0
    lines = []
    for name, off in windows.items():
        plain = pk.path_camera_render_plain(
            *args, lane_offset=off, n_lanes=WINDOW, **kw)
        kern = full[:, off:off + WINDOW]
        diff = (kern - plain).abs()
        max_err = max(max_err, float(diff.max()))
        lane_ok = (diff <= LANE_ATOL + LANE_RTOL * plain.abs()).all(dim=0)
        n_bad = int((~lane_ok).sum())
        km, pm = float(kern.mean()), float(plain.mean())
        mean_rel = abs(km - pm) / max(abs(pm), 1e-30)
        lines.append(f"{name}@{off}: {n_bad}/{WINDOW} lanes differ, "
                     f"mean {km:.6g} vs {pm:.6g} (rel {mean_rel:.2e})")
        if n_bad > (1.0 - LANE_SHARE) * WINDOW or mean_rel > MEAN_RTOL:
            fail(f"kernel disagrees with plain: {lines[-1]}")
    phase(2, f"kernel vs plain {WIDTH}x{HEIGHT} {SPP} spp: " + "; ".join(lines)
             + f"; max_abs_err {max_err:.3g}")

    # ---- 3. golden
    gscene = build_cornell_scene()
    gscene.set_ndc_matrix(48, 48)
    grt = prepare_rt_scene(gscene.rt_geometry(), gscene.rt_frame(), dev)
    gimg = path_render(grt, 48, 48, gscene.fovy, SEED, spp=8)
    gmean = float(torch.clamp(gimg, 0, 1).mean())
    want = float(np.load(ROOT / "tests" / "goldens" / "cornell_goldens.npz")["path_mean"])
    if not abs(gmean - want) < GOLDEN_TOL:
        fail(f"golden mean {gmean} vs path_mean {want}")
    phase(3, f"golden 48x48 8 spp: clipped mean {gmean:.5f} vs {want:.5f} "
             f"(|diff| {abs(gmean - want):.5f} < {GOLDEN_TOL})")

    # ---- 4. main path through the normal entry point
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                       max_bounces=MAX_BOUNCES, seed=SEED)
    render = pipeline_from_config(cfg, "path", device="cuda")
    cornell = build_cornell_scene()
    render.add_scene(cornell)
    pk.LAUNCHES = 0
    render.draw()
    png = OUT_DIR / "chip_smoke_cornell.png"
    render.save(str(png))
    drawn = render.frame.copy()
    render.accumulate(cornell.name, SPP // 2)
    render.accumulate(cornell.name, SPP - SPP // 2)
    resolved = render.resolve(cornell.name)
    torch.cuda.synchronize()
    launches = pk.LAUNCHES
    if launches != 3:
        fail(f"expected 3 kernel launches on the main path, counted {launches}")
    if drawn.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(drawn).all():
        fail("draw() frame has the wrong shape or non-finite values")
    if not np.allclose(resolved, drawn, rtol=ACC_RTOL, atol=ACC_ATOL):
        fail(f"accumulate in two batches != draw: max |diff| "
             f"{np.abs(resolved - drawn).max()}")
    ref = (full.T / float(SPP)).reshape(HEIGHT, WIDTH, 3).cpu().numpy()
    same = np.isclose(drawn, ref, rtol=LANE_RTOL, atol=LANE_ATOL).all(-1)
    if same.mean() < LANE_SHARE:
        fail(f"draw() differs from the phase-2 kernel frame on "
             f"{int((~same).sum())} pixels")
    phase(4, f"pipeline_from_config -> draw -> {png.name}: mean "
             f"{drawn.mean():.5f}, launches {launches}, accumulate {SPP // 2}+{SPP - SPP // 2} max "
             f"|diff| {np.abs(resolved - drawn).max():.3g}, "
             f"{int((~same).sum())} pixels differ from phase 2")

    # ---- 5. times
    t_k = cuda_times(lambda: pk.path_camera_render(*args, **kw), TIME_REPS)
    k_ms = statistics.median(t_k)
    t0 = time.perf_counter()
    work = {}
    pk.path_camera_render_plain(*args, stats=work, **kw)
    torch.cuda.synchronize()
    plain_once = time.perf_counter() - t0
    if plain_once <= PLAIN_FULL_LIMIT_S:
        p_ms = cuda_ms(lambda: pk.path_camera_render_plain(*args, **kw))
        how = "full frame, median of 3 after warm-up"
    else:
        off = windows["centre"]
        w_ms = cuda_ms(lambda: pk.path_camera_render_plain(
            *args, lane_offset=off, n_lanes=WINDOW, **kw))
        p_ms = w_ms * n / WINDOW
        how = (f"one full frame took {plain_once:.1f}s; timed one "
               f"{WINDOW}-lane window ({w_ms:.1f} ms) and scaled by "
               f"{n // WINDOW}")
    paths = n * SPP
    # the launch alone, with the operand tables packed beforehand
    attr_t, sph_t, n_sph = pk.pack_scene_tables(rt)
    operands = (rt.tri_table.float().contiguous(), attr_t, sph_t,
                rt.emitter_cr.float().contiguous(),
                torch.as_tensor(sample_seeds(SEED, 0, SPP)).to(dev),
                pk._camera_table(rt, scene.fovy, WIDTH, HEIGHT))
    launch_kw = dict(n_tri=rt.n_tri, n_sph=n_sph, n_emitters=rt.n_emitters,
                     lane_offset=0, n_lanes=n, width=WIDTH, height=HEIGHT, **kw)
    t_bare = cuda_times(lambda: pk.launch_path_camera(*operands, **launch_kw), TIME_REPS)
    bare_ms = statistics.median(t_bare)
    phase(5, f"kernel {spread(t_k)} ms ({paths / k_ms / 1e3:.2f} Mpaths/s; bare "
             f"launch {spread(t_bare)} ms; median [min-max] of {TIME_REPS}), "
             f"plain {p_ms:.1f} ms ({paths / p_ms / 1e3:.3f} Mpaths/s; {how}) "
             f"at {WIDTH}x{HEIGHT} {SPP} spp on {card}")

    # the kernel's bound: each lane-iteration intersects two rays with
    # every primitive (~80 float32 operations a triangle, ~40 a sphere)
    # and spends ~300 on sampling and shading; the tables and the (3,N)
    # sum are the only bytes
    path_bound, path_by = bound(
        tensor_bytes(rt.tri_table, attr_t, sph_t, rt.emitter_cr, full) + 4 * SPP + 32,
        work["lane_iterations"] * (80 * rt.n_tri + 40 * n_sph + 300))
    # the loop from the kernel's own tally, against the static schedule's
    # model on the plain version's per-lane iteration counts
    tally = torch.zeros(len(pk.TALLY_ENTRIES), dtype=torch.int64, device=dev)
    pk.launch_path_camera(*operands, tally=tally, **launch_kw)
    torch.cuda.synchronize()
    cam_simt, cam_loop = loop_line(
        "camera", tally, work["lane_iterations"],
        {"static schedule": pk.loop_slots(work["per_lane"])[0]})
    cam_floor, cam_sass = issue_floor("path_camera", "path_camera_kernelILb0E", rt.n_tri,
                                      int(tally[3]))
    print(f"[phase 5] bound {path_bound:.4f} ms by {path_by} "
          f"({work['lane_iterations']} lane-iterations of this frame); {cam_loop}; "
          f"issue floor {cam_floor:.4f} ms ({cam_sass['per_row']:g} SASS instructions a "
          f"row and two rays, {cam_sass['unroll']} rows a loop iteration: "
          + ", ".join(f"{o} {c:g}" for o, c in cam_sass["mix"].items())
          + f"; x {rt.n_tri} rows x the tally's active lane-iterations); "
          f"bare launch {bare_ms / path_bound:.2f}x the bound, "
          f"{bare_ms / cam_floor:.2f}x the issue floor", flush=True)

    whitted = whitted_phases(dev, card)
    raster = raster_phases(dev, card)
    cam_mean = float(torch.clamp(full.T / float(SPP), 0, 1).mean())
    wavefront = wavefront_phases(dev, card, cam_mean, paths / k_ms / 1e3)
    picks = whitted_emitter_phases(dev, card)
    tiers, large = large_scene_phases(dev, card)
    culled = culled_phases(dev, card, large)
    whitted["launches_two_emitters"] = picks["launches"]
    whitted["max_abs_err"] = max(whitted["max_abs_err"], picks["max_abs_err"])
    whitted["culled"] = culled["whitted"]
    sharding_phase(dev, card)
    host_layer_phase(dev, card, large)

    print(json.dumps({"kernels": [{
        "name": "path_camera",
        "route": "cuda",
        "source": "software_rasterizer_tpu_torch/csrc/path_camera.cu",
        "replaces": "software_rasterizer_tpu/ops/pallas_path.py:940",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "bare_ms": bare_ms,
        "plain_ms": p_ms,
        "bound_ms": path_bound,
        "bound_by": path_by,
        "library_ms": None,
        "ms_range": [t_k[0], t_k[-1]],
        "bare_ms_range": [t_bare[0], t_bare[-1]],
        "simt_efficiency": cam_simt,
        "issue_floor_ms": cam_floor,
        "sass_per_row": cam_sass["per_row"],
    }, whitted, *raster, *wavefront, *tiers, *culled["entries"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def whitted_scenes():
    """Phase 6's scenes, built with the port's models: name -> a
    function that builds the scene."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import mirror_glass_cornell, textured_cornell

    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.ops.shading import ShaderType
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils.texture import Texture

    return {
        "cornell": build_cornell_scene,
        "mirror_glass": lambda: mirror_glass_cornell(models, build_cornell_scene),
        "textured": lambda: textured_cornell(build_cornell_scene, ShaderType,
                                             Texture),
    }


def compare_whitted(k_rgb, k_nray, p_rgb, p_nray) -> dict:
    """Kernel vs plain on the same lanes: differing pixels, frame means,
    ray counts."""
    diff = (k_rgb - p_rgb).abs()
    ok = (diff <= PIX_ATOL + PIX_RTOL * p_rgb.abs()).all(dim=1)
    km, pm = float(k_rgb.mean()), float(p_rgb.mean())
    k_rays = [int(x) for x in k_nray.sum(dim=1)]
    p_rays = [int(x) for x in p_nray.sum(dim=1)]
    return {
        "n": int(ok.numel()), "bad": int((~ok).sum()),
        "max_abs_err": float(diff.max()),
        "mean_rel": abs(km - pm) / max(abs(pm), 1e-30),
        "rays_rel": max(abs(a - b) / max(b, 1) for a, b in zip(k_rays, p_rays)),
        "k_rays": k_rays, "p_rays": p_rays,
    }


def whitted_phases(dev, card: str) -> dict:
    """Phases 6-9; returns the Whitted kernel's entry of the JSON line."""
    import numpy as np
    import torch

    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.ops.whitted import whitted_render
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene

    n = WIDTH * HEIGHT
    md = WHITTED_DEPTH

    def plain(rt, o, d, off=0, count=n):
        out = wk.whitted_uber_trace_plain(rt, o[off:off + count],
                                          d[off:off + count], md)
        torch.cuda.synchronize()
        return out

    # ---- 6. kernel vs plain at full width, three scenes
    runs, lines = {}, []
    max_err = 0.0
    for name, build in whitted_scenes().items():
        scene = build()
        scene.set_ndc_matrix(WIDTH, HEIGHT)
        rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
        o, d = (x.contiguous() for x in camera_rays(
            rt.eye.cpu().numpy(), scene.fovy, WIDTH, HEIGHT, dev))
        k_rgb, k_nray = wk.whitted_uber_trace(rt, o, d, md)
        torch.cuda.synchronize()
        if k_rgb.shape != (n, 3) or not bool(torch.isfinite(k_rgb).all()):
            fail(f"Whitted kernel frame of {name} has shape "
                 f"{tuple(k_rgb.shape)} or non-finite values")
        if not bool((k_rgb != 0).any()):
            fail(f"the Whitted kernel frame of {name} is black")
        # the plain version's time: a fixed cost per torch op plus a cost
        # per lane, extrapolated from two window sizes
        small, large = WINDOW, 16 * WINDOW
        t0 = time.perf_counter()
        plain(rt, o, d, n // 2 - small // 2, small)
        t_small = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain(rt, o, d, n // 2 - large // 2, large)
        t_large = time.perf_counter() - t0
        est = t_large + max(t_large - t_small, 0.0) * (n - large) / (large - small)
        if est <= PLAIN_FULL_LIMIT_S:
            t0 = time.perf_counter()
            p_rgb, p_nray = plain(rt, o, d)
            full_s = time.perf_counter() - t0
            c = compare_whitted(k_rgb, k_nray, p_rgb, p_nray)
            where = f"full frame (plain {full_s:.1f}s)"
        else:
            full_s = None
            offs = [n // 4, n // 2 - WINDOW // 2, 3 * n // 4 - WINDOW]
            parts = [plain(rt, o, d, off, WINDOW) for off in offs]
            idx = torch.cat([torch.arange(off, off + WINDOW, device=dev)
                             for off in offs])
            c = compare_whitted(k_rgb[idx], k_nray[:, idx],
                                torch.cat([p[0] for p in parts]),
                                torch.cat([p[1] for p in parts], dim=1))
            where = f"three {WINDOW}-pixel windows (full plain est. {est:.0f}s)"
        max_err = max(max_err, c["max_abs_err"])
        # divergence: a warp runs until its lane with the most main rays
        # is done (frame rows are whole warps)
        main = k_nray[0].reshape(-1, 32)
        simt = float(main.sum()) / float(main.max(dim=1).values.sum() * 32)
        lines.append(
            f"{name}: {c['bad']}/{c['n']} pixels differ over the {where}, "
            f"mean rel {c['mean_rel']:.2e}, rays main/shadow "
            f"{c['k_rays'][0]}/{c['k_rays'][1]} vs {c['p_rays'][0]}/{c['p_rays'][1]}, "
            f"max {int(main.max())} main rays a lane, warp SIMT efficiency {simt:.4f}")
        if (c["bad"] > (1.0 - PIX_SHARE) * c["n"] or c["mean_rel"] > MEAN_RTOL
                or c["rays_rel"] > RAYS_RTOL):
            fail(f"Whitted kernel disagrees with plain: {lines[-1]}")
        runs[name] = {"rt": rt, "o": o, "d": d, "rgb": k_rgb,
                      "rays": [int(x) for x in k_nray.sum(dim=1)],
                      "full_s": full_s}
    phase(6, f"Whitted kernel vs plain {WIDTH}x{HEIGHT} max_depth {md}: "
             + "; ".join(lines) + f"; max_abs_err {max_err:.3g}")

    # ---- 7. golden
    gscene = build_cornell_scene()
    gscene.set_ndc_matrix(64, 64)
    grt = prepare_rt_scene(gscene.rt_geometry(), gscene.rt_frame(), dev)
    gimg = whitted_render(grt, 64, 64, gscene.fovy, max_depth=4).cpu().numpy()
    want = np.load(ROOT / "tests" / "goldens" / "cornell_goldens.npz")["whitted"]
    share = float(np.isclose(gimg, want, rtol=WG_TOL, atol=WG_TOL).mean())
    if not share > WG_SHARE:
        fail(f"Whitted golden: {share:.4%} of values within {WG_TOL}")
    phase(7, f"Whitted golden 64x64 max_depth 4 through the kernel: "
             f"{share:.4%} of values within rtol=atol={WG_TOL} (> {WG_SHARE:.1%})")

    # ---- 8. main path through the normal entry point
    render = pipeline_from_config(RenderConfig(width=WIDTH, height=HEIGHT),
                                  "whitted", device=dev)
    cornell = build_cornell_scene()
    render.add_scene(cornell)
    wk.LAUNCHES = 0
    render.draw()
    torch.cuda.synchronize()
    launches = wk.LAUNCHES
    png = OUT_DIR / "chip_smoke_whitted_cornell.png"
    render.save(str(png))
    frame = render.frame
    if launches != 1:
        fail(f"expected 1 Whitted kernel launch on the main path, counted {launches}")
    if frame.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(frame).all():
        fail("RayTracing.draw() frame has the wrong shape or non-finite values")
    ref = runs["cornell"]["rgb"].reshape(HEIGHT, WIDTH, 3).cpu().numpy()
    same = np.isclose(frame, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    if same.mean() < PIX_SHARE:
        fail(f"draw() differs from the phase-6 kernel frame on "
             f"{int((~same).sum())} pixels")
    st = render.last_stats[cornell.name]
    want_rays = runs["cornell"]["rays"]
    if st["dropped_rays"] != 0 or [st["rays_main"], st["rays_shadow"]] != want_rays:
        fail(f"last_stats {st} disagree with phase 6's rays {want_rays}")
    phase(8, f"pipeline_from_config -> RayTracing.draw -> {png.name}: mean "
             f"{frame.mean():.5f}, launches {launches}, {int((~same).sum())} "
             f"pixels differ from phase 6, last_stats {st}")

    # ---- 9. times
    times = {}
    for name in ("cornell", "mirror_glass"):
        r = runs[name]
        k_ms = cuda_ms(lambda: wk.whitted_uber_trace(r["rt"], r["o"], r["d"], md))
        if r["full_s"] is not None:
            p_ms = cuda_ms(lambda: plain(r["rt"], r["o"], r["d"]))
            how = "full frame"
        else:
            off = n // 2 - WINDOW // 2
            p_ms = cuda_ms(lambda: plain(r["rt"], r["o"], r["d"], off, WINDOW)) * n / WINDOW
            how = f"one {WINDOW}-pixel window scaled by {n // WINDOW}"
        # the launch alone, with the operand tables packed beforehand:
        # what whitted_uber_trace adds is the wrapper's host work
        args, kw = wk.whitted_launch_args(r["rt"], r["o"], r["d"], md)
        bare_ms = cuda_ms(lambda: wk.launch_whitted_uber(*args, **kw), repeats=20)
        times[name] = (k_ms, p_ms, bare_ms)
        phase(9, f"Whitted {name}: kernel {k_ms:.3f} ms ({n / k_ms / 1e3:.2f} M "
                 f"primary rays/s; bare launch {bare_ms:.3f} ms, median of 20), "
                 f"plain {p_ms:.1f} ms ({n / p_ms / 1e3:.4f} M "
                 f"primary rays/s; {how}, median of 3 after warm-up) at "
                 f"{WIDTH}x{HEIGHT} max_depth {md} on {card}")

    k_ms, p_ms, bare_ms = times["cornell"]
    # the kernel's bound on Cornell: every main and shadow ray meets every
    # primitive (~30 float32 operations a triangle, ~25 a sphere), every
    # diffuse hit spends ~200 on Phong; rays in, colours and counts out
    r = runs["cornell"]
    main_rays, shadow_rays = r["rays"]
    args, kw = wk.whitted_launch_args(r["rt"], r["o"], r["d"], md)
    w_bound, w_by = bound(
        tensor_bytes(*args[:3], r["o"], r["d"], r["rgb"]) + 8 * n + 32,
        (main_rays + shadow_rays) * (30 * kw["n_tri"] + 25 * kw["n_sph"])
        + 200 * shadow_rays)
    # the sweep's row-test slots (its SIMT efficiency) and the issue floor
    # of its row loop over them
    tally = torch.zeros((2, 3), dtype=torch.int64, device=dev)
    wk.launch_whitted_uber(*args, tally=tally, **kw)
    torch.cuda.synchronize()
    eff = {ray: int(tally[i, 0]) / int(tally[i, 2]) for i, ray in enumerate(wk.TALLY_ROWS)}
    # the full-sweep instance with the 8-entry stack (max_depth 5)
    floor_ms, loop = issue_floor("whitted_uber", "whitted_uber_kernelILb0ELi8E", 1,
                                 int(tally[:, 2].sum()), rays=1)
    phase(9, f"Whitted cornell bound {w_bound:.4f} ms by {w_by}; SIMT efficiency of the "
             f"sweep (row tests / row-test slots, the kernel's tally) main {eff['main']:.4f}, "
             f"shadow {eff['shadow']:.4f}; issue floor {floor_ms:.4f} ms ({loop['per_row']:g} "
             f"SASS instructions a row and ray, {loop['unroll']} rows a loop iteration: "
             + ", ".join(f"{o} {c:g}" for o, c in loop["mix"].items())
             + f"; x {int(tally[:, 2].sum())} slots / 32); bare launch "
             f"{bare_ms / floor_ms:.2f}x the issue floor")
    return {
        "name": "whitted_uber",
        "route": "cuda",
        "source": "software_rasterizer_tpu_torch/csrc/whitted_uber.cu",
        "replaces": "software_rasterizer_tpu/ops/pallas_whitted.py:173",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "bare_ms": bare_ms,
        "plain_ms": p_ms,
        "bound_ms": w_bound,
        "bound_by": w_by,
        "library_ms": None,
        "simt_efficiency": eff,
        "issue_floor_ms": floor_ms,
        "sass_per_row": loop["per_row"],
    }


def raster_scene(variant: str, levels: int = RASTER_LEVELS):
    """The lit, tessellated Cornell box of tests/torch_scenes.py, built
    with the port's models (36 x 4^levels triangles)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import raster_cornell

    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.ops.shading import ShaderType
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
    from software_rasterizer_tpu_torch.utils.texture import Texture

    return raster_cornell(models, build_cornell_scene, subdivide_mesh,
                          ShaderType, Texture, levels, variant)


def compare_raster(kern: dict, plain: dict) -> dict:
    """A tile kernel's result against its plain version's: pixels whose
    winner differs, pixels where any other output differs at all, and,
    over the pixels with equal winners, the largest |difference| of a
    float plane and the pixels outside rtol / atol."""
    import torch

    same = kern["best_idx"] == plain["best_idx"]
    any_diff = ~same
    bad = torch.zeros_like(same)
    max_err = 0.0
    for key, k in kern.items():
        q = plain[key]
        if key in ("best_idx", "bin_dropped"):
            continue
        k, q = k[same], q[same]
        eq = k == q                      # +inf == +inf where nothing covers
        if not k.is_floating_point():
            off = ~eq
        else:
            d = torch.where(eq, torch.zeros_like(k), (k - q).abs())
            d = torch.nan_to_num(d, nan=float("inf"), posinf=float("inf"))
            if d.numel():
                max_err = max(max_err, float(d.max()))
            off = d > RASTER_ATOL + RASTER_RTOL * q.abs()
        if off.dim() == 2:
            eq, off = eq.all(dim=1), off.any(dim=1)
        pix = torch.zeros_like(same)
        pix[same] = ~eq
        any_diff |= pix
        pix = torch.zeros_like(same)
        pix[same] = off
        bad |= pix
    return {"n": int(same.numel()), "winners": int((~same).sum()),
            "any": int(any_diff.sum()), "bad": int(bad.sum()),
            "max_abs_err": max_err,
            "dropped": (int(kern["bin_dropped"]), int(plain["bin_dropped"]))}


def raster_phases(dev, card: str) -> list:
    """Phases 10-14; returns the two raster kernels' entries of the JSON
    line."""
    import numpy as np
    import torch

    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import raster as tr
    from software_rasterizer_tpu_torch.ops import raster_kernel as rk
    from software_rasterizer_tpu_torch.render import (
        TraditionalRasterizer,
        pipeline_from_config,
    )
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils import sass
    from software_rasterizer_tpu_torch.utils.cuda_build import library_path

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import set_raster_cornell_angle

    H, W = HEIGHT, WIDTH
    n = H * W
    th, tw = rk.TILE_H, rk.TILE_W
    gh, gw = -(-H // th), -(-W // tw)
    bin_plain = rk.bin_triangles

    def setup(variant, levels=RASTER_LEVELS):
        scene = raster_scene(variant, levels)
        scene.set_ndc_matrix(W, H)
        host = scene.raster_geometry()
        geom = tr.prepare_raster_geometry(host, dev)
        frame = tr.prepare_raster_frame(scene.raster_frame(), dev)
        active = tuple(sorted(set(int(t) for t in host.shader_type)))
        return scene, geom, frame, active, tr.raster_tables(geom, frame)

    def check(name, c, overflow=False):
        line = (f"{name}: winners differ on {c['winners']}/{c['n']} pixels, any "
                f"output on {c['any']}, {c['bad']} outside rtol={RASTER_RTOL} "
                f"atol={RASTER_ATOL}, max |diff| {c['max_abs_err']:.3g}, "
                f"bin_dropped {c['dropped'][0]} / {c['dropped'][1]}")
        dropped_ok = (c["dropped"][0] == c["dropped"][1] > 0 if overflow
                      else c["dropped"] == (0, 0))
        if (c["winners"] > (1.0 - RASTER_SHARE) * c["n"] or c["bad"] > 0
                or not dropped_ok):
            fail(f"raster kernel disagrees with plain: {line}")
        return line

    def cap_of(tab):
        return min(2048, max(256, ((tab[0].shape[0] + 127) // 128) * 128))

    def lists_check(name, tab, lights_, cap):
        """The kernels' own lists against plain bin_triangles entry for
        entry: the tile launch's (lists_out, counts_out, bin_dropped) and
        bin_triangles_device's."""
        geo, attr, bbox, keep = tab
        want = bin_plain(bbox, keep, gh, gw, th, tw, cap)
        lists = torch.zeros((gh * gw, cap), dtype=torch.int32, device=dev)
        counts = torch.zeros(gh * gw, dtype=torch.int32, device=dev)
        *_, dropped = rk.launch_raster_tiles(
            geo, attr, bbox, keep, lights_, height=H, width=W, gh=gh, gw=gw, tile_h=th,
            tile_w=tw, cap=cap, lists_out=lists, counts_out=counts)
        alone = rk.bin_triangles_device(bbox, keep, gh, gw, th, tw, cap)
        torch.cuda.synchronize()
        for what, got in (("the tile launch's", (lists, counts, dropped)),
                          ("bin_triangles_device's", alone)):
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"{name}, cap {cap}: {what} lists differ from bin_triangles': "
                     f"counts off in {int((got[1] != want[1]).sum())} tiles, dropped "
                     f"{int(got[2])} / {int(want[2])}")
        return (f"{name} device lists == bin_triangles at cap {cap} "
                f"({int(want[1].sum())} entries, bin_dropped {int(want[2])})")

    # ---- 10. fused kernel vs plain, whole frame, five shaders
    scene5, geom5, frame5, active5, tab5 = setup("five")
    n_faces = int(geom5.face_valid.sum())
    k_f = rk.raster_tiles_fused(*tab5, H, W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_f = rk.raster_tiles_fused_plain(*tab5, H, W)
    torch.cuda.synchronize()
    plain_f_s = time.perf_counter() - t0
    coverage = float((k_f["best_idx"] >= 0).float().mean())
    if not bool(torch.isfinite(k_f["normal"]).all()):
        fail("the fused kernel's planes hold non-finite values")
    c_f = compare_raster(k_f, p_f)
    small = RASTER_SMALL_CAP
    c_f16 = compare_raster(rk.raster_tiles_fused(*tab5, H, W, cap=small),
                           rk.raster_tiles_fused_plain(*tab5, H, W, cap=small))
    phase(10, f"raster fused kernel vs plain {W}x{H}, {n_faces} triangles, "
              f"coverage {coverage:.4f}, whole frame (plain {plain_f_s:.2f}s): "
              + check("five shaders", c_f) + "; at cap "
              + check(f"{small}", c_f16, overflow=True) + "; "
              + lists_check("five shaders", tab5, None, cap_of(tab5)) + "; "
              + lists_check("five shaders", tab5, None, small))

    # ---- 11. shaded kernel vs plain, whole frame, three shaders
    scene3, geom3, frame3, active3, tab3 = setup("three")
    lights = frame3.lights.contiguous()
    k_s = rk.raster_tiles_shaded(*tab3, lights, H, W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_s = rk.raster_tiles_shaded_plain(*tab3, lights, H, W)
    torch.cuda.synchronize()
    plain_s_s = time.perf_counter() - t0
    c_s = compare_raster(k_s, p_s)
    c_s16 = compare_raster(rk.raster_tiles_shaded(*tab3, lights, H, W, cap=small),
                           rk.raster_tiles_shaded_plain(*tab3, lights, H, W, cap=small))
    img_d, z_d, st_d = tr.render_raster_frame(
        geom3, frame3, H, W, active_types=active3, with_stats=True)
    img_s, z_s, st_s = tr.render_raster_frame(
        geom3, frame3, H, W, active_types=active3, with_stats=True, shaded=True)
    if (st_d["kernel"], st_s["kernel"]) != ("raster_tiles", "raster_tiles_shaded"):
        fail(f"wrong kernels ran: {st_d['kernel']}, {st_s['kernel']}")
    sd = float((img_s - img_d).abs().max())
    sd_ok = bool(torch.isclose(img_s, img_d, rtol=1e-5, atol=1e-5).all())
    if not torch.equal(z_s, z_d) or not sd_ok:
        fail(f"shaded frame differs from the deferred one: z equal "
             f"{torch.equal(z_s, z_d)}, max |diff| {sd}")
    phase(11, f"raster shaded kernel vs plain {W}x{H}, whole frame (plain "
              f"{plain_s_s:.2f}s): " + check("three shaders", c_s) + "; at cap "
              + check(f"{small}", c_s16, overflow=True) + "; "
              + lists_check("three shaders", tab3, lights, cap_of(tab3)) + "; "
              + lists_check("three shaders", tab3, lights, small)
              + f"; shaded vs deferred image max |diff| {sd:.3g} (rtol=atol=1e-5), "
              f"z-buffers identical")

    # ---- 12. golden
    gscene = build_cornell_scene()
    gscene.set_ndc_matrix(96, 96)
    ggeom = tr.prepare_raster_geometry(gscene.raster_geometry(), dev)
    gimg, gz = tr.render_raster_frame(ggeom, gscene.raster_frame(), 96, 96)
    gimg, gz = gimg.cpu().numpy(), gz.cpu().numpy()
    goldens = np.load(ROOT / "tests" / "goldens" / "cornell_goldens.npz")
    got_cov, want_cov = np.isfinite(gz), np.isfinite(goldens["raster_z"])
    mism = float((got_cov != want_cov).mean())
    both = got_cov & want_cov
    gerr = float(np.abs(gimg[both] - goldens["raster"][both]).max())
    if not (mism < RG_COVER and np.allclose(gimg[both], goldens["raster"][both],
                                            rtol=RG_TOL, atol=RG_TOL)):
        fail(f"raster golden: coverage mismatch {mism}, max |diff| {gerr}")
    phase(12, f"raster golden 96x96 through the kernel: coverage mismatch "
              f"{mism:.4f} (< {RG_COVER}), max |diff| {gerr:.3g} on {int(both.sum())} "
              f"covered pixels (rtol=atol={RG_TOL})")

    # ---- 13. main path through the normal entry point, default device;
    # plain binning must not run on the card's tensors
    bin_calls = [0]

    def counted_bins(tri_bbox, *args, **kwargs):
        if tri_bbox.is_cuda:
            bin_calls[0] += 1
        return bin_plain(tri_bbox, *args, **kwargs)

    angles = [8.0 + 5.0 * i for i in range(RASTER_BATCH)]
    rk.bin_triangles = counted_bins
    rk.LAUNCHES = rk.LAUNCHES_SHADED = 0
    render = pipeline_from_config(RenderConfig(width=W, height=H), "raster")
    render.add_scene(scene5)
    render.draw()
    png5 = OUT_DIR / "chip_smoke_raster_cornell.png"
    render.save(str(png5))
    frame_d, zbuf_d = render.frame.copy(), render.zbuffer.copy()
    stats_d = dict(render.last_stats[scene5.name])
    render_s = pipeline_from_config(RenderConfig(width=W, height=H), "raster")
    render_s.shaded = True
    render_s.add_scene(scene3)
    render_s.draw()
    png3 = OUT_DIR / "chip_smoke_raster_cornell_shaded.png"
    render_s.save(str(png3))
    stats_s = dict(render_s.last_stats[scene3.name])
    frames = []
    for a in angles:
        set_raster_cornell_angle(scene5, a)
        frames.append(scene5.raster_frame())
    imgs, zbufs = render.draw_batch(scene5, frames)
    torch.cuda.synchronize()
    launches, launches_s = rk.LAUNCHES, rk.LAUNCHES_SHADED
    rk.bin_triangles = bin_plain
    if bin_calls[0]:
        fail(f"bin_triangles ran {bin_calls[0]} times on the card's tensors on the main path")
    batch_dropped = int(render.last_stats[scene5.name]["bin_dropped"])
    if not (isinstance(render, TraditionalRasterizer) and render.device.type == "cuda"):
        fail(f"pipeline_from_config gave {type(render).__name__} on {render.device}")
    if (launches, launches_s) != (1 + RASTER_BATCH, 1):
        fail(f"expected {1 + RASTER_BATCH} fused and 1 shaded launches on the "
             f"main path, counted {launches} and {launches_s}")
    if stats_d != {"bin_dropped": 0, "kernel": "raster_tiles"} or stats_s != {
            "bin_dropped": 0, "kernel": "raster_tiles_shaded"} or batch_dropped:
        fail(f"last_stats {stats_d} / {stats_s} / batch bin_dropped {batch_dropped}")
    cov_d = float(np.isfinite(zbuf_d).mean())
    if frame_d.shape != (H, W, 3) or not np.isfinite(frame_d).all():
        fail("TraditionalRasterizer.draw() frame has the wrong shape or non-finite values")
    if cov_d < RASTER_COVERAGE_MIN:
        fail(f"coverage {cov_d:.4f} is below {RASTER_COVERAGE_MIN}")
    img10, z10 = tr.render_raster_frame(geom5, frame5, H, W, active_types=active5)
    if not (np.array_equal(frame_d, img10.cpu().numpy())
            and np.array_equal(zbuf_d, z10.cpu().numpy())):
        fail("draw() differs from render_raster_frame on phase 10's tables")
    if not np.array_equal(render_s.frame, img_s.cpu().numpy()):
        fail("the shaded draw() differs from phase 11's shaded frame")
    # after the counts are read: the batch against one draw() per frame
    imgs, zbufs = imgs.cpu().numpy(), zbufs.cpu().numpy()
    for i, a in enumerate(angles):
        set_raster_cornell_angle(scene5, a)
        render.clear()
        render.draw()
        if not (np.array_equal(imgs[i], render.frame)
                and np.array_equal(zbufs[i], render.zbuffer)):
            fail(f"draw_batch frame {i} differs from draw()")
    if np.array_equal(imgs[0], imgs[-1]):
        fail("the turned frames of draw_batch are all the same")
    # any positive raster_tile: the JAX package's default (128, 128) and
    # (64, 32) give way to the default kernel tile and the same frame
    set_raster_cornell_angle(scene5, angles[0])
    for tile in ((128, 128), (64, 32)):
        r_t = pipeline_from_config(RenderConfig(width=W, height=H, raster_tile=tile), "raster")
        r_t.add_scene(scene5)
        r_t.draw()
        if r_t.last_stats[scene5.name]["bin_dropped"] or not (
                np.array_equal(r_t.frame, frame_d) and np.array_equal(r_t.zbuffer, zbuf_d)):
            fail(f"raster_tile {tile}: bin_dropped "
                 f"{r_t.last_stats[scene5.name]['bin_dropped']}, or the frame differs "
                 f"from the (16, 32) frame")
    phase(13, f"pipeline_from_config(cfg, \"raster\") on {render.device} -> draw -> "
              f"{png5.name} / {png3.name}: coverage {cov_d:.4f} (>= "
              f"{RASTER_COVERAGE_MIN}), mean {frame_d.mean():.5f} / "
              f"{render_s.frame.mean():.5f}, launches fused {launches} shaded "
              f"{launches_s}, bin_triangles on the card's tensors {bin_calls[0]}, "
              f"bin_dropped 0, equal to phases 10 and 11; "
              f"draw_batch of {RASTER_BATCH} turned frames bit-identical to "
              f"{RASTER_BATCH} draws; raster_tile (128, 128) and (64, 32) (kernel "
              f"tile {rk.kernel_tile(128, 128)}) give the "
              f"(16, 32) frame bit for bit, bin_dropped 0")

    # ---- 14. times
    set_raster_cornell_angle(scene5, angles[0])
    host5, host3 = scene5.raster_frame(), scene3.raster_frame()
    reps = 20
    t_frame_d = cuda_times(lambda: tr.render_raster_frame(
        geom5, host5, H, W, active_types=active5), reps)
    t_frame_s = cuda_times(lambda: tr.render_raster_frame(
        geom3, host3, H, W, active_types=active3, shaded=True), reps)
    t_tables = cuda_times(lambda: tr.raster_tables(
        geom5, tr.prepare_raster_frame(host5, dev)), reps)
    cap = cap_of(tab5)
    kw = dict(height=H, width=W, gh=gh, gw=gw, tile_h=th, tile_w=tw, cap=cap)

    def bins5():
        return rk.bin_triangles_device(tab5[2], tab5[3], gh, gw, th, tw, cap)

    def bare5():
        return rk.launch_raster_tiles(*tab5, None, **kw)

    def bare3():
        return rk.launch_raster_tiles(*tab3, lights, **kw)

    t_bin_plain = cuda_times(lambda: bin_plain(tab5[2], tab5[3], gh, gw, th, tw, cap), reps)
    t_bin = cuda_times(bins5, reps)
    lists5, counts5, _ = bin_plain(tab5[2], tab5[3], gh, gw, th, tw, cap)
    lists3, counts3, _ = bin_plain(tab3[2], tab3[3], gh, gw, th, tw, cap)
    t_wrap_f = cuda_times(lambda: rk.raster_tiles_fused(*tab5, H, W), reps)
    t_wrap_s = cuda_times(lambda: rk.raster_tiles_shaded(*tab3, lights, H, W), reps)
    t_bare_f = cuda_times(bare5, reps)
    t_bare_s = cuda_times(bare3, reps)
    t_dev_f = device_times(bare5, 20, 5)
    t_dev_s = device_times(bare3, 20, 5)
    t_bin_dev = device_times(bins5, 20, 5)
    t_shade_d = cuda_times(lambda: tr.shade_deferred(
        k_f, geom5, frame5, 0, active5), reps)
    t_shade_s = cuda_times(lambda: tr.apply_tex_quadratic(k_s, geom3), reps)
    t_batch = [t / RASTER_BATCH for t in cuda_times(
        lambda: render.draw_batch(scene5, frames), 5)]
    t_plain_f = cuda_times(lambda: rk.raster_tiles_fused_plain(*tab5, H, W), 3)
    t_plain_s = cuda_times(lambda: rk.raster_tiles_shaded_plain(*tab3, lights, H, W), 3)
    t0 = time.perf_counter()
    render.clear()
    render.draw()
    draw_wall = (time.perf_counter() - t0) * 1e3
    med = statistics.median
    phase(14, f"raster {W}x{H}, {n_faces} triangles, tile {th}x{tw}, ms as median "
              f"[min-max] of {reps} after a warm-up, on {card}: frame deferred "
              f"{spread(t_frame_d)} ({1e3 / med(t_frame_d):.1f} frames/s), frame "
              f"shaded {spread(t_frame_s)}; stages: upload + vertex + setup + "
              f"tables {spread(t_tables)}, fused wrapper (binning + launch) "
              f"{spread(t_wrap_f)} with the bare launch {spread(t_bare_f)}, "
              f"device-only {spread(t_dev_f)}, shaded wrapper {spread(t_wrap_s)} with "
              f"the bare launch {spread(t_bare_s)}, device-only {spread(t_dev_s)}, "
              f"the kernels' binning alone {spread(t_bin)} (device-only "
              f"{spread(t_bin_dev)}; plain bin_triangles {spread(t_bin_plain)}), "
              f"deferred shading {spread(t_shade_d)}, texel quadratic "
              f"{spread(t_shade_s)}; draw_batch per frame {spread(t_batch)} "
              f"(5 batches of {RASTER_BATCH}); one draw() with its copy to the "
              f"host {draw_wall:.1f} ms wall; plain fused {spread(t_plain_f)}, "
              f"plain shaded {spread(t_plain_s)} (3 each); device-only: "
              f"{20} launches in one CUDA graph, one replay between two events, "
              f"over {20}, median [min-max] of 5")

    # the wrappers' bounds: ~21 float32 operations a pixel and list entry in
    # the walk, ~60 to interpolate a covered pixel, and for the shaded
    # kernel ~30 + 70 a light on top; the four operand tables read once,
    # every output plane written once (the lists are an intermediate, and
    # binning is how the work is done, not what is computed)
    pix = th * tw
    n_lights = (lights.numel() - 3) // 6
    entries5, entries3 = int(counts5.sum()), int(counts3.sum())
    covered3 = int((k_s["best_idx"] >= 0).sum())
    covered5 = int((k_f["best_idx"] >= 0).sum())
    b_f, by_f = bound(
        tensor_bytes(*tab5) + 48 * n,
        21 * entries5 * pix + 60 * covered5)
    b_s, by_s = bound(
        tensor_bytes(*tab3, lights) + 64 * n,
        21 * entries3 * pix + (90 + 70 * n_lights) * covered3)
    # the issue floor of the walk loop: its SASS a list entry and pixel x
    # the frame's list entries x the warps of a tile
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SCHEDULERS_PER_SM * max_sm_clock_hz()
    floors = {}
    for kern, entries in (("fused", entries5), ("shaded", entries3)):
        lp = sass.walk_loop(sass.kernel_sass(library_path("raster_tiles"),
                                             rk.WALK_KERNELS[kern]), rk.WALK_ENTRY_BYTES)
        floors[kern] = (lp["per_entry"] * entries * (-(-pix // 32)) / rate * 1e3, lp)
    box = {}
    rk.bin_triangles_two_level_plain(tab5[2], tab5[3], gh, gw, th, tw, cap, stats=box)
    lp = floors["fused"][1]
    phase(14, f"bounds: fused {b_f:.4f} ms by {by_f} ({entries5} list entries, mean "
              f"{entries5 / (gh * gw):.1f} a tile, longest {int(counts5.max())}), "
              f"shaded {b_s:.4f} ms by {by_s}; issue floor of the walk loop fused "
              f"{floors['fused'][0]:.4f} ms, shaded {floors['shaded'][0]:.4f} "
              f"({lp['per_entry']:g} SASS a list entry and pixel, {lp['unroll']} entries an "
              f"iteration: " + ", ".join(f"{o} {c:g}" for o, c in lp["mix"].items())
              + f"); the binning's box tests: {box['coarse_tests']} coarse + "
              f"{box['fine_tests']} fine ({rk.coarse_grid(gh, gw, th, tw)[2:]} coarse "
              f"tiles) against {gh * gw * tab5[2].shape[0]} for the (tiles x triangles) "
              f"plain pass")

    # the kernels against the parent's in turns, where a parent tree is
    # unpacked under _checkout/parent; this tree's (a)-(d) alone otherwise
    parent = ROOT / "_checkout" / "parent"
    trees = {"parent": parent} if (parent / "software_rasterizer_tpu_torch").is_dir() else {}
    ab = raster_ab({**trees, "this": ROOT})
    if not trees:
        phase(14, "raster_ab: no parent tree under _checkout/parent, this tree alone")

    # the large scene: 147,456 triangles, lists, frames and times
    large = {}
    for kern, variant in (("fused", "five"), ("shaded", "three")):
        *_, frame_l, _, tab_l = setup(variant, RASTER_LARGE_LEVELS)
        lts = frame_l.lights.contiguous() if kern == "shaded" else None
        cap_l = cap_of(tab_l)
        lists_line = lists_check(f"{kern} large", tab_l, lts, cap_l)
        if kern == "fused":
            k_l = rk.raster_tiles_fused(*tab_l, H, W)
            p_l = rk.raster_tiles_fused_plain(*tab_l, H, W)
        else:
            k_l = rk.raster_tiles_shaded(*tab_l, lts, H, W)
            p_l = rk.raster_tiles_shaded_plain(*tab_l, lts, H, W)
        c_l = compare_raster(k_l, p_l)
        if c_l["dropped"][0] != c_l["dropped"][1]:
            fail(f"large {kern}: bin_dropped {c_l['dropped']}")
        c_l["dropped"] = (0, 0)           # printed below; any count is allowed here
        frame_line = check(kern, c_l)
        kw_l = dict(kw, cap=cap_l)

        def wrap_l(tab_l=tab_l, lts=lts):
            return (rk.raster_tiles_fused(*tab_l, H, W) if lts is None
                    else rk.raster_tiles_shaded(*tab_l, lts, H, W))

        def bare_l(tab_l=tab_l, lts=lts, kw_l=kw_l):
            return rk.launch_raster_tiles(*tab_l, lts, **kw_l)

        def bins_l(tab_l=tab_l, cap_l=cap_l):
            return rk.bin_triangles_device(tab_l[2], tab_l[3], gh, gw, th, tw, cap_l)

        lists_l, counts_l, dropped_l = bin_plain(tab_l[2], tab_l[3], gh, gw, th, tw, cap_l)
        large[kern] = {
            "n_faces": int(tab_l[0].shape[0]), "entries": int(counts_l.sum()),
            "bin_dropped": int(dropped_l), "ms": cuda_times(wrap_l, reps),
            "device_ms": device_times(bare_l, 20, 5),
            "binning_device_ms": device_times(bins_l, 20, 5),
            "plain_binning_ms": cuda_times(lambda: bin_plain(
                tab_l[2], tab_l[3], gh, gw, th, tw, cap_l), 3)}
        lg = large[kern]
        phase(14, f"large scene, {kern}, {lg['n_faces']} triangles, cap {cap_l}: "
                  f"{lists_line}; frame vs plain: {frame_line}; wrapper {spread(lg['ms'])} "
                  f"ms, device-only {spread(lg['device_ms'])}, the binning alone "
                  f"device-only {spread(lg['binning_device_ms'])}, plain bin_triangles "
                  f"{spread(lg['plain_binning_ms'])}; {lg['entries']} list entries, longest "
                  f"{int(counts_l.max())}, bin_dropped {lg['bin_dropped']}")
        del lists_l

    def entry(kern, wrap_t, bare_t, dev_t, entries, c_, launches_, plain_t, b_, by_):
        lg = large[kern]
        return {
            "launches": launches_, "max_abs_err": c_["max_abs_err"],
            "ms": med(wrap_t), "bare_ms": med(bare_t), "device_ms": med(dev_t),
            "ms_range": [wrap_t[0], wrap_t[-1]], "device_ms_range": [dev_t[0], dev_t[-1]],
            "plain_ms": med(plain_t), "bound_ms": b_, "bound_by": by_,
            "issue_floor_ms": floors[kern][0], "sass_per_entry": floors[kern][1]["per_entry"],
            "list_entries": entries, "binning_ms": med(t_bin),
            "binning_device_ms": med(t_bin_dev), "plain_binning_ms": med(t_bin_plain),
            "box_tests": [box["coarse_tests"], box["fine_tests"]],
            "ab": {b: {r: med(v) for r, v in t.items()} for b, t in ab[kern].items()},
            "large": {"n_faces": lg["n_faces"], "list_entries": lg["entries"],
                      "bin_dropped": lg["bin_dropped"], "ms": med(lg["ms"]),
                      "device_ms": med(lg["device_ms"]),
                      "binning_device_ms": med(lg["binning_device_ms"]),
                      "plain_binning_ms": med(lg["plain_binning_ms"])},
            "route": "cuda", "source": "software_rasterizer_tpu_torch/csrc/raster_tiles.cu",
            "library_ms": None}

    return [
        {"name": "raster_tiles",
         "replaces": "software_rasterizer_tpu/ops/pallas_raster.py:86",
         **entry("fused", t_wrap_f, t_bare_f, t_dev_f, entries5, c_f, launches, t_plain_f,
                 b_f, by_f)},
        {"name": "raster_tiles_shaded",
         "replaces": "software_rasterizer_tpu/ops/pallas_raster.py:167",
         **entry("shaded", t_wrap_s, t_bare_s, t_dev_s, entries3, c_s, launches_s, t_plain_s,
                 b_s, by_s)},
    ]


def same_lanes(a, b):
    """(N,) bool: the lanes on which two tensors of N rows agree bit for
    bit (a NaN equals a NaN)."""
    eq = a == b
    if a.is_floating_point():
        eq = eq | ((a != a) & (b != b))
    return eq.reshape(eq.shape[0], -1).all(dim=1)


def wavefront_phases(dev, card: str, cam_mean: float, cam_mpaths: float) -> list:
    """Phases 15-18: the explicit-ray layer. Returns the entries of the
    trace kernel and the bounce kernel for the JSON line. `cam_mean` is
    the clipped mean of the camera kernel's frame of phase 4, and
    `cam_mpaths` its rate."""
    import numpy as np
    import torch

    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import intersect as ti
    from software_rasterizer_tpu_torch.ops import path as tp
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import trace_kernel as tk
    from software_rasterizer_tpu_torch.ops import trace_tiers as tt
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.ops.shading import ShaderType
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils.rng import fold_in, key_bits
    from software_rasterizer_tpu_torch.utils.texture import Texture

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import textured_light_cornell

    n = WIDTH * HEIGHT
    scene = build_cornell_scene()
    scene.set_ndc_matrix(WIDTH, HEIGHT)
    rt = ti.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
    o, d = (x.contiguous() for x in camera_rays(
        rt.eye.cpu().numpy(), scene.fovy, WIDTH, HEIGHT, dev))
    allowed = (1.0 - LANE_SHARE) * n

    def nearest_hit_over_plain(o_, d_):
        """`nearest_hit` with the trace kernel's plain version under it."""
        kernel = tk.trace_nearest_vpu
        tk.trace_nearest_vpu = tk.trace_nearest_vpu_plain
        try:
            return ti.nearest_hit(rt, o_, d_)
        finally:
            tk.trace_nearest_vpu = kernel

    # ---- 15. trace kernel vs plain: camera rays, then bounce rays
    hit = ti.nearest_hit(rt, o, d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    w = torch.randn((n, 3), generator=gen, device=dev)
    w = w / torch.sqrt((w * w).sum(dim=1, keepdim=True))
    w = torch.where(((w * hit.normal).sum(dim=1) < 0)[:, None], -w, w)
    # lanes that missed start their second ray at the eye
    o2 = torch.where(hit.hit[:, None], hit.coords + 1e-6 * hit.normal, o).contiguous()
    d2 = torch.where(hit.hit[:, None], w, d).contiguous()
    trace_err, lines, work2 = 0.0, [], {}
    for name, (o_, d_) in {"camera": (o, d), "bounce": (o2, d2)}.items():
        k = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
        # the kernel's tally against its plain model (trace_tiers.nearest_tally_plain)
        tally = torch.zeros(tk.TALLY_ENTRIES, dtype=torch.int64, device=dev)
        k_t = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_, tally=tally)
        torch.cuda.synchronize()
        p = tk.trace_nearest_vpu_plain(rt.tri_table, rt.n_tri, o_, d_)
        if k[0].shape != (n,) or k[1].dtype != torch.int64 or k[2].dtype != torch.float32:
            fail(f"trace kernel outputs have the wrong shape or type on {name} rays")
        work2[name] = tuple(int(x) for x in tally.tolist())
        want = tt.nearest_tally_plain(rt.tri_table, rt.n_tri, o_, d_)
        if work2[name] != want or not all(torch.equal(a, b) for a, b in zip(k_t, k)):
            fail(f"#2 tally on {name} rays: {work2[name]}, plain model {want} "
                 f"({tk.TALLY_NAMES}), or its (hit, idx, t) differ from the launch without")
        bad = int(((k[0] != p[0]) | (k[1] != p[1]) | (k[2] != p[2])).sum())
        trace_err = max(trace_err, float((k[2] - p[2]).abs().max()))
        hk = ti.nearest_hit(rt, o_, d_)
        hp = nearest_hit_over_plain(o_, d_)
        off = torch.zeros(n, dtype=torch.bool, device=dev)
        fields = []
        for f, a, b in zip(hk._fields, hk, hp):
            differ = ~same_lanes(a, b)
            if bool(differ.any()):
                fields.append(f)
                off |= differ
        steps, voted = work2[name][:2]
        lines.append(f"{name} rays: {bad}/{n} differ in (hit, idx, t), "
                     f"{int(k[0].sum())} hit; nearest_hit fields differ on "
                     f"{int(off.sum())} rays" + (f" ({', '.join(fields)})" if fields else "")
                     + f"; tally = plain model, s {voted / steps:.4f} ({voted}/{steps} "
                     f"warp-steps voted), {work2[name][7]} of {work2[name][2]} tests pass "
                     f"stage 1")
        if bad > allowed or int(off.sum()) > allowed:
            fail(f"trace kernel disagrees with plain: {lines[-1]}")
    phase(15, f"trace kernel vs plain, {rt.n_tri} triangles: " + "; ".join(lines)
              + f"; max |t diff| {trace_err:.3g}")

    # ---- 16. bounce kernel vs plain on the whole frame's state
    state = tp.primary_state(hit).contiguous()
    live = hit.hit.contiguous()
    seed = int(key_bits(fold_in(fold_in(SEED, 0), 0)))   # sample 0, block 0
    bounce_err, lines = 0.0, []
    lane_bounces, plain_bounce_ms, per_lane = {}, {}, {}
    for nb in (1, MAX_BOUNCES):
        ka, ks, kl = pk.fused_bounce_group(rt, state, live, seed, nb, p_rr=scene.rr)
        torch.cuda.synchronize()
        work = {}
        t0 = time.perf_counter()
        pa, ps, pl = pk.fused_bounce_group_plain(rt, state, live, seed, nb,
                                                 p_rr=scene.rr, stats=work)
        torch.cuda.synchronize()
        plain_bounce_ms[nb] = (time.perf_counter() - t0) * 1e3
        lane_bounces[nb] = work["lane_bounces"]
        per_lane[nb] = work["per_lane"]
        if ka.shape != (3, n) or ks.shape != (18, n) or kl.shape != (n,) \
                or not bool(torch.isfinite(ka).all()):
            fail(f"bounce kernel outputs have the wrong shape or non-finite values")
        da = (ka - pa).abs()
        bounce_err = max(bounce_err, float(da.max()))
        acc_bad = int((da > LANE_ATOL + LANE_RTOL * pa.abs()).any(dim=0).sum())
        acc_any = int((ka != pa).any(dim=0).sum())
        live_bad = int((kl != pl).sum())
        ds = torch.nan_to_num((ks - ps).abs(), nan=0.0, posinf=0.0)
        state_bad = int(((ds > LANE_ATOL + LANE_RTOL * ps.abs())
                         & torch.isfinite(ps)).any(dim=0).sum())
        state_any = int((~same_lanes(ks.T, ps.T)).sum())
        lines.append(f"{nb} bounce(s): acc differs on {acc_bad}/{n} lanes "
                     f"(any bit: {acc_any}), live on {live_bad}, state on "
                     f"{state_bad} (any bit: {state_any}), {lane_bounces[nb]} "
                     f"lane-bounces, {int(kl.sum())} lanes live after, plain "
                     f"{plain_bounce_ms[nb]:.0f} ms")
        if max(acc_bad, live_bad, state_bad) > allowed:
            fail(f"bounce kernel disagrees with plain: {lines[-1]}")
    # the kernel's schedule, modelled: the live lists bounce by bounce in a
    # shuffled order, the staged sweep; bit for bit the plain version
    major = {}
    ma, ms_, ml = pk.bounce_major_plain(rt, state, live, seed, MAX_BOUNCES, p_rr=scene.rr,
                                        order_seed=SEED, stats=major)
    model_off = int((~same_lanes(torch.cat([ma, ms_, ml[None].float()]).T,
                                 torch.cat([pa, ps, pl[None].float()]).T)).sum())
    if model_off or major["slots"] != pk.loop_slots(per_lane[MAX_BOUNCES])[1]:
        fail(f"bounce_major_plain differs from the plain version on {model_off} lanes, or "
             f"its slots {major['slots']} from loop_slots'")
    phase(16, f"bounce kernel vs plain on {n} lanes (rtol={LANE_RTOL} "
              f"atol={LANE_ATOL}): " + "; ".join(lines)
              + f"; max_abs_err {bounce_err:.3g}; the bounce-major model "
              f"(bounce_major_plain, shuffled lists, staged sweep) == plain on all {n} "
              f"lanes at {MAX_BOUNCES} bounces, {major['slots']} lane-slots")

    # ---- 17. main path: explicit rays through path_render_accumulate
    kw = dict(p_rr=scene.rr, max_bounces=MAX_BOUNCES)

    def counts():
        return tk.LAUNCHES, pk.LAUNCHES_BOUNCE, pk.LAUNCHES

    def accumulate():
        return tp.path_render_accumulate(
            rt, o, d, SEED, torch.zeros((n, 3), dtype=torch.float32, device=dev),
            0, SPP, **kw)

    tk.LAUNCHES = pk.LAUNCHES_BOUNCE = pk.LAUNCHES = 0
    acc = accumulate()
    torch.cuda.synchronize()
    launches = counts()
    if launches != (SPP, SPP, 0):
        fail(f"expected {SPP} trace and {SPP} bounce launches and no camera-kernel "
             f"launch on the wavefront's main path, counted {launches}")
    img = acc / float(SPP)
    if img.shape != (n, 3) or img.device.type != dev.type \
            or not bool(torch.isfinite(img).all()):
        fail("path_render_accumulate's sum has the wrong shape, device or values")
    w_mean = float(torch.clamp(img, 0, 1).mean())
    rel = abs(w_mean - cam_mean) / cam_mean
    if rel > WAVE_MEAN_RTOL:
        fail(f"wavefront clipped mean {w_mean} vs the camera kernel's {cam_mean}")
    gscene = build_cornell_scene()
    gscene.set_ndc_matrix(48, 48)
    grt = ti.prepare_rt_scene(gscene.rt_geometry(), gscene.rt_frame(), dev)
    go, gd = (x.contiguous() for x in camera_rays(
        grt.eye.cpu().numpy(), gscene.fovy, 48, 48, dev))
    gacc = tp.path_render_accumulate(
        grt, go, gd, SEED, torch.zeros((48 * 48, 3), dtype=torch.float32, device=dev),
        0, 8, p_rr=gscene.rr)
    gmean = float(torch.clamp(gacc / 8.0, 0, 1).mean())
    want = float(np.load(ROOT / "tests" / "goldens" / "cornell_goldens.npz")["path_mean"])
    if not abs(gmean - want) < GOLDEN_TOL:
        fail(f"wavefront golden mean {gmean} vs path_mean {want}")
    phase(17, f"camera rays -> path_render_accumulate on {img.device}, {SPP} samples "
              f"of {n} lanes: launches trace {launches[0]} bounce {launches[1]} "
              f"camera kernel {launches[2]}, clipped mean {w_mean:.5f} vs the camera "
              f"kernel's {cam_mean:.5f} (rel {rel:.4f} < {WAVE_MEAN_RTOL}); golden "
              f"48x48 8 samples {gmean:.5f} vs {want:.5f} (< {GOLDEN_TOL})")

    # a textured light: PathTracing.draw() takes the wavefront by itself
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                       max_bounces=MAX_BOUNCES, seed=SEED)
    render = pipeline_from_config(cfg, "path")
    tscene = textured_light_cornell(build_cornell_scene, ShaderType, Texture)
    render.add_scene(tscene)
    tk.LAUNCHES = pk.LAUNCHES_BOUNCE = pk.LAUNCHES = 0
    render.draw()
    torch.cuda.synchronize()
    t_launches = counts()
    png = OUT_DIR / "chip_smoke_textured_light.png"
    render.save(str(png))
    frame = render.frame
    if render.device.type != dev.type or t_launches != (SPP, SPP, 0):
        fail(f"PathTracing.draw() of the textured light on {render.device}: "
             f"launches {t_launches}, expected ({SPP}, {SPP}, 0)")
    if frame.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(frame).all():
        fail("the textured-light frame has the wrong shape or non-finite values")
    trt = ti.prepare_rt_scene(tscene.rt_geometry(), tscene.rt_frame(), dev)
    if not trt.tex_on_emitter:
        fail("the textured-light scene does not report a textured emitter")
    th = ti.nearest_hit(trt, o, d)
    on_light = (th.hit & (torch.sqrt((th.emit * th.emit).sum(dim=1)) > 1e-5)
                ).reshape(HEIGHT, WIDTH).cpu().numpy()
    # every texel has a zero channel and the light's Kd is 0.65 grey; a
    # lane that stands on the light draws its next-event samples at
    # distances near zero, so some of its pixels carry a white firefly
    texel_share = float((frame[on_light].min(axis=1) < 0.2).mean())
    if on_light.sum() < n // 2000 or texel_share < 0.85:
        fail(f"{int(on_light.sum())} pixels see the light, {texel_share:.4f} of "
             f"them show a texel")
    # with one bounce a pixel on the light is its first term alone: all
    # of them must be a texel exactly
    one = pipeline_from_config(RenderConfig(
        width=WIDTH, height=HEIGHT, spp=1, max_bounces=1, seed=SEED), "path")
    one.add_scene(tscene)
    one.draw()
    texels = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    off_texel = np.abs(one.frame[on_light][:, None, :] - texels[None]
                       ).max(axis=2).min(axis=1)
    n_off = int((off_texel > 1e-6).sum())
    if n_off:
        fail(f"{n_off} of the light's {int(on_light.sum())} pixels are no texel "
             f"at one bounce (largest distance {float(off_texel.max())})")
    phase(17, f"pipeline_from_config(cfg, \"path\") on {render.device} -> "
              f"PathTracing.draw of Cornell with a textured light -> {png.name}: "
              f"launches trace {t_launches[0]} bounce {t_launches[1]} camera kernel "
              f"{t_launches[2]}, mean {frame.mean():.5f}, {int(on_light.sum())} "
              f"pixels on the light, {texel_share:.4f} of them a texel; at one bounce "
              f"{n_off} of them differ from a texel (tolerance 1e-6)")

    # the plain wavefront on the card, a quarter of the frame's lanes
    lo = n // 2 - PLAIN_WAVE_LANES // 2
    po, pd = o[lo:lo + PLAIN_WAVE_LANES], d[lo:lo + PLAIN_WAVE_LANES]
    t0 = time.perf_counter()
    plain_r, st = tp.path_trace(rt, po, pd, SEED, fused=False, with_stats=True, **kw)
    torch.cuda.synchronize()
    plain_wave_s = time.perf_counter() - t0
    fused_r = tp.path_trace(rt, po, pd, SEED, fused=True, **kw)
    pm = float(torch.clamp(plain_r, 0, 1).mean())
    fm = float(torch.clamp(fused_r, 0, 1).mean())
    if int(st["dropped_lanes"]) != 0 or abs(pm - fm) / fm > 0.05 \
            or not bool(torch.isfinite(plain_r).all()):
        fail(f"plain wavefront: dropped {int(st['dropped_lanes'])}, clipped mean "
             f"{pm} vs the fused route's {fm}")
    phase(17, f"path_trace(fused=False) on {PLAIN_WAVE_LANES} lanes of the card: "
              f"dropped_lanes 0, one sample's clipped mean {pm:.5f} vs the fused "
              f"route's {fm:.5f} (within 5%), {plain_wave_s:.2f}s")

    # ---- 18. times
    reps = 20
    attr, sph, n_sph = pk.pack_scene_tables(rt)
    tri = rt.tri_table.float().contiguous()
    ecr = rt.emitter_cr.float().contiguous()

    def bare_bounce(nb):
        return pk.launch_path_bounce(
            tri, attr, sph, ecr, state, live, n_tri=rt.n_tri, n_sph=n_sph,
            n_emitters=rt.n_emitters, seed=seed, n_bounces=nb, p_rr=scene.rr)

    t_trace_bare = cuda_times(lambda: tk.launch_trace_nearest(
        rt.tri_table, rt.n_tri, o, d), reps)
    t_trace_dev = device_times(lambda: tk.launch_trace_nearest(rt.tri_table, rt.n_tri, o, d))
    t_trace = cuda_times(lambda: tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o, d), reps)
    t_trace2 = cuda_times(lambda: tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o2, d2), reps)
    t_nh = cuda_times(lambda: ti.nearest_hit(rt, o, d), reps)
    t_state = cuda_times(lambda: tp.primary_state(hit), reps)
    t_bounce_bare = cuda_times(lambda: bare_bounce(MAX_BOUNCES), reps)
    t_bounce_bare1 = cuda_times(lambda: bare_bounce(1), reps)
    t_bounce_bare0 = cuda_times(lambda: bare_bounce(0), reps)
    t_bounce = cuda_times(lambda: pk.fused_bounce_group(
        rt, state, live, seed, MAX_BOUNCES, p_rr=scene.rr), reps)
    t_pt = cuda_times(lambda: tp.path_trace(rt, o, d, SEED, **kw), reps)
    t_acc = cuda_times(accumulate, 3)
    # the host's share: the time path_trace takes to queue its work
    queue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tp.path_trace(rt, o, d, SEED, **kw)
        queue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    queue.sort()
    t_trace_plain = cuda_times(lambda: tk.trace_nearest_vpu_plain(
        rt.tri_table, rt.n_tri, o, d), 3)
    med = statistics.median
    wave_mpaths = n * SPP / med(t_acc) / 1e3
    phase(18, f"wavefront {WIDTH}x{HEIGHT} = {n} rays, {rt.n_tri} triangles, ms as "
              f"median [min-max] of {reps} after a warm-up, on {card}: trace kernel "
              f"bare {spread(t_trace_bare)}, device-only {spread(t_trace_dev)} (a CUDA graph "
              f"of 20 launches), wrapper {spread(t_trace)} on camera rays "
              f"and {spread(t_trace2)} on bounce rays; nearest_hit whole "
              f"{spread(t_nh)}; state stack {spread(t_state)}; bounce kernel bare "
              f"{spread(t_bounce_bare)} at {MAX_BOUNCES} bounces, "
              f"{spread(t_bounce_bare1)} at 1 and {spread(t_bounce_bare0)} at 0 (the "
              f"launch, the list of live lanes, the dead lanes' copy), wrapper "
              f"{spread(t_bounce)}; path_trace "
              f"whole {spread(t_pt)}, of which the host queues for {spread(queue)} "
              f"(wall, 5); path_render_accumulate {SPP} samples {spread(t_acc)} (3) = "
              f"{wave_mpaths:.2f} Mpaths/s beside the camera kernel's "
              f"{cam_mpaths:.2f}; plain trace {spread(t_trace_plain)} (3), plain "
              f"bounce {plain_bounce_ms[MAX_BOUNCES]:.1f} at {MAX_BOUNCES} bounces and "
              f"{plain_bounce_ms[1]:.1f} at 1 (once each)")

    # bounds. Trace: ~58 float32 operations a ray and triangle; the table
    # and the rays read once, (hit, idx, t) written once. Bounce: a live
    # lane-bounce meets every primitive with two rays (~80 operations a
    # triangle, ~40 a sphere) and spends ~300 on sampling and shading;
    # the state read and written once, live and the (3,N) sum beside it.
    # Beside it the same with the bounce-major workspace's bytes, which the
    # function does not need but this design moves: a live lane's column
    # written to the first list and read back, each lane-bounce after the
    # first of a lane its 21 floats and column written by the bounce before
    # and read, and every lane's done row written and read back
    b_t, by_t = bound(tensor_bytes(rt.tri_table, o, d) + 13 * n,
                      58.0 * n * rt.n_tri)
    # the trace kernel from its own tally (the function's work: stage 1 of
    # every test, the whole test where the ray's own stage 1 passed), beside
    # every test whole above; its issue floor from the SASS of its row loop
    from software_rasterizer_tpu_torch.utils.cuda_build import library_path

    (b_tt, by_tt), (b_tw, by_tw) = vote_tally_bounds(
        tensor_bytes(rt.tri_table, o, d) + 13 * n, work2["camera"])
    floor2, loop2 = vote_floor(library_path("trace_nearest"), "trace_nearest_kernelILb1ELb0EE",
                               tk.NEAREST_RAYS, *work2["camera"][:2])
    n_live0 = int(live.sum())
    work_bytes = (2 * 4 * n_live0 + 2 * 4 * (pk.BOUNCE_SCRATCH_ROWS + 1) * (
        lane_bounces[MAX_BOUNCES] - n_live0) + 2 * 4 * pk.BOUNCE_DONE_ROWS * n)
    io_bytes = tensor_bytes(tri, attr, sph, ecr, live) + 2 * tensor_bytes(state) + 13 * n
    b_ops = lane_bounces[MAX_BOUNCES] * (80.0 * rt.n_tri + 40.0 * n_sph + 300.0)
    b_b, by_b = bound(io_bytes, b_ops)
    b_bw, by_bw = bound(io_bytes + work_bytes, b_ops)
    # the bounce kernel's loop from its own tally, against the models of
    # the per-lane loop it replaces and of its bounce-major schedule
    tally = torch.zeros(len(pk.TALLY_ENTRIES), dtype=torch.int64, device=dev)
    pk.launch_path_bounce(tri, attr, sph, ecr, state, live, n_tri=rt.n_tri, n_sph=n_sph,
                          n_emitters=rt.n_emitters, seed=seed, n_bounces=MAX_BOUNCES,
                          p_rr=scene.rr, tally=tally)
    torch.cuda.synchronize()
    static, major_slots = pk.loop_slots(per_lane[MAX_BOUNCES])
    b_simt, b_loop = loop_line("bounce", tally, lane_bounces[MAX_BOUNCES],
                               {"static per-lane loop": static, "bounce-major": major_slots})
    b_floor, b_sass = issue_floor("path_bounce", "path_bounce_major", rt.n_tri, int(tally[3]))
    # where the launch's time goes: its device clock after the first list
    # and after each bounce, beside the lanes each bounce ran
    clock = torch.zeros(MAX_BOUNCES + 3, dtype=torch.int64, device=dev)
    pk.launch_path_bounce(tri, attr, sph, ecr, state, live, n_tri=rt.n_tri, n_sph=n_sph,
                          n_emitters=rt.n_emitters, seed=seed, n_bounces=MAX_BOUNCES,
                          p_rr=scene.rr, timeline=clock)
    torch.cuda.synchronize()
    clock = clock.tolist()
    alive = [int((per_lane[MAX_BOUNCES] > b).sum()) for b in range(MAX_BOUNCES)]
    last = max(k for k in range(MAX_BOUNCES + 2) if clock[k] > 0)
    steps = ([f"first list {(clock[1] - clock[0]) / 1e3:.1f}"] + [
        f"b{b} {(clock[b + 2] - clock[b + 1]) / 1e3:.1f} ({alive[b]})"
        for b in range(MAX_BOUNCES) if clock[b + 2] > 0]
        + [f"copy-out {(clock[-1] - clock[last]) / 1e3:.1f}"])
    phase(18, f"bounds: trace from its tally {b_tt:.4f} ms by {by_tt} ({work2['camera'][2]} "
              f"tests, {work2['camera'][7]} of them passing stage 1), {b_tw:.4f} ms by "
              f"{by_tw} for its warps' work, {b_t:.4f} ms by {by_t} for every test whole, "
              f"issue floor {floor2:.4f} ms ({loop2['per_row'] / tk.NEAREST_RAYS:g} SASS "
              f"instructions a row and ray, {loop2['skip'] / tk.NEAREST_RAYS:g} of them skipped "
              f"by a failed vote, x {work2['camera'][0]} warp-steps, {work2['camera'][1]} "
              f"voted; device-only {med(t_trace_dev) / floor2:.2f}x the floor); "
              f"bounce {b_b:.4f} ms by {by_b} "
              f"({lane_bounces[MAX_BOUNCES]} lane-bounces of this frame; with the "
              f"workspace's {work_bytes / 1e6:.1f} MB {b_bw:.4f} ms by {by_bw}); {b_loop}; bounce "
              f"issue floor {b_floor:.4f} ms ({b_sass['per_row']:g} SASS instructions a row "
              f"and two rays, {b_sass['unroll']} rows a loop iteration: "
              + ", ".join(f"{o} {c:g}" for o, c in b_sass["mix"].items())
              + f"); bare launch {med(t_bounce_bare) / b_b:.2f}x the bound, "
              f"{med(t_bounce_bare) / b_floor:.2f}x the issue floor; the launch's device "
              f"clock, us (lanes of the bounce): " + ", ".join(steps))
    return [
        {"name": "trace_nearest", "route": "cuda",
         "source": "software_rasterizer_tpu_torch/csrc/trace_nearest.cu",
         "replaces": "software_rasterizer_tpu/ops/pallas_trace.py:431",
         "launches": launches[0], "max_abs_err": trace_err,
         "ms": med(t_trace), "bare_ms": med(t_trace_bare), "device_ms": med(t_trace_dev),
         "plain_ms": med(t_trace_plain), "bound_ms": b_tt, "bound_by": by_tt,
         "library_ms": None, "bound_ms_voted_warps": b_tw, "bound_ms_every_test": b_t,
         "issue_floor_ms": floor2,
         "sass_per_row_and_ray": loop2["per_row"] / tk.NEAREST_RAYS,
         "sass_skipped_per_row_and_ray": loop2["skip"] / tk.NEAREST_RAYS,
         "tally": {kind: dict(zip(tk.TALLY_NAMES, w)) for kind, w in work2.items()}},
        {"name": "path_bounce", "route": "cuda",
         "source": "software_rasterizer_tpu_torch/csrc/path_bounce.cu",
         "replaces": "software_rasterizer_tpu/ops/pallas_path.py:635",
         "launches": launches[1], "max_abs_err": bounce_err,
         "ms": med(t_bounce), "bare_ms": med(t_bounce_bare),
         "plain_ms": plain_bounce_ms[MAX_BOUNCES], "bound_ms": b_b,
         "bound_by": by_b, "library_ms": None,
         "ms_range": [t_bounce[0], t_bounce[-1]],
         "bare_ms_range": [t_bounce_bare[0], t_bounce_bare[-1]],
         "bare_ms_1": med(t_bounce_bare1), "bound_ms_with_workspace": b_bw,
         "simt_efficiency": b_simt,
         "issue_floor_ms": b_floor, "sass_per_row": b_sass["per_row"]},
    ]


def bounce_rays(rt, o, d):
    """Bounce rays from the hit points of the rays `o`, `d` on the scene `rt`,
    as phase 15 makes them: a direction from a seeded generator turned into
    the hemisphere of the hit's normal, the origin nudged off the surface; a
    ray that misses keeps its camera ray. Returns (the hits, o2, d2)."""
    import torch

    from software_rasterizer_tpu_torch.ops import intersect as ti

    hit = ti.nearest_hit(rt, o, d, backend="vpu")
    gen = torch.Generator(device=o.device)
    gen.manual_seed(SEED)
    w = torch.randn((o.shape[0], 3), generator=gen, device=o.device)
    w = w / torch.sqrt((w * w).sum(dim=1, keepdim=True))
    w = torch.where(((w * hit.normal).sum(dim=1) < 0)[:, None], -w, w)
    o2 = torch.where(hit.hit[:, None], hit.coords + 1e-6 * hit.normal, o).contiguous()
    d2 = torch.where(hit.hit[:, None], w, d).contiguous()
    return hit, o2, d2


# float32 operations of stage 1 of the two-stage test (csrc/trace_culled.cu
# mt_stage1): p 9, det 5, the |det| test and its select 2, the division 1,
# tvec 3, u 6, u's two compares 2
STAGE1_OPS = 28.0


def vote_tally_bounds(table_bytes, work):
    """Two bounds from a two-stage kernel's tally (trace_tiers.TALLY_NAMES),
    each (ms, bound_by): the function's own work (every test's stage 1 at
    STAGE1_OPS, the ~58 operations of a whole test only where the ray's own
    stage 1 passed, slab tests at ~21), and the work of the kernel's warps
    (~58 for every test of a voted warp-step)."""
    tests, full, slabs, passes = work[2], work[3], work[4], work[7]
    return (bound(table_bytes, STAGE1_OPS * (tests - passes) + 58.0 * passes + 21.0 * slabs),
            bound(table_bytes, STAGE1_OPS * (tests - full) + 58.0 * full + 21.0 * slabs))


def vote_floor(lib_path, kernel: str, rays: int, steps: int, voted: int):
    """The issue floor of a row loop from its SASS (utils/sass.py): the
    instructions of a warp-step (a row against one ray slot of every lane
    of a warp) x the warp-steps, less the instructions a failed warp vote
    skips x the steps whose vote failed (none in a loop without a vote),
    over every scheduler of the card issuing one warp-instruction a cycle at
    the highest SM clock. Returns (ms, the loop's count)."""
    import torch

    from software_rasterizer_tpu_torch.utils import sass

    loop = sass.row_loop(sass.kernel_sass(lib_path, kernel), rays)
    per, skip = loop["per_row"] / rays, loop["skip"] / rays
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SCHEDULERS_PER_SM * max_sm_clock_hz()
    return (per * steps - skip * (steps - voted)) / rate * 1e3, loop


def large_scene_phases(dev, card: str):
    """Phases 20-24: nearest hits of explicit rays on large scenes, the
    Cornell box tessellated to 9,216 and to 147,456 triangles. Returns
    the entries of the four chunk-culled kernels for the JSON line, and
    the scenes with their rays for phases 25-29."""
    import torch

    from software_rasterizer_tpu_torch.ops import intersect as ti
    from software_rasterizer_tpu_torch.ops import trace_kernel as tk
    from software_rasterizer_tpu_torch.ops import trace_tiers as tt
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import slab_knife_edge_rays, stress_cornell

    n = WIDTH * HEIGHT
    block = tt.DEFAULT_BLOCK
    med = statistics.median

    # ---- 20. scenes, tables and rays
    scenes, lines = {}, []
    for name, levels in (("mid", LARGE_LEVELS[0]), ("large", LARGE_LEVELS[1])):
        t0 = time.perf_counter()
        scene = stress_cornell(build_cornell_scene, subdivide_mesh, levels)
        scene.set_ndc_matrix(WIDTH, HEIGHT)
        rt = ti.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        f_pad = rt.v0.shape[0]
        if rt.chunk_lo.shape != (-(-f_pad // rt.cull_chunk), 3) \
                or rt.cull_chunk != ti._cull_granule(f_pad):
            fail(f"{name}: chunk tables {tuple(rt.chunk_lo.shape)} at granule "
                 f"{rt.cull_chunk} for {f_pad} rows")
        o, d = (x.contiguous() for x in camera_rays(
            rt.eye.cpu().numpy(), scene.fovy, WIDTH, HEIGHT, dev))
        hit, o2, d2 = bounce_rays(rt, o, d)
        scenes[name] = dict(scene=scene, rt=rt, rays={"camera": (o, d), "bounce": (o2, d2)},
                            backend=ti._trace_backend(f_pad))
        lines.append(f"{name}: {rt.n_tri} triangles ({f_pad} rows), nc {rt.chunk_lo.shape[0]} "
                     f"at granule {rt.cull_chunk}, tier {scenes[name]['backend']}, "
                     f"{int(hit.hit.sum())}/{n} camera rays hit, host {host_s:.2f}s "
                     f"(native BVH build and OBJ scan)")
    if scenes["mid"]["backend"] != "mm2c" or scenes["large"]["backend"] != "mm2s":
        fail(f"tiers by triangle count: {lines}")
    phase(20, "stress_cornell -> prepare_rt_scene on the card, 1,048,576 camera rays "
              "and as many bounce rays: " + "; ".join(lines))

    # ---- 21. the cull prepass against its plain version, and its tally
    # against its plain model (trace_tiers.cull_prepass_warp_plain)
    lines, cull_bad, cull_plain_ms, masks, work5 = [], 0, {}, {}, {}
    for name, sc in scenes.items():
        rt = sc["rt"]
        for kind, (o_, d_) in sc["rays"].items():
            k = tt.cull_prepass(rt.chunk_lo, rt.chunk_hi, o_, d_, block)
            tally = torch.zeros(tt.CULL_TALLY_ENTRIES, dtype=torch.int64, device=dev)
            k_t = tt.launch_cull_prepass(rt.chunk_lo, rt.chunk_hi, o_, d_, block, tally=tally)
            torch.cuda.synchronize()
            p_, cull_plain_ms[name, kind] = wall_ms(lambda: tt.cull_prepass_plain(
                rt.chunk_lo, rt.chunk_hi, o_, d_, block))
            if k.shape != (-(-n // block), rt.chunk_lo.shape[0]) or k.dtype != torch.uint8:
                fail(f"cull mask has shape {tuple(k.shape)} and type {k.dtype}")
            bad = int((k != p_).sum()) + int((k_t != p_).sum())
            cull_bad += bad
            masks[name, kind] = k
            m_, want = tt.cull_prepass_warp_plain(rt.chunk_lo, rt.chunk_hi, o_, d_, block)
            work = work5[name, kind] = tuple(int(x) for x in tally.tolist())
            if work != want or not torch.equal(m_, p_):
                fail(f"#5 tally on {name} {kind} rays: {work}, plain model {want} "
                     f"({tt.CULL_TALLY_NAMES}); model mask off the plain one in "
                     f"{int((m_ != p_).sum())} entries")
            w = dict(zip(tt.CULL_TALLY_NAMES, work))
            proven = w["warp_supers"] - w["warp_supers_unproven"]
            lines.append(f"{name} {kind}: {bad}/{k.numel()} mask entries differ, "
                         f"{float(k.float().mean()):.4f} of the (block, chunk) pairs "
                         f"survive, {(proven - w['warp_supers_skipped']) / proven:.4f} of the "
                         f"proven (warp, super) pairs ({proven - w['warp_supers_skipped']}/"
                         f"{proven}), {w['warp_supers_unproven']} taken child by child, "
                         f"{(w['super_tests'] + w['chunk_tests']) / n:.2f} slab tests a ray "
                         f"(flat {rt.chunk_lo.shape[0]}); tally = plain model; plain "
                         f"{cull_plain_ms[name, kind]:.0f} ms")
    if cull_bad:
        fail("cull prepass kernel disagrees with plain: " + "; ".join(lines))
    phase(21, f"cull prepass kernel (#5) vs plain, blocks of {block} rays: " + "; ".join(lines))

    # ---- 21 (cont.): the streamed kernel's work (#6) on the masks' lists: its
    # tally against the plain model (trace_tiers.listed_warp_plain), the whole
    # frame or, where the model would take minutes, three windows of rays
    def listed_tally(rt, o_, d_, counts_, lists_):
        tally = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64, device=dev)
        k = tt.launch_trace_listed(rt.tri_table, counts_, lists_, o_, d_, rt.cull_chunk,
                                   block, stream=True, chunk_lo=rt.chunk_lo,
                                   chunk_hi=rt.chunk_hi, tally=tally)
        return k, tuple(int(x) for x in tally.tolist())

    lines, work6 = [], {}
    for name, sc in scenes.items():
        rt = sc["rt"]
        for kind, (o_, d_) in sc["rays"].items():
            mask = masks[name, kind]
            k, work = listed_tally(rt, o_, d_, *tt.chunk_lists(mask))
            work6[name, kind] = work
            whole = float(mask.sum()) * rt.cull_chunk * block <= PLAIN_TESTS_LIMIT
            starts = [0] if whole else [0, n // 2, n - LARGE_WINDOW]
            bad = 0
            for s0 in starts:
                s1 = n if whole else s0 + LARGE_WINDOW
                c_, l_ = tt.chunk_lists(mask[s0 // block:-(-s1 // block)])
                kw_, work_w = (k, work) if whole else listed_tally(
                    rt, o_[s0:s1], d_[s0:s1], c_, l_)
                p_, want = tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi,
                                                c_, l_, o_[s0:s1], d_[s0:s1],
                                                rt.cull_chunk, block)
                if work_w != want:
                    fail(f"#6 tally on {name} {kind} rays [{s0}, {s1}): {work_w}, plain "
                         f"model {want} ({tt.TALLY_NAMES})")
                bad += int(((kw_[0] != p_[0]) | (kw_[1] != p_[1]) | (kw_[2] != p_[2])).sum())
            if bad:
                fail(f"#6 on {name} {kind} rays: {bad} rays differ from its plain model")
            steps, voted, tests, full, slabs, pairs, skipped, passes = work
            how = "whole frame" if whole else f"{len(starts)} windows of {LARGE_WINDOW} rays"
            lines.append(f"{name} {kind}: s {voted / steps:.4f} ({voted}/{steps} warp-steps "
                         f"voted), w {skipped / pairs:.4f} ({skipped}/{pairs} (warp, listed "
                         f"chunk) pairs skipped), {full}/{tests} full tests, {passes} "
                         f"passing stage 1, {slabs} slab tests; tally = plain model ({how})")
    phase(21, "the streamed kernel (#6) on the masks' lists, its tally against its plain "
              "model: " + "; ".join(lines))

    # ---- 22. every tier against kernel #2 over the whole table, and
    # against its own plain version
    def tier_calls(rt):
        a = (rt.tri_table, rt.chunk_lo, rt.chunk_hi)
        kw = dict(chunk=rt.cull_chunk, block=block)
        return {
            "mm2c": (lambda o_, d_: tt.trace_nearest_mm2c(*a, o_, d_, **kw),
                     lambda o_, d_: tt.trace_nearest_mm2c_plain(*a, o_, d_, **kw)),
            "mm2": (lambda o_, d_: tt.trace_nearest_mm2(*a, o_, d_, **kw),
                    lambda o_, d_: plain_listed(rt, o_, d_, True)),
            "mm2 cull=False": (
                lambda o_, d_: tt.trace_nearest_mm2(*a, o_, d_, cull=False, **kw),
                lambda o_, d_: plain_listed(rt, o_, d_, False)),
            "mm2s": (lambda o_, d_: tt.trace_nearest_mm2_stream(*a, o_, d_, **kw),
                     lambda o_, d_: plain_listed(rt, o_, d_, True)),
        }

    def plain_listed(rt, o_, d_, cull):
        """The plain version of both listed kernels."""
        nb = -(-o_.shape[0] // block)
        if cull:
            counts, lists = tt.chunk_lists(tt.cull_prepass_plain(
                rt.chunk_lo, rt.chunk_hi, o_, d_, block))
        else:
            counts, lists = tt._all_chunks(nb, rt.chunk_lo.shape[0], dev)
        return tt.trace_listed_plain(rt.tri_table, counts, lists, o_, d_,
                                     rt.cull_chunk, block)

    def differing(a, b):
        return (a[0] != b[0]) | (a[1] != b[1]) | (a[2] != b[2])

    tier_err = {"mm2c": 0.0, "mm2": 0.0, "mm2s": 0.0}
    tier_plain_ms, explained, lines = {}, {}, []
    for name, sc in scenes.items():
        rt = sc["rt"]
        calls = tier_calls(rt)
        if name == "large":
            del calls["mm2 cull=False"]   # 1.5e11 tests in the plain version
        for kind, (o_, d_) in sc["rays"].items():
            ref = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
            knife = torch.zeros(n, dtype=torch.bool, device=dev)
            for tier, (kernel, plain) in calls.items():
                k = kernel(o_, d_)
                torch.cuda.synchronize()
                if k[0].shape != (n,) or k[0].dtype != torch.bool \
                        or k[1].dtype != torch.int64 or k[2].dtype != torch.float32:
                    fail(f"{tier} outputs have the wrong shape or type")
                off = differing(k, ref)
                n_off = int(off.sum())
                if n_off:
                    # a differing ray must be a proven knife edge of the slab
                    # test of the box that holds kernel #2's winner
                    r = torch.nonzero(off).flatten()
                    proof = slab_knife_edge_rays(
                        rt.chunk_lo.cpu().numpy(), rt.chunk_hi.cpu().numpy(),
                        rt.cull_chunk, o_[r].cpu().numpy(), d_[r].cpu().numpy(),
                        ref[1][r].cpu().numpy())
                    print(f"[phase 22] {name} {kind} {tier}: {n_off} rays differ from "
                          f"kernel #2, {int(proof.sum())} of them proven slab knife "
                          f"edges; first rays {r[:8].tolist()}", flush=True)
                    if not proof.all():
                        fail(f"{tier} on {name} {kind} rays: {int((~proof).sum())} rays "
                             f"differ from kernel #2 and are no knife edge")
                    knife |= off
                # the kernel against its own plain version: the whole frame,
                # or three windows where the plain version would take minutes
                pairs = n // block * rt.chunk_lo.shape[0] if "False" in tier \
                    else int(masks[name, kind].sum())
                whole = float(pairs) * rt.cull_chunk * block <= PLAIN_TESTS_LIMIT
                starts = [0] if whole else [0, n // 2, n - LARGE_WINDOW]
                bad, ms = 0, 0.0
                for s0 in starts:
                    s1 = n if whole else s0 + LARGE_WINDOW
                    kw_ = k if whole else kernel(o_[s0:s1], d_[s0:s1])
                    p_, ms_w = wall_ms(lambda: plain(o_[s0:s1], d_[s0:s1]))
                    ms += ms_w
                    bad += int(differing(kw_, p_).sum())
                    bad += int(differing(kw_, tuple(x[s0:s1] for x in k)).sum())
                    key = tier.split()[0]
                    tier_err[key] = max(tier_err[key],
                                        float((kw_[2] - p_[2]).abs().max()))
                how = "whole frame" if whole else \
                    f"{len(starts)} windows of {LARGE_WINDOW} rays at {starts}"
                tier_plain_ms[name, kind, tier] = ms
                lines.append(f"{name} {kind} {tier}: {n_off}/{n} rays differ from kernel "
                             f"#2, {bad} from its plain version ({how}, {ms:.0f} ms)")
                if bad:
                    fail(f"{tier} disagrees with its plain version: {lines[-1]}")
            explained[name, kind] = knife
    # the ray block's size changes no result: every thread shape of the kernels
    rt = scenes["mid"]["rt"]
    for kind, (o_, d_) in scenes["mid"]["rays"].items():
        ref = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
        a = (rt.tri_table, rt.chunk_lo, rt.chunk_hi, o_, d_)
        for b in BLOCK_SIZES:
            for tier, fn in (("mm2c", tt.trace_nearest_mm2c), ("mm2", tt.trace_nearest_mm2),
                             ("mm2s", tt.trace_nearest_mm2_stream)):
                off = differing(fn(*a, chunk=rt.cull_chunk, block=b), ref)
                if bool((off & ~explained["mid", kind]).any()):
                    fail(f"{tier} at block={b} on {kind} rays: {int(off.sum())} rays differ "
                         f"from kernel #2")
    phase(22, f"tiers vs kernel #2 over the whole table and vs their plain versions, "
              f"(hit, idx, t) bit for bit, blocks of {block} rays: " + "; ".join(lines)
              + f"; blocks of {BLOCK_SIZES} rays give the same on the mid scene's camera "
              f"and bounce rays")

    # the fused cull's work (#4): its tally on the whole frame, and on three
    # windows of rays against its plain model (trace_tiers.fused_warp_plain),
    # whose (hit, idx, t) the kernel's must equal too
    rt = scenes["mid"]["rt"]
    lo2, hi2 = tt.super_bounds(rt.chunk_lo, rt.chunk_hi)
    work4, lines = {}, []

    def fused_tally(o_, d_):
        tally = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64, device=dev)
        k = tt.launch_trace_fused_cull(rt.tri_table, rt.chunk_lo, rt.chunk_hi, lo2, hi2,
                                       o_, d_, rt.cull_chunk, block, tally=tally)
        return k, tuple(int(x) for x in tally.tolist())

    for kind, (o_, d_) in scenes["mid"]["rays"].items():
        _, work4[kind] = fused_tally(o_, d_)
        for s0 in (0, n // 2, n - LARGE_WINDOW):
            ow, dw = o_[s0:s0 + LARGE_WINDOW], d_[s0:s0 + LARGE_WINDOW]
            k, work_w = fused_tally(ow, dw)
            p_, want = tt.fused_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, ow, dw,
                                           rt.cull_chunk, block)
            if work_w != want or bool(differing(k, p_).any()):
                fail(f"#4 on mid {kind} rays [{s0}, {s0 + LARGE_WINDOW}): tally {work_w}, "
                     f"plain model {want} ({tt.TALLY_NAMES}); "
                     f"{int(differing(k, p_).sum())} rays differ from the model")
        steps, voted, tests, full, slabs, pairs, skipped, passes = work4[kind]
        lines.append(f"mid {kind}: s {voted / steps:.4f} ({voted}/{steps} warp-steps voted), "
                     f"w {skipped / pairs:.4f} ({skipped}/{pairs} (warp, chunk) votes "
                     f"skipped), {full}/{tests} full tests, {passes} passing stage 1, {slabs} "
                     f"slab tests")
    phase(22, "the fused cull (#4), its tally over the whole frame; tally and (hit, idx, t) "
              f"= its plain model on 3 windows of {LARGE_WINDOW} rays: " + "; ".join(lines))

    # the listed kernel's work (#7) on the mid scene's prepass lists: its
    # tally and (hit, idx, t) against its plain model
    # (trace_tiers.listed_warp_plain(vote=False)), the whole frame or, where
    # the model would take minutes, three windows of rays
    work7, lines = {}, []

    def listed_all_tally(o_, d_, counts_, lists_):
        tally = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64, device=dev)
        k = tt.launch_trace_listed(rt.tri_table, counts_, lists_, o_, d_, rt.cull_chunk, block,
                                   tally=tally)
        return k, tuple(int(x) for x in tally.tolist())

    for kind, (o_, d_) in scenes["mid"]["rays"].items():
        mask = masks["mid", kind]
        k, work7[kind] = listed_all_tally(o_, d_, *tt.chunk_lists(mask))
        whole = float(mask.sum()) * rt.cull_chunk * block <= PLAIN_TESTS_LIMIT
        starts = [0] if whole else [0, n // 2, n - LARGE_WINDOW]
        for s0 in starts:
            s1 = n if whole else s0 + LARGE_WINDOW
            c_, l_ = tt.chunk_lists(mask[s0 // block:-(-s1 // block)])
            kw_, work_w = (k, work7[kind]) if whole else listed_all_tally(
                o_[s0:s1], d_[s0:s1], c_, l_)
            p_, want = tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, c_, l_,
                                            o_[s0:s1], d_[s0:s1], rt.cull_chunk, block,
                                            vote=False)
            if work_w != want or bool(differing(kw_, p_).any()):
                fail(f"#7 on mid {kind} rays [{s0}, {s1}): tally {work_w}, plain model "
                     f"{want} ({tt.TALLY_NAMES}); {int(differing(kw_, p_).sum())} rays "
                     f"differ from the model")
        steps, voted, tests, full, _, _, _, passes = work7[kind]
        how = "whole frame" if whole else f"{len(starts)} windows of {LARGE_WINDOW} rays"
        lines.append(f"mid {kind}: s {voted / steps:.4f} ({voted}/{steps} warp-steps voted), "
                     f"{full}/{tests} full tests, {passes} passing stage 1; tally and (hit, "
                     f"idx, t) = plain model ({how})")
    phase(22, "the listed kernel (#7) on the masks' lists, its tally against its plain model: "
              + "; ".join(lines))

    # ---- 23. the path: nearest_hit and its relatives pick the tier
    want = {"mid": (3, 0, 0, 0), "large": (0, 3, 0, 3)}
    lines = []
    launches = [0, 0, 0, 0]

    def counts():
        return (tt.LAUNCHES_MM2C, tt.LAUNCHES_CULL, tt.LAUNCHES_MM2, tt.LAUNCHES_MM2S)

    def same_fields(a, b, skip):
        off = torch.zeros(n, dtype=torch.bool, device=dev)
        for x, y in zip(a, b):
            off |= ~same_lanes(x, y)
        return int((off & ~skip).sum())

    for name, sc in scenes.items():
        rt = sc["rt"]
        o_, d_ = sc["rays"]["camera"]
        o2, d2 = sc["rays"]["bounce"]
        refs = (ti.nearest_hit(rt, o_, d_, backend="vpu"),
                ti.nearest_emit_hit(rt, o2, d2, backend="vpu"),
                ti.classify_hit(rt, o_, d_, backend="vpu"))
        tt.LAUNCHES_MM2C = tt.LAUNCHES_CULL = tt.LAUNCHES_MM2 = tt.LAUNCHES_MM2S = 0
        vpu_before = tk.LAUNCHES
        got = [ti.nearest_hit(rt, o_, d_)]
        first = counts()
        got += [ti.nearest_emit_hit(rt, o2, d2), ti.classify_hit(rt, o_, d_)]
        torch.cuda.synchronize()
        after = counts()
        if first != tuple(c // 3 for c in want[name]) or after != want[name] \
                or tk.LAUNCHES != vpu_before:
            fail(f"{name}: launches (mm2c, cull, mm2, mm2s) {first} after nearest_hit, "
                 f"{after} after all three, expected {want[name]}; kernel #2 "
                 f"{tk.LAUNCHES - vpu_before}")
        if name == "mid":
            # the list-driven tier, taken by name
            got.append(ti.nearest_hit(rt, o_, d_, backend="mm2"))
            refs += (refs[0],)
            after = counts()
            if after != (3, 1, 1, 0):
                fail(f"nearest_hit(backend='mm2') launched {after}")
        launches = [x + y for x, y in zip(launches, after)]
        skips = (explained[name, "camera"], explained[name, "bounce"],
                 explained[name, "camera"], explained[name, "camera"])
        bad = [same_fields(g, r, s) for g, r, s in zip(got, refs, skips)]
        if got[0].hit.shape != (n,) or not bool(torch.isfinite(got[0].coords).all()):
            fail(f"{name}: nearest_hit's record has the wrong shape or values")
        lines.append(f"{name}: nearest_hit / nearest_emit_hit / classify_hit launch "
                     f"(mm2c, cull, mm2, mm2s) = {want[name]}, kernel #2 0; lanes that "
                     f"differ from backend='vpu' in any of their "
                     f"{len(got[0]._fields)} / {len(got[1]._fields)} / "
                     f"{len(got[2]._fields)} fields: {bad[:3]}"
                     + (f"; backend='mm2': {bad[3]}" if name == "mid" else ""))
        if any(bad):
            fail(f"the tiers' records differ from backend='vpu': {lines[-1]}")
    phase(23, "nearest_hit(rt, orig, d) with no backend on the default device: "
              + "; ".join(lines))

    # ---- 24. times
    reps = 20
    times, entries_ms = [], {}
    for name, sc in scenes.items():
        rt = sc["rt"]
        o_, d_ = sc["rays"]["camera"]
        a = (rt.tri_table, rt.chunk_lo, rt.chunk_hi)
        kw = dict(chunk=rt.cull_chunk, block=block)
        lo2, hi2 = tt.super_bounds(rt.chunk_lo, rt.chunk_hi)
        mask = masks[name, "camera"]
        counts_, lists_ = tt.chunk_lists(mask)
        o2, d2 = sc["rays"]["bounce"]
        t = {
            "mm2c bare": cuda_times(lambda: tt.launch_trace_fused_cull(
                *a, lo2, hi2, o_, d_, **kw), reps),
            "mm2c bare bounce": cuda_times(lambda: tt.launch_trace_fused_cull(
                *a, lo2, hi2, o2, d2, **kw), reps),
            "mm2c": cuda_times(lambda: tt.trace_nearest_mm2c(*a, o_, d_, **kw), reps),
            "cull": cuda_times(lambda: tt.cull_prepass(
                rt.chunk_lo, rt.chunk_hi, o_, d_, block), reps),
            "cull bare": cuda_times(lambda: tt.launch_cull_prepass(
                rt.chunk_lo, rt.chunk_hi, o_, d_, block, supers=(lo2, hi2)), reps),
            "cull bare bounce": cuda_times(lambda: tt.launch_cull_prepass(
                rt.chunk_lo, rt.chunk_hi, o2, d2, block, supers=(lo2, hi2)), reps),
            "lists": cuda_times(lambda: tt.chunk_lists(mask), reps),
            "mm2 bare": cuda_times(lambda: tt.launch_trace_listed(
                rt.tri_table, counts_, lists_, o_, d_, **kw), reps),
            "mm2 device-only": device_times(lambda: tt.launch_trace_listed(
                rt.tri_table, counts_, lists_, o_, d_, **kw)),
            "mm2": cuda_times(lambda: tt.trace_nearest_mm2(*a, o_, d_, **kw), reps),
            "mm2s bare": cuda_times(lambda: tt.launch_trace_listed(
                rt.tri_table, counts_, lists_, o_, d_, stream=True, chunk_lo=rt.chunk_lo,
                chunk_hi=rt.chunk_hi, **kw), reps),
            "mm2s": cuda_times(lambda: tt.trace_nearest_mm2_stream(*a, o_, d_, **kw), reps),
            "nearest_hit": cuda_times(lambda: ti.nearest_hit(rt, o_, d_), reps),
            "kernel #2": cuda_times(lambda: tk.trace_nearest_vpu(
                rt.tri_table, rt.n_tri, o_, d_), 3),
        }
        if name == "mid":
            t["mm2 cull=False"] = cuda_times(lambda: tt.trace_nearest_mm2(
                *a, o_, d_, cull=False, **kw), 3)
        tier = {"mid": tt.trace_nearest_mm2c, "large": tt.trace_nearest_mm2_stream}[name]
        for b in BLOCK_SIZES:
            t[f"{sc['backend']} block={b}"] = cuda_times(lambda: tier(
                *a, o_, d_, chunk=rt.cull_chunk, block=b), reps)
        entries_ms[name] = t
        times.append(f"{name} ({rt.n_tri} triangles, chunks of {rt.cull_chunk}): "
                     + ", ".join(f"{k} {spread(v)}" for k, v in t.items()))
    phase(24, f"large-scene rays, {n} camera rays, blocks of {block} rays unless said, "
              f"ms as median [min-max] of {reps} after a warm-up (kernel #2 and "
              f"cull=False of 3; device-only: a CUDA graph of 20 launches, 5 replays) on "
              f"{card}: " + "; ".join(times))

    # bounds, from this run's own masks: a listed (block, chunk) pair is
    # chunk x block tests of ~58 float32 operations, a slab test ~21; the
    # rays read and (hit, idx, t) written once, the table, boxes, lists
    def tier_bound(name, listed_bytes, slab_tests):
        rt = scenes[name]["rt"]
        o_, d_ = scenes[name]["rays"]["camera"]
        pairs = int(masks[name, "camera"].sum())
        tests = float(pairs) * rt.cull_chunk * block
        return bound(tensor_bytes(rt.tri_table, rt.chunk_lo, rt.chunk_hi, o_, d_)
                     + 13 * n + listed_bytes, 58.0 * tests + 21.0 * slab_tests), tests

    mid, large = scenes["mid"]["rt"], scenes["large"]["rt"]
    nb = -(-n // block)
    # the fused cull's slab tests: every super-chunk, and the chunks of
    # those a block enters
    lo2, hi2 = tt.super_bounds(mid.chunk_lo, mid.chunk_hi)
    supers = int(tt.cull_prepass(lo2, hi2, *scenes["mid"]["rays"]["camera"], block).sum())
    (b4, by4), tests4 = tier_bound(
        "mid", 0, float(block) * (nb * lo2.shape[0] + supers * tt.MM2C_SUPER))
    (b7, by7), _ = tier_bound("mid", 4 * nb * (1 + mid.chunk_lo.shape[0]), 0.0)
    (b6, by6), tests6 = tier_bound("large", 4 * nb * (1 + large.chunk_lo.shape[0]), 0.0)
    o_, d_ = scenes["large"]["rays"]["camera"]
    bytes5 = tensor_bytes(large.chunk_lo, large.chunk_hi, o_, d_, masks["large", "camera"])
    b5, by5 = bound(bytes5, 21.0 * n * large.chunk_lo.shape[0])
    # #5 from its own tally: the slab tests it made (the function's work, its
    # super-chunk skip proven exact), beside every ray x every chunk box
    # above; its issue floor from the SASS of its box loop (utils/sass.py
    # box_loop) x its warp votes on super and chunk boxes
    from software_rasterizer_tpu_torch.utils import sass
    from software_rasterizer_tpu_torch.utils.cuda_build import library_path

    w5 = dict(zip(tt.CULL_TALLY_NAMES, work5["large", "camera"]))
    b5t, by5t = bound(bytes5 + tensor_bytes(*tt.super_bounds(large.chunk_lo, large.chunk_hi)),
                      21.0 * (w5["super_tests"] + w5["chunk_tests"]))
    _, rays5 = tt.launch_shape(block)
    loop5 = sass.box_loop(sass.kernel_sass(library_path("trace_culled"),
                                           f"cull_prepass_kernelILi{rays5}ELb0E"), rays5)
    votes5 = w5["warp_supers"] - w5["warp_supers_unproven"] + w5["warp_chunk_votes"]
    floor5 = loop5["per_vote"] * votes5 / (
        torch.cuda.get_device_properties(0).multi_processor_count * SCHEDULERS_PER_SM
        * max_sm_clock_hz()) * 1e3
    # #4 from its own tally, as #6; its floor from its row loop
    w4 = work4["camera"]
    o4, d4 = scenes["mid"]["rays"]["camera"]
    (b4t, by4t), (b4w, by4w) = vote_tally_bounds(
        tensor_bytes(mid.tri_table, mid.chunk_lo, mid.chunk_hi, lo2, hi2, o4, d4) + 13 * n, w4)
    floor4, loop4 = vote_floor(library_path("trace_culled"),
                               f"trace_fused_cull_kernelILi{rays5}ELb0E", rays5, w4[0], w4[1])
    # #6 from its own tally: stage-1-only and full tests and slab tests; its
    # issue floor from the SASS of its row loop and the tally's warp-steps

    w6 = work6["large", "camera"]
    (b6f, by6f), (b6w, by6w) = vote_tally_bounds(
        tensor_bytes(large.tri_table, large.chunk_lo, large.chunk_hi, o_, d_) + 13 * n
        + 4 * nb * (1 + large.chunk_lo.shape[0]), w6)
    _, rays6 = tt.launch_shape(block)
    floor6, loop6 = vote_floor(library_path("trace_culled"),
                               f"trace_listed_stream_kernelILi{rays6}ELb0E", rays6, w6[0], w6[1])
    # #7 from its own tally, as #6 (no slab tests); its floor from its row loop
    w7 = work7["camera"]
    (b7f, by7f), (b7w, by7w) = vote_tally_bounds(
        tensor_bytes(mid.tri_table, o4, d4) + 13 * n + 4 * nb * (1 + mid.chunk_lo.shape[0]), w7)
    floor7, loop7 = vote_floor(library_path("trace_culled"),
                               f"trace_listed_all_kernelILi{rays6}ELb0E", rays6, w7[0], w7[1])
    phase(24, f"bounds: mm2c (mid) from its tally {b4t:.4f} ms by {by4t} ({w4[2]} tests, "
              f"{w4[7]} of them passing stage 1, {w4[4]} slab tests), {b4w:.4f} ms by {by4w} "
              f"for its warps' work, {b4:.4f} ms by {by4} for every test of the block vote "
              f"({tests4:.3g} tests), issue floor {floor4:.4f} ms ({loop4['per_row'] / rays5:g} "
              f"SASS instructions a row and ray, {loop4['skip'] / rays5:g} of them skipped by a "
              f"failed vote, x {w4[0]} warp-steps, {w4[1]} voted); cull prepass (large) from "
              f"its tally {b5t:.4f} ms by {by5t} ({w5['super_tests']} + {w5['chunk_tests']} "
              f"slab tests on super and chunk boxes), {b5:.4f} ms by {by5} for every ray x "
              f"every chunk box, issue floor {floor5:.4f} ms ({loop5['per_box_and_ray']:g} SASS "
              f"instructions a box and ray slot: "
              + ", ".join(f"{o} {c / rays5:g}" for o, c in loop5["mix"].items())
              + f"; x {votes5} warp votes); mm2s (large) from its tally "
              f"{b6f:.4f} ms by {by6f} ({w6[2]} tests, {w6[7]} of them passing stage 1, "
              f"{w6[4]} slab tests), {b6w:.4f} ms by {by6w} for its warps' work ({w6[3]} "
              f"tests in voted warp-steps), {b6:.4f} ms by {by6} for every test of the mask "
              f"({tests6:.3g}), issue floor "
              f"{floor6:.4f} ms ({loop6['per_row'] / rays6:g} SASS instructions a row and "
              f"ray, {loop6['skip'] / rays6:g} of them skipped by a failed vote, x "
              f"{w6[0]} warp-steps, {w6[1]} voted); mm2 (mid) from its tally {b7f:.4f} ms by "
              f"{by7f} ({w7[2]} tests, {w7[7]} of them passing stage 1), {b7w:.4f} ms by {by7w} "
              f"for its warps' work, {b7:.4f} ms by {by7} for every test of the mask, issue "
              f"floor {floor7:.4f} ms ({loop7['per_row'] / rays6:g} SASS instructions a row and "
              f"ray, {loop7['skip'] / rays6:g} of them skipped by a failed vote, x {w7[0]} "
              f"warp-steps, {w7[1]} voted)")

    src = "software_rasterizer_tpu_torch/csrc/trace_culled.cu"
    jax_file = "software_rasterizer_tpu/ops/pallas_trace.py"
    tm, tl = entries_ms["mid"], entries_ms["large"]

    def entry(name, line, n_launches, err, ms, bare, plain_ms, b, by):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"{jax_file}:{line}", "launches": n_launches,
                "max_abs_err": err, "ms": ms, "bare_ms": bare, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "library_ms": None}

    return [
        {**entry("trace_fused_cull", 235, launches[0], tier_err["mm2c"], med(tm["mm2c"]),
                 med(tm["mm2c bare"]), tier_plain_ms["mid", "camera", "mm2c"], b4t, by4t),
         "ms_range": [tm["mm2c"][0], tm["mm2c"][-1]],
         "bare_ms_range": [tm["mm2c bare"][0], tm["mm2c bare"][-1]],
         "bare_ms_bounce": med(tm["mm2c bare bounce"]),
         "bound_ms_voted_warps": b4w, "bound_ms_every_test": b4,
         "issue_floor_ms": floor4,
         "sass_per_row_and_ray": loop4["per_row"] / rays5,
         "sass_skipped_per_row_and_ray": loop4["skip"] / rays5,
         "tally": {f"mid {kind}": dict(zip(tt.TALLY_NAMES, w)) for kind, w in work4.items()}},
        {**entry("cull_prepass", 559, launches[1], float(cull_bad), med(tl["cull"]),
                 med(tl["cull bare"]), cull_plain_ms["large", "camera"], b5t, by5t),
         "ms_range": [tl["cull"][0], tl["cull"][-1]],
         "bare_ms_range": [tl["cull bare"][0], tl["cull bare"][-1]],
         "bare_ms_bounce": med(tl["cull bare bounce"]),
         "bound_ms_every_test": b5, "issue_floor_ms": floor5,
         "sass_per_box_and_ray": loop5["per_box_and_ray"],
         "tally": {f"{name} {kind}": dict(zip(tt.CULL_TALLY_NAMES, w))
                   for (name, kind), w in work5.items()}},
        {**entry("trace_listed_stream", 801, launches[3], tier_err["mm2s"], med(tl["mm2s"]),
                 med(tl["mm2s bare"]), tier_plain_ms["large", "camera", "mm2s"], b6f, by6f),
         "ms_range": [tl["mm2s"][0], tl["mm2s"][-1]],
         "bare_ms_range": [tl["mm2s bare"][0], tl["mm2s bare"][-1]],
         "bound_ms_voted_warps": b6w, "bound_ms_every_test": b6,
         "issue_floor_ms": floor6,
         "sass_per_row_and_ray": loop6["per_row"] / rays6,
         "sass_skipped_per_row_and_ray": loop6["skip"] / rays6,
         "tally": {f"{name} {kind}": dict(zip(tt.TALLY_NAMES, w))
                   for (name, kind), w in work6.items()}},
        {**entry("trace_listed", 634, launches[2], tier_err["mm2"], med(tm["mm2"]),
                 med(tm["mm2 bare"]), tier_plain_ms["mid", "camera", "mm2"], b7f, by7f),
         "device_ms": med(tm["mm2 device-only"]),
         "bare_ms_range": [tm["mm2 bare"][0], tm["mm2 bare"][-1]],
         "bound_ms_voted_warps": b7w, "bound_ms_every_test": b7,
         "issue_floor_ms": floor7,
         "sass_per_row_and_ray": loop7["per_row"] / rays6,
         "sass_skipped_per_row_and_ray": loop7["skip"] / rays6,
         "tally": {f"mid {kind}": dict(zip(tt.TALLY_NAMES, w)) for kind, w in work7.items()}},
    ], scenes


def culled_phases(dev, card: str, scenes: dict) -> dict:
    """Phases 25-29: kernel #8 (the unculled chunked sweep) and large-scene
    path tracing and Whitted through the chunk-culled warp walks of the
    camera, bounce and Whitted kernels, on phase 20's `scenes`. Returns the JSON
    entries of kernel #8 and of the culled camera and bounce kernels, and
    the culled numbers of the Whitted kernel."""
    import numpy as np
    import torch

    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import intersect as ti
    from software_rasterizer_tpu_torch.ops import path as tp
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import trace_kernel as tk
    from software_rasterizer_tpu_torch.ops import trace_tiers as tt
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
    from software_rasterizer_tpu_torch.utils.rng import fold_in, key_bits, sample_seeds

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import stress_cornell

    n = WIDTH * HEIGHT
    med = statistics.median
    sizes = {name: sc["rt"].n_tri for name, sc in scenes.items()}

    def differing(a, b):
        return (a[0] != b[0]) | (a[1] != b[1]) | (a[2] != b[2])

    def walk_check(what, tally, st):
        """A culled path kernel's (3,) tally on the plain lanes against the
        plain version's counts: the (ray, row) and slab tests, and the
        row-test slots against the warp walk's model (trace_tiers.warp_slots);
        returns (the walk's SIMT efficiency, the per-thread walk's)."""
        walk = tuple(int(x) for x in tally.tolist())
        want = (st["row_tests"], st["slab_tests"], st["slots"])
        if walk != want:
            fail(f"{what}: tally (row tests, slab tests, slots) {walk}, plain {want}")
        return walk[0] / walk[2], st["row_tests"] / st["slots_thread"]

    def window(name):
        """The lane range of a kernel against kernel comparison: the whole
        frame at 9,216 triangles, LARGE_WINDOW centre lanes at 147,456."""
        return (0, n) if name == "mid" else (n // 2 - LARGE_WINDOW // 2, LARGE_WINDOW)

    plain_off = n // 2 - PLAIN_PATH_LANES // 2

    # ---- 25. kernel #8 against kernel #2 and against its plain version, on
    # camera and bounce rays of Cornell and both large scenes; its tally
    # against the plain model
    from software_rasterizer_tpu_torch.utils.cuda_build import library_path

    cornell = build_cornell_scene()
    cornell.set_ndc_matrix(WIDTH, HEIGHT)
    crt = ti.prepare_rt_scene(cornell.rt_geometry(), cornell.rt_frame(), dev)
    co, cd = (x.contiguous() for x in camera_rays(
        crt.eye.cpu().numpy(), cornell.fovy, WIDTH, HEIGHT, dev))
    _, co2, cd2 = bounce_rays(crt, co, cd)
    sets = {"cornell": (crt, {"camera": (co, cd), "bounce": (co2, cd2)})}
    sets.update({name: (sc["rt"], sc["rays"]) for name, sc in scenes.items()})
    mm_err, mm_plain_ms, lines, t25, work8 = 0.0, {}, [], {}, {}
    for name, (rt, rays) in sets.items():
        rows = rt.tri_table.shape[0]
        for kind, (o_, d_) in rays.items():
            ref = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
            for b in MM_BLOCKS:
                k = tt.trace_nearest_mm(rt.tri_table, o_, d_, block=b)
                bad = int(differing(k, ref).sum())
                if bad:
                    fail(f"kernel #8 at block={b} on {name} {kind}: {bad} rays differ from "
                         f"kernel #2")
            tally = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64, device=dev)
            k = tt.trace_nearest_mm(rt.tri_table, o_, d_, tally=tally)
            work = tuple(int(x) for x in tally.tolist())
            work8[name, kind] = work
            whole = float(n) * rows <= PLAIN_TESTS_LIMIT
            starts = [0] if whole else [0, n // 2, n - LARGE_WINDOW]
            bad_p, ms = 0, 0.0
            for s0 in starts:
                s1 = n if whole else s0 + LARGE_WINDOW
                p_, ms_w = wall_ms(lambda: tt.trace_nearest_mm_plain(
                    rt.tri_table, o_[s0:s1], d_[s0:s1]))
                ms += ms_w
                bad_p += int(differing(tuple(x[s0:s1] for x in k), p_).sum())
                mm_err = max(mm_err, float((k[2][s0:s1] - p_[2]).abs().max()))
                if whole:
                    work_w = work
                else:
                    tw = torch.zeros(tt.TALLY_ENTRIES, dtype=torch.int64, device=dev)
                    tt.trace_nearest_mm(rt.tri_table, o_[s0:s1], d_[s0:s1], tally=tw)
                    work_w = tuple(int(x) for x in tw.tolist())
                want = tt.unculled_tally_plain(rt.tri_table, o_[s0:s1], d_[s0:s1])
                if work_w != want:
                    fail(f"kernel #8 tally on {name} {kind} rays [{s0}, {s1}): {work_w}, "
                         f"plain model {want} ({tt.TALLY_NAMES})")
            if bad_p:
                fail(f"kernel #8 on {name} {kind}: {bad_p} rays differ from its plain version")
            mm_plain_ms[name, kind] = ms
            how = "whole frame" if whole else f"{len(starts)} windows of {LARGE_WINDOW} rays"
            line = (f"{name} {kind} ({rt.n_tri} triangles, {rows} rows): 0/{n} rays differ "
                    f"from kernel #2 at blocks of {MM_BLOCKS}, 0 from the plain version "
                    f"({how}, {ms:.0f} ms), {int(k[0].sum())} hit; s {work[1] / work[0]:.4f} "
                    f"({work[1]}/{work[0]} warp-steps voted), tally = plain model")
            if name != "large":
                t = {"mm": cuda_times(lambda: tt.trace_nearest_mm(rt.tri_table, o_, d_), 10),
                     "mm bare": cuda_times(lambda: tt.launch_trace_unculled(
                         rt.tri_table, o_, d_, tt.MM_BLOCK), 10),
                     "kernel #2": cuda_times(lambda: tk.trace_nearest_vpu(
                         rt.tri_table, rt.n_tri, o_, d_), 3)}
                for b in MM_BLOCKS:
                    t[f"mm block={b}"] = cuda_times(lambda: tt.trace_nearest_mm(
                        rt.tri_table, o_, d_, block=b), 3)
                t25[name, kind] = t
                line += "; ms " + ", ".join(f"{a} {spread(v)}" for a, v in t.items())
            lines.append(line)
    # the path: nearest_hit(backend="mm"), every field against backend="vpu"
    rt = scenes["mid"]["rt"]
    o_, d_ = scenes["mid"]["rays"]["camera"]
    want = ti.nearest_hit(rt, o_, d_, backend="vpu")
    vpu_before = tk.LAUNCHES
    tt.LAUNCHES_MM = 0
    got = ti.nearest_hit(rt, o_, d_, backend="mm")
    torch.cuda.synchronize()
    mm_launches = tt.LAUNCHES_MM
    off = torch.zeros(n, dtype=torch.bool, device=dev)
    for a, b in zip(got, want):
        off |= ~same_lanes(a, b)
    if mm_launches != 1 or tk.LAUNCHES != vpu_before or bool(off.any()):
        fail(f"nearest_hit(backend='mm'): {mm_launches} launches of kernel #8, "
             f"{tk.LAUNCHES - vpu_before} of kernel #2, {int(off.sum())} lanes differ")
    table_bytes8 = tensor_bytes(rt.tri_table, o_, d_) + 13 * n
    b8, by8 = bound(table_bytes8, 58.0 * n * rt.tri_table.shape[0])
    w8 = work8["mid", "camera"]
    (b8f, by8f), (b8w, by8w) = vote_tally_bounds(table_bytes8, w8)
    _, rays8 = tt.launch_shape(tt.MM_BLOCK)
    floor8, loop8 = vote_floor(library_path("trace_culled"),
                               f"trace_unculled_kernelILi{rays8}ELb0E", rays8, w8[0], w8[1])
    phase(25, f"kernel #8 (trace_nearest_mm) on {n} rays, ms as median [min-max] "
              f"on {card}: " + "; ".join(lines) + f"; nearest_hit(backend='mm') on the mid "
              f"scene: launches {mm_launches}, kernel #2 0, all {len(got._fields)} fields "
              f"equal to backend='vpu'; bound (mid camera) from its tally {b8f:.4f} ms by "
              f"{by8f} ({w8[7]} of {w8[2]} tests passing stage 1), {b8w:.4f} ms by {by8w} "
              f"for its warps' work ({w8[3]} tests in voted warp-steps), {b8:.4f} ms by "
              f"{by8} for every test, issue floor "
              f"{floor8:.4f} ms ({loop8['per_row'] / rays8:g} SASS instructions a row and "
              f"ray, {loop8['skip'] / rays8:g} of them skipped by a failed vote)")

    # ---- 26. the culled camera kernel against the full sweep and the plain
    # versions
    kw = dict(p_rr=scenes["mid"]["scene"].rr, max_bounces=MAX_BOUNCES)
    cam, lines, cam_err = {}, [], 0.0
    for name, sc in scenes.items():
        rt, fovy = sc["rt"], sc["scene"].fovy
        args = (rt, SEED, WIDTH, HEIGHT, fovy)
        off, nl = window(name)
        a = pk.path_camera_render(*args, 1, lane_offset=off, n_lanes=nl, cull=True, **kw)
        b, full_ms = wall_ms(lambda: pk.path_camera_render(
            *args, 1, lane_offset=off, n_lanes=nl, cull=False, **kw))
        n_off = int((a != b).any(dim=0).sum())
        if n_off:
            r = torch.nonzero((a != b).any(dim=0)).flatten()
            print(f"[phase 26] {name}: lanes {(r[:8] + off).tolist()} differ", flush=True)
            fail(f"culled camera kernel on {name}: {n_off}/{nl} lanes differ from the full sweep")
        # (the walk's SIMT efficiency, the per-thread walk's) on the plain
        # lanes; not read where a lane differs from plain (its counts differ)
        plain, bad, eff = {}, {}, (float("nan"), float("nan"))
        for cull in (True, False):
            k = pk.path_camera_render(*args, 1, lane_offset=plain_off,
                                      n_lanes=PLAIN_PATH_LANES, cull=cull, **kw)
            st = {}
            p_, plain[cull] = wall_ms(lambda: pk.path_camera_render_plain(
                *args, 1, lane_offset=plain_off, n_lanes=PLAIN_PATH_LANES, cull=cull,
                stats=st, **kw))
            diff = (k - p_).abs()
            cam_err = max(cam_err, float(diff.max()))
            bad[cull] = int((diff > LANE_ATOL + LANE_RTOL * p_.abs()).any(dim=0).sum())
            if bad[cull] > (1.0 - LANE_SHARE) * PLAIN_PATH_LANES + 1:
                fail(f"camera kernel (cull={cull}) on {name} disagrees with plain on "
                     f"{bad[cull]}/{PLAIN_PATH_LANES} lanes")
            if cull:
                tally = torch.zeros(3, dtype=torch.int64, device=dev)
                attr_t, sph_t, n_sph = pk.pack_scene_tables(rt)
                pk.launch_path_camera(
                    rt.tri_table.float().contiguous(), attr_t, sph_t,
                    rt.emitter_cr.float().contiguous(),
                    torch.as_tensor(sample_seeds(SEED, 0, 1)).to(dev),
                    pk._camera_table(rt, fovy, WIDTH, HEIGHT), n_tri=rt.n_tri,
                    n_sph=n_sph, n_emitters=rt.n_emitters, lane_offset=plain_off,
                    n_lanes=PLAIN_PATH_LANES, width=WIDTH, height=HEIGHT,
                    cull_tables=pk.pack_cull_tables(rt), tally=tally, **kw)
                torch.cuda.synchronize()
                if bad[cull] == 0:
                    eff = walk_check(f"camera kernel walk on {name}", tally, st)
        # the frame at SPP: the kernel whole and bare, and its tally
        reps = 5 if name == "mid" else 3
        attr_t, sph_t, n_sph = pk.pack_scene_tables(rt)
        ct = pk.pack_cull_tables(rt)
        ops = (rt.tri_table.float().contiguous(), attr_t, sph_t,
               rt.emitter_cr.float().contiguous(),
               torch.as_tensor(sample_seeds(SEED, 0, SPP)).to(dev),
               pk._camera_table(rt, fovy, WIDTH, HEIGHT))
        launch_kw = dict(n_tri=rt.n_tri, n_sph=n_sph, n_emitters=rt.n_emitters,
                         lane_offset=0, n_lanes=n, width=WIDTH, height=HEIGHT,
                         cull_tables=ct, **kw)
        frame = pk.path_camera_render(*args, SPP, **kw)
        t_k = cuda_times(lambda: pk.path_camera_render(*args, SPP, **kw), reps)
        t_b = cuda_times(lambda: pk.launch_path_camera(*ops, **launch_kw), reps)
        tally = torch.zeros(3, dtype=torch.int64, device=dev)
        pk.launch_path_camera(*ops, tally=tally, **launch_kw)
        torch.cuda.synchronize()
        (b_c, by_c), rows, slabs = tests_bound_ms(
            tensor_bytes(*ops[:4], ct.lo, ct.hi, ct.lo2, ct.hi2, frame), tally)
        simt = rows / int(tally[2])
        cam[name] = dict(frame=frame, t=t_k, bare=t_b, bound=(b_c, by_c), plain=plain,
                         full_mpaths=nl / full_ms / 1e3, full_ms=full_ms, simt=simt,
                         simt_thread=eff[1])
        lines.append(
            f"{name} ({rt.n_tri} triangles): culled == full sweep on all {nl} lanes of "
            f"[{off}, {off + nl}) at 1 spp (full sweep {full_ms:.0f} ms wall = "
            f"{nl / full_ms / 1e3:.3f} Mpaths/s); vs plain on {PLAIN_PATH_LANES} lanes at 1 spp: "
            f"culled {bad[True]}, full {bad[False]} lanes differ (plain {plain[True]:.0f} / "
            f"{plain[False]:.0f} ms), walk tally (row tests, slab tests, slots) = plain counts "
            f"and the warp walk's model; SIMT efficiency of the walk (row tests / slots) "
            f"{eff[0]:.4f} there against {eff[1]:.4f} for the per-thread walk "
            f"(trace_tiers.warp_slots' model of its schedule on the same lanes); {SPP} spp "
            f"whole frame: kernel {spread(t_k)} ms = {n * SPP / med(t_k) / 1e3:.2f} Mpaths/s "
            f"(earlier reading {EARLIER_CULLED_MS['camera'][name]} ms: "
            f"{med(t_k) / EARLIER_CULLED_MS['camera'][name]:.3f}x), "
            f"bare {spread(t_b)}; {rows:.4g} row tests, {slabs:.4g} slab tests = "
            f"{rows / (2.0 * n * SPP):.0f} rows a lane-sample and ray of the "
            f"{rt.tri_table.shape[0]}, {int(tally[2]):.4g} slots (efficiency {simt:.4f}); "
            f"bound {b_c:.4f} ms by {by_c} ({med(t_k) / b_c:.1f}x)")
    phase(26, f"camera kernel, culled walk vs full sweep, {MAX_BOUNCES} bounces, on {card}: "
              + "; ".join(lines) + f"; max_abs_err vs plain {cam_err:.3g}")

    # ---- 27. the bounce kernel: culled vs full sweep vs plain; path_trace's routes
    bnc, lines, bnc_err = {}, [], 0.0
    seed = int(key_bits(fold_in(fold_in(SEED, 0), 0)))
    rr = dict(p_rr=kw["p_rr"])
    for name, sc in scenes.items():
        rt = sc["rt"]
        o_, d_ = sc["rays"]["camera"]
        hit = ti.nearest_hit(rt, o_, d_)
        state, live = tp.primary_state(hit).contiguous(), hit.hit.contiguous()
        off, nl = window(name)

        def part(s0, cnt):
            return state[:, s0:s0 + cnt].contiguous(), live[s0:s0 + cnt].contiguous()

        a = pk.fused_bounce_group(rt, *part(off, nl), seed, MAX_BOUNCES, cull=True, **rr)
        b, full_ms = wall_ms(lambda: pk.fused_bounce_group(
            rt, *part(off, nl), seed, MAX_BOUNCES, cull=False, **rr))
        n_off = int(sum((~same_lanes(x.reshape(-1, nl).T, y.reshape(-1, nl).T)).long()
                        for x, y in zip(a, b)).gt(0).sum())
        if n_off:
            fail(f"culled bounce kernel on {name}: {n_off}/{nl} lanes differ from the full sweep")
        bad, plain, eff = {}, {}, (float("nan"), float("nan"))
        for cull in (True, False):
            ps, pl = part(plain_off, PLAIN_PATH_LANES)
            ka, _, kl = pk.fused_bounce_group(rt, ps, pl, seed, MAX_BOUNCES, cull=cull, **rr)
            st = {}
            (pa, _, plv), plain[cull] = wall_ms(lambda: pk.fused_bounce_group_plain(
                rt, ps, pl, seed, MAX_BOUNCES, stats=st, cull=cull, **rr))
            da = (ka - pa).abs()
            bnc_err = max(bnc_err, float(da.max()))
            bad[cull] = int(((da > LANE_ATOL + LANE_RTOL * pa.abs()).any(dim=0)
                             | (kl != plv)).sum())
            if bad[cull] > (1.0 - LANE_SHARE) * PLAIN_PATH_LANES + 1:
                fail(f"bounce kernel (cull={cull}) on {name} disagrees with plain on "
                     f"{bad[cull]}/{PLAIN_PATH_LANES} lanes")
            if cull and bad[cull] == 0:
                tally = torch.zeros(3, dtype=torch.int64, device=dev)
                pk.launch_path_bounce(
                    rt.tri_table.float().contiguous(), *pk.pack_scene_tables(rt)[:2],
                    rt.emitter_cr.float().contiguous(), ps, pl, n_tri=rt.n_tri,
                    n_sph=rt.n_sph, n_emitters=rt.n_emitters, seed=seed, n_bounces=MAX_BOUNCES,
                    p_rr=kw["p_rr"], cull_tables=pk.pack_cull_tables(rt), tally=tally)
                torch.cuda.synchronize()
                eff = walk_check(f"bounce kernel walk on {name}", tally, st)
        attr_t, sph_t, n_sph = pk.pack_scene_tables(rt)
        ct = pk.pack_cull_tables(rt)
        ops = (rt.tri_table.float().contiguous(), attr_t, sph_t,
               rt.emitter_cr.float().contiguous(), state, live)
        launch_kw = dict(n_tri=rt.n_tri, n_sph=n_sph, n_emitters=rt.n_emitters,
                         seed=seed, n_bounces=MAX_BOUNCES, p_rr=kw["p_rr"], cull_tables=ct)
        t_k = cuda_times(lambda: pk.fused_bounce_group(rt, state, live, seed, MAX_BOUNCES,
                                                       **rr), 10)
        t_b = cuda_times(lambda: pk.launch_path_bounce(*ops, **launch_kw), 10)
        tally = torch.zeros(3, dtype=torch.int64, device=dev)
        pk.launch_path_bounce(*ops, tally=tally, **launch_kw)
        torch.cuda.synchronize()
        (b_b, by_b), rows, slabs = tests_bound_ms(
            tensor_bytes(*ops[:4], ct.lo, ct.hi, ct.lo2, ct.hi2) + 2 * tensor_bytes(state, live)
            + 12 * n, tally)
        simt = rows / int(tally[2])
        # path_trace's routes on one sample of the centre lanes: the bounce
        # kernel (fused=None) and the plain wavefront over the trace tiers
        po, pd = (x[n // 2 - PLAIN_WAVE_LANES // 2:][:PLAIN_WAVE_LANES] for x in (o_, d_))
        pkw = dict(p_rr=kw["p_rr"], max_bounces=MAX_BOUNCES)
        tp.path_trace(rt, po, pd, SEED, **pkw)
        pk.LAUNCHES_BOUNCE = pk.LAUNCHES_BOUNCE_CULLED = 0
        fused_r, fused_ms = wall_ms(lambda: tp.path_trace(rt, po, pd, SEED, **pkw))
        launches = (pk.LAUNCHES_BOUNCE, pk.LAUNCHES_BOUNCE_CULLED)
        if launches != (0, 1):
            fail(f"path_trace(fused=None) on {name}: bounce kernel launches (full, culled) "
                 f"{launches}")
        (plain_r, pst), plain_ms = wall_ms(lambda: tp.path_trace(
            rt, po, pd, SEED, fused=False, with_stats=True, **pkw))
        pm = float(torch.clamp(plain_r, 0, 1).mean())
        fm = float(torch.clamp(fused_r, 0, 1).mean())
        if int(pst["dropped_lanes"]) or abs(pm - fm) > 0.05 * fm:
            fail(f"path_trace on {name}: fused=None mean {fm}, fused=False mean {pm}, "
                 f"dropped {int(pst['dropped_lanes'])}")
        # the frame's other route: the camera kernel at one sample against
        # one wavefront sample of the whole frame
        _, cam1_ms = wall_ms(lambda: pk.path_camera_render(rt, SEED, WIDTH, HEIGHT,
                                                           sc["scene"].fovy, 1, **kw))
        _, wave1_ms = wall_ms(lambda: tp.path_trace(rt, o_, d_, SEED, **pkw))
        bnc[name] = dict(t=t_k, bare=t_b, bound=(b_b, by_b), plain=plain, launches=launches[1],
                         fused_ms=fused_ms, plain_route_ms=plain_ms, cam1_ms=cam1_ms,
                         wave1_ms=wave1_ms, simt=simt, simt_thread=eff[1])
        lines.append(
            f"{name} ({rt.n_tri} triangles): culled == full sweep on all {nl} lanes "
            f"(full sweep {full_ms:.0f} ms wall); vs plain on {PLAIN_PATH_LANES} lanes: culled "
            f"{bad[True]}, full {bad[False]} lanes differ (plain {plain[True]:.0f} / "
            f"{plain[False]:.0f} ms), walk tally = plain counts and the model's slots; SIMT "
            f"efficiency of the walk {eff[0]:.4f} there against {eff[1]:.4f} for the "
            f"per-thread walk; {n} lanes: kernel {spread(t_k)} ms (earlier reading "
            f"{EARLIER_CULLED_MS['bounce'][name]} ms: "
            f"{med(t_k) / EARLIER_CULLED_MS['bounce'][name]:.3f}x), bare {spread(t_b)}, "
            f"{rows:.4g} row tests, {slabs:.4g} slab tests, {int(tally[2]):.4g} slots "
            f"(efficiency {simt:.4f}), bound {b_b:.4f} ms by {by_b} ({med(t_k) / b_b:.1f}x); "
            f"path_trace one sample of {PLAIN_WAVE_LANES} lanes (wall, once): fused=None "
            f"{fused_ms:.1f} ms (culled bounce kernel, launches {launches[1]}, clipped mean "
            f"{fm:.5f}), fused=False {plain_ms:.1f} ms (clipped mean {pm:.5f}, dropped 0); "
            f"one sample of the whole frame (wall, once): camera kernel {cam1_ms:.1f} ms, "
            f"path_trace fused=None {wave1_ms:.1f} ms")
    phase(27, f"bounce kernel, culled walk vs full sweep, {MAX_BOUNCES} bounces, on {card}: "
              + "; ".join(lines) + f"; max_abs_err vs plain {bnc_err:.3g}")

    wht, wht_err = whitted_culled_phase(dev, card, scenes)

    # ---- 29. the main path: pipeline_from_config -> draw() on both scenes
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=MAX_BOUNCES, seed=SEED)
    lines = []
    draw_launches = {"camera": 0, "whitted": 0}
    for name, levels in zip(("mid", "large"), LARGE_LEVELS):
        scene = stress_cornell(build_cornell_scene, subdivide_mesh, levels)
        render = pipeline_from_config(cfg, "path")
        render.add_scene(scene)
        pk.LAUNCHES = pk.LAUNCHES_CULLED = pk.LAUNCHES_BOUNCE = pk.LAUNCHES_BOUNCE_CULLED = 0
        _, path_wall = wall_ms(render.draw)
        counts = (pk.LAUNCHES, pk.LAUNCHES_CULLED, pk.LAUNCHES_BOUNCE, pk.LAUNCHES_BOUNCE_CULLED)
        if render.device.type != "cuda" or counts != (0, 1, 0, 0):
            fail(f"PathTracing.draw() on {name}: launches (camera full, culled, bounce full, "
                 f"culled) {counts}")
        frame = render.frame
        ref = (cam[name]["frame"].T / float(SPP)).reshape(HEIGHT, WIDTH, 3).cpu().numpy()
        if frame.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(frame).all() \
                or not np.allclose(frame, ref, rtol=ACC_RTOL, atol=ACC_ATOL):
            fail(f"PathTracing.draw() on {name} differs from phase 26's frame")
        png = OUT_DIR / f"chip_smoke_path_{name}.png"
        render.save(str(png))
        draw_launches["camera"] += counts[1]

        wrender = pipeline_from_config(cfg, "whitted")
        wscene = stress_cornell(build_cornell_scene, subdivide_mesh, levels)
        wrender.add_scene(wscene)
        wk.LAUNCHES = wk.LAUNCHES_CULLED = 0
        _, wh_wall = wall_ms(wrender.draw)
        wcounts = (wk.LAUNCHES, wk.LAUNCHES_CULLED)
        st = wrender.last_stats[wscene.name]
        if wcounts != (0, 1) or st["dropped_rays"] != 0:
            fail(f"RayTracing.draw() on {name}: launches (full, culled) {wcounts}, stats {st}")
        if not np.array_equal(wrender.frame,
                              wht[name]["frame"].reshape(HEIGHT, WIDTH, 3).cpu().numpy()):
            fail(f"RayTracing.draw() on {name} differs from phase 28's frame")
        wpng = OUT_DIR / f"chip_smoke_whitted_{name}.png"
        wrender.save(str(wpng))
        draw_launches["whitted"] += wcounts[1]
        k_ms = med(cam[name]["t"])
        lines.append(
            f"{name} ({scene.name}, {sizes[name]} triangles): PathTracing.draw() -> {png.name} "
            f"{path_wall:.0f} ms wall (scene upload and BVH included), launches (camera full, "
            f"culled, bounce full, culled) {counts}, frame = phase 26's, clipped mean "
            f"{float(np.clip(frame, 0, 1).mean()):.5f}; its kernel {k_ms:.1f} ms = "
            f"{n * SPP / k_ms / 1e3:.2f} Mpaths/s against the full sweep's "
            f"{cam[name]['full_mpaths']:.3f} (phase 26), bound {cam[name]['bound'][0]:.4f} ms; "
            f"RayTracing.draw() -> {wpng.name} {wh_wall:.0f} ms wall, launches (full, culled) "
            f"{wcounts}, last_stats {st}, frame = phase 28's; its kernel "
            f"{med(wht[name]['t']):.3f} ms = {n / med(wht[name]['t']) / 1e3:.1f} M rays/s, "
            f"bound {wht[name]['bound'][0]:.4f} ms")
    phase(29, f"large-scene main path, pipeline_from_config on the default device, "
              f"{WIDTH}x{HEIGHT}, {SPP} spp, on {card}: " + "; ".join(lines))

    mid = "mid"
    return {
        "entries": [
            {"name": "trace_unculled", "route": "cuda",
             "source": "software_rasterizer_tpu_torch/csrc/trace_culled.cu",
             "replaces": "software_rasterizer_tpu/ops/pallas_trace.py:120",
             "launches": mm_launches, "max_abs_err": mm_err,
             "ms": med(t25[mid, "camera"]["mm"]), "bare_ms": med(t25[mid, "camera"]["mm bare"]),
             "plain_ms": mm_plain_ms[mid, "camera"], "bound_ms": b8f, "bound_by": by8f,
             "library_ms": None,
             "ms_range": [t25[mid, "camera"]["mm"][0], t25[mid, "camera"]["mm"][-1]],
             "bare_ms_range": [t25[mid, "camera"]["mm bare"][0],
                               t25[mid, "camera"]["mm bare"][-1]],
             "bare_ms_bounce": med(t25[mid, "bounce"]["mm bare"]),
             "bound_ms_voted_warps": b8w, "bound_ms_every_test": b8,
             "issue_floor_ms": floor8,
             "sass_per_row_and_ray": loop8["per_row"] / rays8,
             "sass_skipped_per_row_and_ray": loop8["skip"] / rays8,
             "tally": {f"{name} {kind}": dict(zip(tt.TALLY_NAMES, w))
                       for (name, kind), w in work8.items()}},
            {"name": "path_camera_culled", "route": "cuda",
             "source": "software_rasterizer_tpu_torch/csrc/path_camera.cu",
             "replaces": "software_rasterizer_tpu/ops/pallas_path.py:354",
             "launches": draw_launches["camera"], "max_abs_err": cam_err,
             "ms": med(cam[mid]["t"]), "bare_ms": med(cam[mid]["bare"]),
             "plain_ms": cam[mid]["plain"][True], "plain_lanes": PLAIN_PATH_LANES,
             "plain_spp": 1, "bound_ms": cam[mid]["bound"][0],
             "bound_by": cam[mid]["bound"][1], "library_ms": None,
             "ms_range": [cam[mid]["t"][0], cam[mid]["t"][-1]],
             "simt_efficiency": cam[mid]["simt"],
             "simt_efficiency_per_thread_walk": cam[mid]["simt_thread"],
             "ms_147456": med(cam["large"]["t"]),
             "ms_range_147456": [cam["large"]["t"][0], cam["large"]["t"][-1]],
             "bound_ms_147456": cam["large"]["bound"][0],
             "simt_efficiency_147456": cam["large"]["simt"],
             "simt_efficiency_per_thread_walk_147456": cam["large"]["simt_thread"]},
            {"name": "path_bounce_culled", "route": "cuda",
             "source": "software_rasterizer_tpu_torch/csrc/path_bounce.cu",
             "replaces": "software_rasterizer_tpu/ops/pallas_path.py:635",
             "launches": bnc[mid]["launches"] + bnc["large"]["launches"],
             "max_abs_err": bnc_err, "ms": med(bnc[mid]["t"]),
             "bare_ms": med(bnc[mid]["bare"]), "plain_ms": bnc[mid]["plain"][True],
             "plain_lanes": PLAIN_PATH_LANES, "bound_ms": bnc[mid]["bound"][0],
             "bound_by": bnc[mid]["bound"][1], "library_ms": None,
             "ms_range": [bnc[mid]["t"][0], bnc[mid]["t"][-1]],
             "simt_efficiency": bnc[mid]["simt"],
             "simt_efficiency_per_thread_walk": bnc[mid]["simt_thread"],
             "ms_147456": med(bnc["large"]["t"]),
             "ms_range_147456": [bnc["large"]["t"][0], bnc["large"]["t"][-1]],
             "bound_ms_147456": bnc["large"]["bound"][0],
             "simt_efficiency_147456": bnc["large"]["simt"],
             "simt_efficiency_per_thread_walk_147456": bnc["large"]["simt_thread"]},
        ],
        "whitted": {"launches": draw_launches["whitted"], "ms_9216": med(wht[mid]["t"]),
                    "ms_147456": med(wht["large"]["t"]),
                    "bare_ms_9216": med(wht[mid]["bare"]),
                    "bare_ms_147456": med(wht["large"]["bare"]),
                    "bound_ms_9216": wht[mid]["bound"][0],
                    "bound_ms_147456": wht["large"]["bound"][0],
                    "plain_ms_9216": wht[mid]["plain"][True], "max_abs_err": wht_err,
                    "simt_efficiency": {sz: {ray: e["frame"] for ray, e in wht[k]["eff"].items()}
                                        for k, sz in (("mid", "9216"), ("large", "147456"))},
                    "issue_floor_ms_9216": wht[mid]["floor"],
                    "issue_floor_ms_147456": wht["large"]["floor"]},
    }


def whitted_culled_phase(dev, card: str, scenes: dict):
    """Phase 28: the Whitted kernel's culled walk on phase 20's `scenes`
    against its full sweep and its plain version, the walk's tallies, and
    the deep stacks. Returns ({scene: frame, times, bound, efficiencies},
    the largest difference from plain)."""
    import torch

    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.ops import intersect as ti
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.ops.whitted import whitted_render
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import mirror_walls_cornell

    n = WIDTH * HEIGHT
    plain_off = n // 2 - PLAIN_PATH_LANES // 2

    # ---- 28. Whitted: culled vs full sweep vs plain; the deep stack
    wht, lines, wht_err = {}, [], 0.0
    md = WHITTED_DEPTH
    for name, sc in scenes.items():
        rt = sc["rt"]
        o_, d_ = sc["rays"]["camera"]
        a = wk.whitted_uber_trace(rt, o_, d_, md, cull=True)
        b, full_ms = wall_ms(lambda: wk.whitted_uber_trace(rt, o_, d_, md, cull=False))
        n_off = int((~same_lanes(a[0], b[0]) | (a[1] != b[1]).any(dim=0)).sum())
        if n_off:
            fail(f"culled Whitted kernel on {name}: {n_off}/{n} pixels differ from the full sweep")
        img, wst = whitted_render(rt, WIDTH, HEIGHT, sc["scene"].fovy, max_depth=md,
                                  with_stats=True)
        if int(wst["dropped_rays"]) != 0 or not torch.equal(img.reshape(n, 3), a[0]):
            fail(f"whitted_render on {name}: dropped {int(wst['dropped_rays'])}, or not the "
                 f"culled kernel's frame")
        bad, plain, st = {}, {}, {}
        sl = slice(plain_off, plain_off + PLAIN_PATH_LANES)
        for cull in (True, False):
            k = wk.whitted_uber_trace(rt, o_[sl], d_[sl], md, cull=cull)
            p_, plain[cull] = wall_ms(lambda: wk.whitted_uber_trace_plain(
                rt, o_[sl], d_[sl], md, cull=cull, stats=st if cull else None))
            c = compare_whitted(*k, *p_)
            wht_err = max(wht_err, c["max_abs_err"])
            bad[cull] = c["bad"]
            if c["bad"] > (1.0 - PIX_SHARE) * c["n"] + 1 or c["rays_rel"] > RAYS_RTOL:
                fail(f"Whitted kernel (cull={cull}) on {name} disagrees with plain: {c}")
        args, kw = wk.whitted_launch_args(rt, o_, d_, md, cull=True)
        ct = kw["cull_tables"]
        t_k = cuda_times(lambda: wk.whitted_uber_trace(rt, o_, d_, md), 10)
        t_b = cuda_times(lambda: wk.launch_whitted_uber(*args, **kw), 10)
        # the culled walk's tallies, main and shadow rays apart: the whole
        # frame, and the plain lanes against the plain version's counts
        tally = torch.zeros((2, 3), dtype=torch.int64, device=dev)
        wk.launch_whitted_uber(*args, tally=tally, **kw)
        tally_pl = torch.zeros((2, 3), dtype=torch.int64, device=dev)
        wk.launch_whitted_uber(*args[:6], o_[sl], d_[sl], tally=tally_pl, **kw)
        torch.cuda.synchronize()
        (b_w, by_w), rows, slabs = tests_bound_ms(
            tensor_bytes(*args, ct.lo, ct.hi, ct.lo2, ct.hi2) + 20 * n,
            tally[:, :2].sum(dim=0))
        eff = {}
        for i, ray in enumerate(wk.TALLY_ROWS):
            fr, pl, want = tally[i].tolist(), tally_pl[i].tolist(), st[ray]
            if pl != [want["row_tests"], want["slab_tests"], want["slots"]]:
                fail(f"Whitted culled walk on {name}, {ray} rays: tally (row tests, slab "
                     f"tests, slots) {pl} on the plain lanes, plain {want} (slots: the "
                     f"warp walk's model)")
            eff[ray] = {"frame": fr[0] / fr[2], "lanes": pl[0] / pl[2],
                        "model_per_ray": want["row_tests"] / want["slots_thread"],
                        "model_warp": want["row_tests"] / want["slots"]}
        # the culled instance with the 8-entry stack (max_depth 5)
        floor_ms, loop = issue_floor("whitted_uber", "whitted_uber_kernelILb1ELi8E", 1,
                                     int(tally[:, 2].sum()), rays=1)
        wht[name] = dict(frame=a[0], t=t_k, bare=t_b, bound=(b_w, by_w), plain=plain,
                         full_ms=full_ms, eff=eff, floor=floor_ms)
        lines.append(
            f"{name} ({rt.n_tri} triangles): culled == full sweep on all {n} pixels "
            f"(rgb and ray counts; full sweep {full_ms:.1f} ms wall), whitted_render "
            f"dropped_rays 0; vs plain on {PLAIN_PATH_LANES} lanes: culled {bad[True]}, full "
            f"{bad[False]} pixels differ (plain {plain[True]:.0f} / {plain[False]:.0f} ms); "
            f"kernel {spread(t_k)} ms, bare {spread(t_b)}, {rows:.4g} row tests, "
            f"{slabs:.4g} slab tests, bound {b_w:.4f} ms by {by_w}; SIMT efficiency of "
            f"the walk (row tests / slots), main / shadow rays: the kernel's tally "
            + ", ".join(f"{e['frame']:.4f}" for e in eff.values()) + " on the frame, "
            + ", ".join(f"{e['lanes']:.4f}" for e in eff.values())
            + f" on the {PLAIN_PATH_LANES} plain lanes, where the models (plain version, "
            f"trace_tiers.warp_slots) give the per-ray walk under a warp-uniform step "
            + ", ".join(f"{e['model_per_ray']:.4f}" for e in eff.values())
            + " and the warp walk " + ", ".join(f"{e['model_warp']:.4f}" for e in eff.values())
            + f" (the per-ray walk's before the warp-uniform step: "
            + ", ".join(f"{x:.4f}" for x in EARLIER_WHITTED_SIMT[name])
            + f", an earlier reading); issue floor {floor_ms:.4f} ms ({loop['per_row']:g} SASS "
            f"instructions a row and ray in the walk's row loop, {loop['unroll']} rows a loop "
            f"iteration, x {int(tally[:, 2].sum())} slots / 32), bare "
            f"{statistics.median(t_b) / floor_ms:.2f}x it")
    # a depth beyond the old stack of 8, through the kernel (16-entry stack)
    mg = mirror_walls_cornell(models, build_cornell_scene)
    mg.set_ndc_matrix(WIDTH, HEIGHT)
    mrt = ti.prepare_rt_scene(mg.rt_geometry(), mg.rt_frame(), dev)
    mo, mdir = (x.contiguous() for x in camera_rays(
        mrt.eye.cpu().numpy(), mg.fovy, WIDTH, HEIGHT, dev))
    deep = {}
    # DEEP_DEPTH on the whole frame, the deepest stack on the centre lanes
    for depth, sl in ((DEEP_DEPTH, slice(0, n)),
                      (wk.MAX_DEPTH, slice(n // 2 - LARGE_WINDOW // 2, n // 2 + LARGE_WINDOW // 2))):
        k = wk.whitted_uber_trace(mrt, mo[sl], mdir[sl], depth)
        p_ = wk.whitted_uber_trace_plain(mrt, mo[sl], mdir[sl], depth)
        c = compare_whitted(*k, *p_)
        wht_err = max(wht_err, c["max_abs_err"])
        deep[depth] = c
        if c["bad"] > (1.0 - PIX_SHARE) * c["n"] + 1 or c["rays_rel"] > RAYS_RTOL:
            fail(f"Whitted kernel at max_depth {depth} disagrees with plain: {c}")
    phase(28, f"Whitted kernel, culled walk vs full sweep, max_depth {md}, on {card}: "
              + "; ".join(lines) + "; Cornell with mirror walls, a mirror and a glass sphere "
              "through the kernel vs plain: "
              + "; ".join(f"max_depth {k_} ({c['n']} lanes): {c['bad']} pixels differ, rays "
                          f"main/shadow {c['k_rays'][0]}/{c['k_rays'][1]} vs "
                          f"{c['p_rays'][0]}/{c['p_rays'][1]}" for k_, c in deep.items())
              + f"; max_abs_err {wht_err:.3g}")

    return wht, wht_err


def whitted_ab(csrc_dirs: dict, rounds: int = 4, repeats: int = 5) -> dict:
    """Times the Whitted kernel as built from other sources, in turns in one
    process on one card, at 1024x1024 max_depth 5:

        python3 -c "import chip_smoke as c; c.whitted_ab({'parent': 'DIR', 'this':
            'software_rasterizer_tpu_torch/csrc'})"

    `csrc_dirs` names directories that each hold a whitted_uber.cu (and
    the headers it includes) with this tree's C interface, e.g. the csrc/
    of an unpacked earlier commit. Each is built with the package's nvcc
    flags; its bare launch is timed on Cornell, Cornell with a mirror and a
    glass sphere, two emitters at spp 4 and the tessellated Cornell boxes
    of 9,216 and 147,456 triangles (the culled walk), `rounds` rounds of
    `repeats` launches, the order of the builds reversed every other round.
    Every build's frame and ray counts must equal the first's bit for bit.
    Prints a line a scene and the builds' ptxas register and spill lines;
    returns {scene: {build: sorted ms}}."""
    import ctypes

    import torch

    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
    from software_rasterizer_tpu_torch.utils import cuda_build

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import mirror_glass_cornell, stress_cornell, two_emitter_cornell

    card = card_line()
    dev = torch.device("cuda")
    names = list(csrc_dirs)
    argtypes, restype = wk._cuda_fn().argtypes, wk._cuda_fn().restype
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, d in csrc_dirs.items():
        out = cuda_build.BUILD_DIR / f"ab_whitted_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(pathlib.Path(d) / "whitted_uber.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"nvcc failed on {csrc_dirs[name]}: {log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                print(f"[ab] {name}: {ln.strip()}", flush=True)
        fn = ctypes.CDLL(str(out)).srt_whitted_uber
        fn.argtypes, fn.restype = argtypes, restype
        fns[name] = fn
    own = wk._cuda_fn
    md, n = WHITTED_DEPTH, WIDTH * HEIGHT
    scenes = {
        "cornell": (build_cornell_scene, 1),
        "mirror_glass": (lambda: mirror_glass_cornell(models, build_cornell_scene), 1),
        "two_emitters_spp4": (lambda: two_emitter_cornell(models, build_cornell_scene),
                              WHITTED_EMITTER_SPP),
        "mid": (lambda: stress_cornell(build_cornell_scene, subdivide_mesh, LARGE_LEVELS[0]), 1),
        "large": (lambda: stress_cornell(build_cornell_scene, subdivide_mesh, LARGE_LEVELS[1]),
                  1),
    }
    res = {}
    try:
        for sname, (build, spp) in scenes.items():
            scene = build()
            scene.set_ndc_matrix(WIDTH, HEIGHT)
            rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
            o, d = (x.contiguous() for x in camera_rays(
                rt.eye.cpu().numpy(), scene.fovy, WIDTH, HEIGHT, dev))
            ops, kw = wk.whitted_launch_args(rt, o, d, md, key=SEED, spp=spp)
            outs, times = {}, {b: [] for b in names}
            for b in names:
                wk._cuda_fn = lambda b=b: fns[b]
                outs[b] = wk.launch_whitted_uber(*ops, **kw)
            torch.cuda.synchronize()
            same = {b: bool(torch.equal(outs[b][0], outs[names[0]][0])
                            and torch.equal(outs[b][1], outs[names[0]][1])) for b in names}
            if not all(same.values()):
                fail(f"ab {sname}: frames equal to {names[0]}'s: {same}")
            for rnd in range(rounds):
                for b in (names if rnd % 2 == 0 else names[::-1]):
                    wk._cuda_fn = lambda b=b: fns[b]
                    times[b] += cuda_times(lambda: wk.launch_whitted_uber(*ops, **kw), repeats)
            res[sname] = {b: sorted(t) for b, t in times.items()}
            print(f"[ab] {sname} ({rt.n_tri} triangles, {n} lanes, bare launch, ms as median "
                  f"[min-max] of {rounds * repeats} in turns, on {card}): "
                  + ", ".join(f"{b} {spread(res[sname][b])}" for b in names)
                  + f"; frames and ray counts equal to {names[0]}'s", flush=True)
    finally:
        wk._cuda_fn = own
    return res


def _tree_module(path: pathlib.Path, modname: str, lib):
    """The module at `path` (another tree's ops/ module) loaded under
    `modname`, its C binding (`_cuda_lib`, else `_cuda_fn`: each calls
    cuda_build.load_library) bound to the loaded library `lib` instead of
    the package's own build."""
    import importlib.util

    from software_rasterizer_tpu_torch.utils import cuda_build

    if not path.exists():
        fail(f"no {path}: the tree holds no such module")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    getter = getattr(mod, "_cuda_lib", None) or mod._cuda_fn
    load = cuda_build.load_library
    cuda_build.load_library = lambda name_, sources, lib=lib: lib
    try:
        bound_to = getter()
    finally:
        cuda_build.load_library = load
    setattr(mod, getter.__name__, lambda o=bound_to: o)
    return mod


def trace_ab(csrc_dirs: dict, rounds: int = 4, repeats: int = 5, launches: int = 20) -> dict:
    """Times kernels #2 (trace_nearest_kernel), #4 (trace_fused_cull_kernel),
    #5 (cull_prepass_kernel), #6 (trace_listed_stream_kernel), #7 (the listed
    sweep of every listed chunk) and #8 (trace_unculled_kernel) as built from
    other sources, in turns in one process on one card:

        python3 -c "import chip_smoke as c; c.trace_ab({'parent': 'DIR', 'this':
            'software_rasterizer_tpu_torch/csrc'})"

    `csrc_dirs` maps a name to the csrc/ directory of a package tree (an
    earlier commit's software_rasterizer_tpu_torch unpacked under _checkout/,
    say) that holds trace_nearest.cu and trace_culled.cu (and the headers
    they include) beside ops/trace_kernel.py and ops/trace_tiers.py. Each
    source is called through the interface it exports: without
    srt_trace_nearest_rays #2 without a tally, one ray a thread; without
    srt_trace_tally_entries the one before #6's boxes and tally (#8 taking
    the JAX chunk); without srt_cull_tally_entries #5 without super boxes and
    #4 and #5 without a tally. Each is built with the package's nvcc flags;
    its bare launch (the C function called directly) is timed on phase 20's
    camera and bounce rays, ray blocks of 64 (#2 on Cornell, and on camera
    rays at 9,216 triangles, where it reads the table through the cache; #4
    and #7 at 9,216 triangles, #7 on the prepass's lists; #5 at 9,216 and
    147,456; #6 at 147,456 on the prepass's lists; #8 at 9,216 and on
    Cornell, blocks of MM_BLOCK), `rounds` rounds of `repeats` launches, the
    order of the builds reversed every other round. For #2 and #7 also, in
    the same turns: the wrapper (the tree's own trace_nearest_vpu, or
    trace_nearest_mm2 with its prepass and lists, from its ops/ modules
    loaded under their own names and bound to this build), the device-only
    time of the bare launch (`launches` launches in one CUDA graph, one
    replay between two events; not for #2 at 9,216 triangles, where the
    device binds) and the host's time to enqueue the wrapper and the bare
    launch. Every build's (hit, idx, t) must equal the first's and kernel
    #2's bit for bit (for #4 a ray off kernel #2 must be a proven slab knife
    edge, for #7 too, whose prepass lists a chunk by the block's slab tests),
    and every build's #5 mask the plain version's. Prints a line a
    case, each build's SASS instructions a row and ray of the row loops of
    #2, #4, #6, #7 and #8 and a box and ray slot of #5's box loop
    (utils/sass.py) and its issue floor on this run's work (the block
    vote's, or every warp-step's, for a build without the per-warp vote,
    else the plain models'), the plain models' s and w, and the builds'
    ptxas register and spill lines; returns {case: {build: sorted ms}}, and
    for #2 and #7 {case: {build: {reading: sorted ms}}}."""
    import ctypes

    import torch

    from software_rasterizer_tpu_torch.ops import intersect as ti
    from software_rasterizer_tpu_torch.ops import trace_kernel as tk
    from software_rasterizer_tpu_torch.ops import trace_tiers as tt
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
    from software_rasterizer_tpu_torch.utils import cuda_build, sass

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import slab_knife_edge_rays, stress_cornell

    card = card_line()
    dev = torch.device("cuda")
    n = WIDTH * HEIGHT
    block = tt.DEFAULT_BLOCK
    names = list(csrc_dirs)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, d in csrc_dirs.items():
        for lib_name, src in (("trace", "trace_culled.cu"), ("nearest", "trace_nearest.cu")):
            out = cuda_build.BUILD_DIR / f"ab_{lib_name}_{name}.so"
            procs[name, lib_name] = (out, subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                 str(pathlib.Path(d) / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (name, lib_name), (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"nvcc failed on {csrc_dirs[name]} ({lib_name}): {log}")
        (OUT_DIR / f"ab_{lib_name}_{name}_build.log").write_text(log)
    libs, nlibs, newer, cull_new, near_rays, mods = {}, {}, {}, {}, {}, {}
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    own = tt._cuda_lib()
    for name in names:
        lib = ctypes.CDLL(str(procs[name, "trace"][0]))
        newer[name] = hasattr(lib, "srt_trace_tally_entries")
        cull_new[name] = hasattr(lib, "srt_cull_tally_entries")
        if newer[name]:
            lib.srt_trace_listed.argtypes = own.srt_trace_listed.argtypes
            lib.srt_trace_unculled.argtypes = own.srt_trace_unculled.argtypes
        else:  # the interface before the boxes and the tally
            lib.srt_trace_listed.argtypes = [vp, ci, ci, vp, vp, cl, vp, vp, ci, ci, ci, vp,
                                             vp, vp, vp]
            lib.srt_trace_unculled.argtypes = [vp, ci, ci, vp, vp, ci, ci, vp, vp, vp, vp]
        if cull_new[name]:
            lib.srt_cull_prepass.argtypes = own.srt_cull_prepass.argtypes
            lib.srt_trace_fused_cull.argtypes = own.srt_trace_fused_cull.argtypes
        else:  # the interface before the super boxes of #5 and the tallies
            lib.srt_cull_prepass.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp, vp]
            lib.srt_trace_fused_cull.argtypes = [vp, ci, ci, vp, vp, ci, vp, vp, ci, vp, vp,
                                                 ci, ci, vp, vp, vp, vp]
        for fn in (lib.srt_trace_listed, lib.srt_trace_unculled, lib.srt_cull_prepass,
                   lib.srt_trace_fused_cull):
            fn.restype = ci
        libs[name] = lib
        nlib = ctypes.CDLL(str(procs[name, "nearest"][0]))
        # kernel #2: since its two-stage form it takes a tally and names its
        # ray slots a thread; before, one ray a thread and no tally
        if hasattr(nlib, "srt_trace_nearest_rays"):
            nlib.srt_trace_nearest_rays.argtypes = []
            nlib.srt_trace_nearest_rays.restype = ci
            near_rays[name] = nlib.srt_trace_nearest_rays()
            nlib.srt_trace_nearest.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, vp, vp]
        else:
            near_rays[name] = None
            nlib.srt_trace_nearest.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, vp]
        nlib.srt_trace_nearest.restype = ci
        nlibs[name] = nlib
        pkg = pathlib.Path(csrc_dirs[name]).resolve().parent
        mods[name] = (
            _tree_module(pkg / "ops" / "trace_kernel.py", f"ab_trace_kernel_{name}", nlib),
            _tree_module(pkg / "ops" / "trace_tiers.py", f"ab_trace_tiers_{name}", lib))

    def call2(name, rt, o_, d_, out):
        hit, idx, t = out
        a = (rt.tri_table.data_ptr(), rt.n_tri, o_.data_ptr(), d_.data_ptr(), o_.shape[0],
             hit.data_ptr(), idx.data_ptr(), t.data_ptr())
        strm = torch.cuda.current_stream().cuda_stream
        rc = nlibs[name].srt_trace_nearest(*a, *((None,) if near_rays[name] else ()), strm)
        if rc != 0:
            fail(f"ab {name}: trace_nearest launch failed: cudaError {rc}")

    def call4(name, rt, sup, o_, d_, out):
        hit, idx, t = out
        a = (rt.tri_table.data_ptr(), rt.tri_table.shape[0], rt.cull_chunk,
             rt.chunk_lo.data_ptr(), rt.chunk_hi.data_ptr(), rt.chunk_lo.shape[0],
             sup[0].data_ptr(), sup[1].data_ptr(), sup[0].shape[0], o_.data_ptr(),
             d_.data_ptr(), n, block, hit.data_ptr(), idx.data_ptr(), t.data_ptr())
        strm = torch.cuda.current_stream().cuda_stream
        rc = libs[name].srt_trace_fused_cull(*a, *((None,) if cull_new[name] else ()), strm)
        if rc != 0:
            fail(f"ab {name}: trace_fused_cull launch failed: cudaError {rc}")

    def call5(name, rt, sup, o_, d_, mask):
        lo_hi = (rt.chunk_lo.data_ptr(), rt.chunk_hi.data_ptr(), rt.chunk_lo.shape[0])
        rays_ = (o_.data_ptr(), d_.data_ptr(), n, block)
        strm = torch.cuda.current_stream().cuda_stream
        if cull_new[name]:
            rc = libs[name].srt_cull_prepass(*lo_hi, sup[0].data_ptr(), sup[1].data_ptr(),
                                             sup[0].shape[0], *rays_, mask.data_ptr(), None,
                                             strm)
        else:
            rc = libs[name].srt_cull_prepass(*lo_hi, *rays_, mask.data_ptr(), strm)
        if rc != 0:
            fail(f"ab {name}: cull_prepass launch failed: cudaError {rc}")

    def call6(name, rt, counts, lists, o_, d_, out, stream_rows=1):
        hit, idx, t = out
        strm = torch.cuda.current_stream().cuda_stream
        a = (rt.tri_table.data_ptr(), rt.tri_table.shape[0], rt.cull_chunk)
        tail = (o_.data_ptr(), d_.data_ptr(), n, block, stream_rows, hit.data_ptr(),
                idx.data_ptr(), t.data_ptr())
        if newer[name]:
            rc = libs[name].srt_trace_listed(*a, rt.chunk_lo.data_ptr(), rt.chunk_hi.data_ptr(),
                                             counts.data_ptr(), lists.data_ptr(),
                                             lists.shape[1], *tail, None, strm)
        else:
            rc = libs[name].srt_trace_listed(*a, counts.data_ptr(), lists.data_ptr(),
                                             lists.shape[1], *tail, strm)
        if rc != 0:
            fail(f"ab {name}: trace_listed launch failed: cudaError {rc}")

    def call8(name, rt, o_, d_, out):
        hit, idx, t = out
        strm = torch.cuda.current_stream().cuda_stream
        tail = [o_.data_ptr(), d_.data_ptr(), n, tt.MM_BLOCK, hit.data_ptr(), idx.data_ptr(),
                t.data_ptr()]
        if newer[name]:
            rc = libs[name].srt_trace_unculled(rt.tri_table.data_ptr(), rt.tri_table.shape[0],
                                               *tail, None, strm)
        else:
            rc = libs[name].srt_trace_unculled(rt.tri_table.data_ptr(), rt.tri_table.shape[0],
                                               tt._mm_chunk(rt.tri_table, tt.MM_MAX_CHUNK),
                                               *tail, strm)
        if rc != 0:
            fail(f"ab {name}: trace_unculled launch failed: cudaError {rc}")

    # the cases: (kernel, scene, rays)
    kinds = ("camera", "bounce")
    cases = [("#2", "cornell", k) for k in kinds] + [("#2", "mid", "camera")]
    cases += [("#4", "mid", k) for k in kinds]
    cases += [("#5", s_, k) for s_ in ("mid", "large") for k in kinds]
    cases += [("#6", "large", k) for k in kinds]
    cases += [("#7", "mid", k) for k in kinds]
    cases += [("#8", s_, k) for s_ in ("mid", "cornell") for k in kinds]
    makers = {"cornell": build_cornell_scene,
              "mid": lambda: stress_cornell(build_cornell_scene, subdivide_mesh,
                                            LARGE_LEVELS[0]),
              "large": lambda: stress_cornell(build_cornell_scene, subdivide_mesh,
                                              LARGE_LEVELS[1])}
    scenes = {}
    for sname in makers:
        scene = makers[sname]()
        scene.set_ndc_matrix(WIDTH, HEIGHT)
        rt = ti.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
        o, d = (x.contiguous() for x in camera_rays(
            rt.eye.cpu().numpy(), scene.fovy, WIDTH, HEIGHT, dev))
        _, o2, d2 = bounce_rays(rt, o, d)
        scenes[sname] = (rt, {"camera": (o, d), "bounce": (o2, d2)})

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SCHEDULERS_PER_SM * max_sm_clock_hz()
    # the row loops (instructions a row and ray slot) and #5's box loop
    # (instructions a box and ray slot): each kernel's library, the names
    # of its instance in each form (the first that a build holds), its ray
    # slots a thread (#2: the build's) and the counter
    loop_of = {"#2": ("nearest", ("trace_nearest_kernelILb1ELb0EE", "trace_nearest_kernelILb1EE"),
                      None, sass.row_loop),
               "#4": ("trace", ("trace_fused_cull_kernelILi1ELb0E", "trace_fused_cull_kernelILi1EE"),
                      1, sass.row_loop),
               "#5": ("trace", ("cull_prepass_kernelILi1ELb0E", "cull_prepass_kernelILi1EE"), 1,
                      sass.box_loop),
               "#6": ("trace", ("trace_listed_stream_kernelILi1ELb0E",
                                "trace_listed_stream_kernelILi1EE"), 1, sass.row_loop),
               "#7": ("trace", ("trace_listed_all_kernelILi1ELb0E", "trace_listed_kernelILi1EE"),
                      1, sass.row_loop),
               "#8": ("trace", ("trace_unculled_kernelILi4ELb0E", "trace_unculled_kernelILi4EE"),
                      4, sass.row_loop)}

    def slots(name, kern):
        """ray slots a thread of the measured instance of `kern` in build `name`"""
        return (near_rays[name] or 1) if kern == "#2" else loop_of[kern][2]

    loops = {}
    for name in names:
        for kern, (lib_name, pats, _, count) in loop_of.items():
            lib_path = procs[name, lib_name][0]
            fn_sass = None
            for p_ in pats:
                try:
                    fn_sass = sass.kernel_sass(lib_path, p_)
                    break
                except ValueError:
                    continue
            if fn_sass is None:
                fail(f"ab {name}: no single {' or '.join(pats)} in the SASS")
            rays = slots(name, kern)
            lp = loops[name, kern] = count(fn_sass, rays)
            mix = ", ".join(f"{o} {c / rays:g}" for o, c in lp["mix"].items())
            if kern == "#5":
                print(f"[ab] {name} {kern}: {lp['per_box_and_ray']:g} SASS instructions a box "
                      f"and ray slot (loop of {lp['span']}, {lp['votes']} votes an "
                      f"iteration): {mix}", flush=True)
            else:
                print(f"[ab] {name} {kern}: {lp['per_row'] / rays:g} SASS instructions a row "
                      f"and ray, {lp['skip'] / rays:g} of them skipped by a failed vote (loop "
                      f"of {lp['span']}, {lp['unroll']} rows an iteration, {rays} ray slots a "
                      f"thread): {mix}", flush=True)
    want = "|".join(re.escape(p_) for _, pats, _, _ in loop_of.values() for p_ in pats)
    for name in names:
        # ptxas's lines for the measured kernels (1 ray a thread, 4 for #8,
        # #2's own), without the tally
        kern, regs = None, []
        for lib_name in ("nearest", "trace"):
            log = (OUT_DIR / f"ab_{lib_name}_{name}_build.log").read_text()
            for ln in log.splitlines():
                m = re.search(rf"Compiling entry function '[^']*?({want})", ln)
                if "Compiling entry function" in ln:
                    kern = m.group(1) if m else None
                elif kern and ("registers" in ln or "spill" in ln):
                    regs.append(f"{kern}: {ln.split(':', 1)[-1].strip()}")
        print(f"[ab] {name} ptxas: " + "; ".join(regs), flush=True)

    any_new = any(cull_new.values())
    threads, r_ = tt.launch_shape(block)
    res = {}
    for kern, sname, kind in cases:
        rt, rays = scenes[sname]
        o_, d_ = rays[kind]
        nb, nc = -(-n // block), rt.chunk_lo.shape[0]
        sup = tt.super_bounds(rt.chunk_lo, rt.chunk_hi)
        rows_c = torch.clamp(rt.tri_table.shape[0] - rt.cull_chunk * torch.arange(
            nc, device=dev), max=rt.cull_chunk)
        extra, wrap = "", None
        if kern == "#5":
            ref = tt.cull_prepass_plain(rt.chunk_lo, rt.chunk_hi, o_, d_, block)
            # every warp votes on every chunk box (the flat loop), or the
            # two-level vote's super and chunk votes (its plain model)
            all_steps = two_level = nb * (threads // 32) * nc
            if any_new:
                _, cw = tt.cull_prepass_warp_plain(rt.chunk_lo, rt.chunk_hi, o_, d_, block)
                cwd = dict(zip(tt.CULL_TALLY_NAMES, cw))
                two_level = (cwd["warp_supers"] - cwd["warp_supers_unproven"]
                             + cwd["warp_chunk_votes"])
                proven = cwd["warp_supers"] - cwd["warp_supers_unproven"]
                extra = (f", plain model: {cwd['warp_supers_skipped']}/{proven} proven "
                         f"(warp, super) pairs skipped, {cwd['warp_supers_unproven']} "
                         f"unproven, slab tests a ray "
                         f"{(cwd['super_tests'] + cwd['chunk_tests']) / n:.2f} (flat {nc})")
            steps_of = {b: (two_level if cull_new[b] else all_steps, None) for b in names}

            def run(b, out):
                call5(b, rt, sup, o_, d_, out)
        else:
            ref = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
            if kern == "#2":
                if sname == "cornell":
                    p_ = tk.trace_nearest_vpu_plain(rt.tri_table, rt.n_tri, o_, d_)
                    if any(not torch.equal(x, y) for x, y in zip(ref, p_)):
                        fail(f"ab #2 {sname} {kind}: kernel #2 differs from its plain version")
                # every warp of every block sweeps every row with each of its
                # ray slots; the vote's passes from the plain model (its
                # tally), for a build that votes
                steps_of = {}
                for b in names:
                    sl = slots(b, kern)
                    warps = -(-n // (tk.NEAREST_THREADS * sl)) * (tk.NEAREST_THREADS // 32)
                    steps = warps * sl * rt.n_tri
                    voted = None
                    if near_rays[b]:
                        work = tt.nearest_tally_plain(rt.tri_table, rt.n_tri, o_, d_, rays=sl)
                        if work[0] != steps:
                            fail(f"ab #2: the model counts {work[0]} warp-steps, {steps} here")
                        voted = work[1]
                        extra += (f", plain model at {sl} ray slots a thread (build {b}) s "
                                  f"{voted / steps:.4f} ({voted}/{steps})")
                    steps_of[b] = (steps, voted)

                def run(b, out):
                    call2(b, rt, o_, d_, out)

                def wrap(b):
                    return mods[b][0].trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
            elif kern == "#4":
                # the block vote sweeps every row of a visited (block, chunk)
                # pair with every warp of the block
                visit = (tt._block_enters(rt.chunk_lo, rt.chunk_hi, o_, d_, block)
                         & tt._block_enters(*sup, o_, d_, block).repeat_interleave(
                             tt.MM2C_SUPER, dim=1)[:, :nc])
                all_steps = int((visit.long() * rows_c[None]).sum()) * (threads // 32) * r_
                work = tt.fused_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi, o_, d_,
                                           rt.cull_chunk, block)[1] if any_new else None
                steps_of = {b: ((work[0], work[1]) if cull_new[b] else (all_steps, None))
                            for b in names}
                if work is not None:
                    extra = (f", plain model s {work[1] / work[0]:.4f} ({work[1]}/{work[0]}), "
                             f"w {work[6] / work[5]:.4f} ({work[6]}/{work[5]})")

                def run(b, out):
                    call4(b, rt, sup, o_, d_, out)
            elif kern in ("#6", "#7"):
                mask = tt.cull_prepass(rt.chunk_lo, rt.chunk_hi, o_, d_, block)
                counts, lists = tt.chunk_lists(mask)
                # a build without the per-warp vote sweeps every listed chunk
                # with every warp of the block, as #7 always does
                all_steps = int((mask.long() * rows_c[None]).sum()) * (threads // 32) * r_
                if kern == "#6":
                    _, work = tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi,
                                                   counts, lists, o_, d_, rt.cull_chunk, block)
                    steps_of = {b: ((work[0], work[1]) if newer[b] else (all_steps, None))
                                for b in names}
                    extra = (f", plain model s {work[1] / work[0]:.4f} ({work[1]}/{work[0]}), "
                             f"w {work[6] / work[5]:.4f} ({work[6]}/{work[5]})")

                    def run(b, out):
                        call6(b, rt, counts, lists, o_, d_, out)
                else:
                    voted = None
                    if any(near_rays.values()):
                        _, work = tt.listed_warp_plain(rt.tri_table, rt.chunk_lo, rt.chunk_hi,
                                                       counts, lists, o_, d_, rt.cull_chunk,
                                                       block, vote=False)
                        if work[0] != all_steps:
                            fail(f"ab #7: the model counts {work[0]} warp-steps, "
                                 f"{all_steps} here")
                        voted = work[1]
                        extra = f", plain model s {voted / all_steps:.4f} ({voted}/{all_steps})"
                    # the two-stage form of #7 came with #2's (srt_trace_nearest_rays)
                    steps_of = {b: (all_steps, voted if near_rays[b] else None) for b in names}

                    def run(b, out):
                        call6(b, rt, counts, lists, o_, d_, out, stream_rows=0)

                    def wrap(b):
                        return mods[b][1].trace_nearest_mm2(rt.tri_table, rt.chunk_lo,
                                                            rt.chunk_hi, o_, d_,
                                                            chunk=rt.cull_chunk, block=block)
            else:
                work = tt.unculled_tally_plain(rt.tri_table, o_, d_, tt.MM_BLOCK)
                steps_of = {b: ((work[0], work[1]) if newer[b] else (work[0], None))
                            for b in names}
                extra = f", plain model s {work[1] / work[0]:.4f} ({work[1]}/{work[0]})"

                def run(b, out):
                    call8(b, rt, o_, d_, out)
        outs = {}
        for b in names:
            if kern == "#5":
                outs[b] = torch.empty((nb, nc), dtype=torch.uint8, device=dev)
            else:
                outs[b] = (torch.empty(n, dtype=torch.bool, device=dev),
                           torch.empty(n, dtype=torch.int64, device=dev),
                           torch.empty(n, dtype=torch.float32, device=dev))
            run(b, outs[b])
        torch.cuda.synchronize()
        knife = ""
        for b in names:
            if kern == "#5":
                if not torch.equal(outs[b], ref):
                    fail(f"ab #5 {sname} {kind}: {b}'s mask differs from the plain version "
                         f"in {int((outs[b] != ref).sum())} entries")
                continue
            off = (outs[b][0] != ref[0]) | (outs[b][1] != ref[1]) | (outs[b][2] != ref[2])
            if wrap is not None:
                w_ = wrap(b)
                off |= (w_[0] != ref[0]) | (w_[1] != ref[1]) | (w_[2] != ref[2])
            if kern in ("#4", "#7") and bool(off.any()):
                r = torch.nonzero(off).flatten()
                proof = slab_knife_edge_rays(
                    rt.chunk_lo.cpu().numpy(), rt.chunk_hi.cpu().numpy(), rt.cull_chunk,
                    o_[r].cpu().numpy(), d_[r].cpu().numpy(), ref[1][r].cpu().numpy())
                if not proof.all():
                    fail(f"ab #4 {sname} {kind}: {b} has {int((~proof).sum())} rays off "
                         f"kernel #2 that are no knife edge")
                knife += f"; {b}: {r.numel()} proven knife edges"
            elif bool(off.any()):
                fail(f"ab {kern} {sname} {kind}: {b}'s (hit, idx, t) differ from kernel #2")
        key = f"{kern} {sname} {kind}"
        # #2 and #7: the wrapper, the device-only time (not where the device
        # binds) and the host's enqueue beside the bare launch
        more = wrap is not None
        graphed = more and not (kern == "#2" and sname == "mid")
        graphs = {b: graph_of(lambda b=b: run(b, outs[b]), launches) for b in names} \
            if graphed else {}
        times = {b: {r: [] for r in ("bare", "wrapper", "device", "wrapper_host", "bare_host")}
                 for b in names}
        for rnd in range(rounds):
            for b in (names if rnd % 2 == 0 else names[::-1]):
                t = times[b]
                t["bare"] += cuda_times(lambda: run(b, outs[b]), repeats)
                if not more:
                    continue
                t["wrapper"] += cuda_times(lambda: wrap(b), repeats)
                if b in graphs:
                    t["device"] += replay_times(graphs[b], launches, repeats)
                t["wrapper_host"] += host_times(lambda: wrap(b), repeats)
                t["bare_host"] += host_times(lambda: run(b, outs[b]), repeats)
        del graphs
        if more:
            res[key] = {b: {r: sorted(v) for r, v in t.items() if v} for b, t in times.items()}
        else:
            res[key] = {b: sorted(t["bare"]) for b, t in times.items()}
        floors = []
        for b in names:
            lp = loops[b, kern]
            st, voted = steps_of[b]
            if kern == "#5":
                floors.append(f"{b} {lp['per_vote'] * st / rate * 1e3:.4f} ({st} votes)")
                continue
            rays = slots(b, kern)
            per, skip = lp["per_row"] / rays, lp["skip"] / rays
            fl = per * st - (skip * (st - voted) if voted is not None else 0.0)
            floors.append(f"{b} {fl / rate * 1e3:.4f} ({st} warp-steps)")
        what = "mask equal to the plain version's" if kern == "#5" else \
            "(hit, idx, t) equal to kernel #2's" + knife
        if more:
            readings = "; ".join(
                f"{b} " + ", ".join(f"{r.replace('_', ' ')} {spread(v)}"
                                    for r, v in res[key][b].items()) for b in names)
            what += " (the wrappers' too)"
        else:
            readings = ", ".join(f"{b} {spread(res[key][b])}" for b in names)
        print(f"[ab] {key} ({rt.n_tri} triangles, {n} rays, bare launch unless said, ms as "
              f"median [min-max] of {rounds * repeats} in turns, device-only over {launches} "
              f"launches of a CUDA graph, host: enqueue only, on {card}): " + readings
              + f"; {what}{extra}; issue floor ms " + ", ".join(floors), flush=True)
    return res


def graph_of(fn, launches: int):
    """`launches` calls of fn captured in one CUDA graph (after a warm-up
    call on the current stream and one on a side stream), replayed once."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def replay_times(g, launches: int, repeats: int) -> list:
    """Device-only ms a call of a graph of `launches` calls (`graph_of`):
    one replay between two events, over `launches`, `repeats` times. The
    host enqueues nothing between the calls, so none of its time counts."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


def device_times(fn, launches: int = 20, repeats: int = 5) -> list:
    """Device-only ms of fn() (`replay_times` of its graph), sorted."""
    return sorted(replay_times(graph_of(fn, launches), launches, repeats))


def host_times(fn, repeats: int = 5) -> list:
    """The host's ms to enqueue fn(): its wall time with the device
    drained before and not waited for, `repeats` times; unsorted."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return times


# the raster tile kernels of a tree whose raster_kernel.py names none: the
# parent's template instances and the shared-memory bytes a list entry of
# their walk reads (nine coefficients and the index)
PARENT_WALK = ({"fused": "raster_tile_kernelILb0E", "shaded": "raster_tile_kernelILb1E"}, 40)


def raster_ab(trees: dict, rounds: int = 4, repeats: int = 5, launches: int = 20,
              levels: int = RASTER_LEVELS) -> dict:
    """Times the raster tile kernels #10 (fused) and #11 (shaded) with
    their binning as built from other trees, in turns in one process on
    one card, at 1024x1024 on `raster_cornell` (36 x 4^levels triangles):

        python3 -c "import chip_smoke as c; c.raster_ab({'parent': 'DIR', 'this': '.'})"

    `trees` maps a name to the root of a tree that holds
    software_rasterizer_tpu_torch/ops/raster_kernel.py and csrc/raster_tiles.cu
    (e.g. an earlier commit unpacked under _checkout/). Each tree's module
    is loaded under its own name, bound to its own build of raster_tiles.cu
    (the package's nvcc flags), and called through its own entry points: a
    `launch_raster_tiles` that takes `lists` is fed by plain
    `bin_triangles`, else the tree bins on the card (`bin_triangles_device`).
    For each kernel and build: (a) the wrapper's event time, (b) the bare
    launch (events around one `launch_raster_tiles` call, its lists binned
    beforehand where it takes them), (c) the device-only time of the bare
    launch (`launches` launches in one CUDA graph, one replay between two
    events, over `launches`), (d) the binning alone, event and device-only,
    (e) the host's time to enqueue the wrapper and the bare launch;
    `rounds` rounds of `repeats`, the order of the builds reversed every
    other round. Every build's outputs must equal the first's bit for bit,
    and a device binning's lists plain `bin_triangles`' entry for entry.
    Prints a line a kernel with each build's SASS instructions a list entry
    and pixel of its walk loop (utils/sass.py walk_loop) and the issue floor
    on this frame's list entries, and the builds' ptxas lines; returns
    {kernel: {build: {reading: sorted ms}}}."""
    import ctypes
    import inspect

    import torch

    from software_rasterizer_tpu_torch.ops import raster as tr
    from software_rasterizer_tpu_torch.ops import raster_kernel as rk
    from software_rasterizer_tpu_torch.utils import cuda_build, sass

    card = card_line()
    dev = torch.device("cuda")
    H, W = HEIGHT, WIDTH
    names = list(trees)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pkg = "software_rasterizer_tpu_torch"
    procs = {}
    for name, root in trees.items():
        out = cuda_build.BUILD_DIR / f"ab_raster_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(pathlib.Path(root) / pkg / "csrc" / "raster_tiles.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    mods, libs = {}, {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"nvcc failed on {trees[name]}: {log}")
        (OUT_DIR / f"ab_raster_{name}_build.log").write_text(log)
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                print(f"[ab] {name}: {ln.strip()}", flush=True)
        mods[name] = _tree_module(pathlib.Path(trees[name]) / pkg / "ops" / "raster_kernel.py",
                                  f"ab_raster_kernel_{name}", ctypes.CDLL(str(out)))
        libs[name] = out

    def setup(variant):
        scene = raster_scene(variant, levels)
        scene.set_ndc_matrix(W, H)
        geom = tr.prepare_raster_geometry(scene.raster_geometry(), dev)
        frame = tr.prepare_raster_frame(scene.raster_frame(), dev)
        return tr.raster_tables(geom, frame), frame.lights.contiguous()

    tab5, _ = setup("five")
    tab3, lights3 = setup("three")
    th, tw = rk.TILE_H, rk.TILE_W
    gh, gw = -(-H // th), -(-W // tw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SCHEDULERS_PER_SM * max_sm_clock_hz()
    res = {}
    for kern, (geo, attr, bbox, keep), lights in (("fused", tab5, None),
                                                   ("shaded", tab3, lights3)):
        cap = min(2048, max(256, ((geo.shape[0] + 127) // 128) * 128))
        kw = dict(height=H, width=W, gh=gh, gw=gw, tile_h=th, tile_w=tw)
        ref_lists = rk.bin_triangles(bbox, keep, gh, gw, th, tw, cap)
        entries = int(ref_lists[1].sum())
        fns, outs, floors = {}, {}, []
        for b in names:
            mod = mods[b]
            if "lists" in inspect.signature(mod.launch_raster_tiles).parameters:
                lists, counts, _ = mod.bin_triangles(bbox, keep, gh, gw, th, tw, cap)

                def bare(mod=mod, lists=lists, counts=counts):
                    return mod.launch_raster_tiles(geo, attr, lists, counts, lights, **kw)

                def bins(mod=mod):
                    return mod.bin_triangles(bbox, keep, gh, gw, th, tw, cap)
            else:
                def bare(mod=mod):
                    return mod.launch_raster_tiles(geo, attr, bbox, keep, lights, cap=cap, **kw)

                def bins(mod=mod):
                    return mod.bin_triangles_device(bbox, keep, gh, gw, th, tw, cap)

                got = bins()
                if not all(torch.equal(x, y) for x, y in zip(got, ref_lists)):
                    fail(f"ab {kern}: {b}'s device lists differ from bin_triangles'")
            if lights is None:
                def wrap(mod=mod):
                    return mod.raster_tiles_fused(geo, attr, bbox, keep, H, W)
            else:
                def wrap(mod=mod):
                    return mod.raster_tiles_shaded(geo, attr, bbox, keep, lights, H, W)
            outs[b] = wrap()
            fns[b] = {"wrapper": wrap, "bare": bare, "binning": bins}
            walk = getattr(mod, "WALK_KERNELS", None)
            entry_bytes = getattr(mod, "WALK_ENTRY_BYTES", None)
            if walk is None:
                walk, entry_bytes = PARENT_WALK
            try:
                lp = sass.walk_loop(sass.kernel_sass(libs[b], walk[kern]), entry_bytes)
            except ValueError as e:
                floors.append(f"{b}: no walk loop found ({e})")
            else:
                fl = lp["per_entry"] * entries * (-(-th * tw // 32)) / rate * 1e3
                floors.append(f"{b} {fl:.4f} ms ({lp['per_entry']:g} SASS a list entry and "
                              f"pixel, {lp['unroll']} an iteration: " + ", ".join(
                                  f"{o} {c:g}" for o, c in lp["mix"].items()) + ")")
        torch.cuda.synchronize()
        first = outs[names[0]]
        for b in names[1:]:
            for key, x in outs[b].items():
                y = first[key]
                if x.is_floating_point():
                    x, y = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
                if not torch.equal(x, y):
                    fail(f"ab {kern}: {b}'s {key} differs from {names[0]}'s")
        graphs = {b: {r: graph_of(fns[b][r], launches) for r in ("bare", "binning")}
                  for b in names}
        times = {b: {r: [] for r in ("wrapper", "bare", "device", "binning", "binning_device",
                                     "wrapper_host", "bare_host")}
                 for b in names}
        for rnd in range(rounds):
            for b in (names if rnd % 2 == 0 else names[::-1]):
                t = times[b]
                t["wrapper"] += cuda_times(fns[b]["wrapper"], repeats)
                t["bare"] += cuda_times(fns[b]["bare"], repeats)
                t["device"] += replay_times(graphs[b]["bare"], launches, repeats)
                t["binning"] += cuda_times(fns[b]["binning"], repeats)
                t["binning_device"] += replay_times(graphs[b]["binning"], launches, repeats)
                t["wrapper_host"] += host_times(fns[b]["wrapper"], repeats)
                t["bare_host"] += host_times(fns[b]["bare"], repeats)
        del graphs
        res[kern] = {b: {r: sorted(v) for r, v in times[b].items()} for b in names}
        print(f"[ab] raster {kern} ({geo.shape[0]} triangles, {entries} list entries, "
              f"{W}x{H}, tile {th}x{tw}, ms as median [min-max] of {rounds * repeats} in "
              f"turns, device-only over {launches} launches of a CUDA graph, on {card}): "
              + "; ".join(f"{b} wrapper {spread(res[kern][b]['wrapper'])}, bare "
                          f"{spread(res[kern][b]['bare'])}, device-only "
                          f"{spread(res[kern][b]['device'])}, binning "
                          f"{spread(res[kern][b]['binning'])} (device-only "
                          f"{spread(res[kern][b]['binning_device'])}), host enqueue of the "
                          f"wrapper {spread(res[kern][b]['wrapper_host'])} and of the bare "
                          f"launch {spread(res[kern][b]['bare_host'])}" for b in names)
              + f"; outputs bit for bit equal to {names[0]}'s; issue floor of the walk: "
              + "; ".join(floors), flush=True)
    return res


def whitted_emitter_phases(dev, card: str) -> dict:
    """Phase 19: Whitted with two emitters. Returns the launches of its
    main path and the largest kernel-against-plain difference, to be
    merged into the Whitted kernel's entry of the JSON line."""
    import numpy as np
    import torch

    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.ops.whitted import whitted_render
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils.rng import prng_key, split

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import two_emitter_cornell

    n = WIDTH * HEIGHT
    md = WHITTED_DEPTH
    scene = two_emitter_cornell(models, build_cornell_scene)
    scene.set_ndc_matrix(WIDTH, HEIGHT)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
    if rt.n_emitters != 2:
        fail(f"the two-emitter scene has {rt.n_emitters} emitters")
    o, d = (x.contiguous() for x in camera_rays(
        rt.eye.cpu().numpy(), scene.fovy, WIDTH, HEIGHT, dev))

    max_err, lines, frames = 0.0, [], {}
    for spp in (1, WHITTED_EMITTER_SPP):
        k_rgb, k_nray = wk.whitted_uber_trace(rt, o, d, md, key=SEED, spp=spp)
        torch.cuda.synchronize()
        if k_rgb.shape != (n, 3) or not bool(torch.isfinite(k_rgb).all()):
            fail(f"two-emitter Whitted frame at spp {spp} has the wrong shape or values")
        # the whole frame, the plain version a quarter of the lanes at a time
        quarter = n // 4
        t0 = time.perf_counter()
        parts = [wk.whitted_uber_trace_plain(
            rt, o[off:off + quarter], d[off:off + quarter], md, key=SEED,
            spp=spp, lane_offset=off) for off in range(0, n, quarter)]
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        c = compare_whitted(k_rgb, k_nray, torch.cat([p[0] for p in parts]),
                            torch.cat([p[1] for p in parts], dim=1))
        max_err = max(max_err, c["max_abs_err"])
        lines.append(f"spp {spp}: {c['bad']}/{c['n']} pixels differ over the full "
                     f"frame (plain {plain_s:.1f}s), mean rel {c['mean_rel']:.2e}, "
                     f"rays main/shadow {c['k_rays'][0]}/{c['k_rays'][1]} vs "
                     f"{c['p_rays'][0]}/{c['p_rays'][1]}, frame mean "
                     f"{float(k_rgb.mean()):.6f}")
        if (c["bad"] > (1.0 - PIX_SHARE) * c["n"] or c["mean_rel"] > MEAN_RTOL
                or c["rays_rel"] > RAYS_RTOL):
            fail(f"two-emitter Whitted kernel disagrees with plain: {lines[-1]}")
        frames[spp] = k_rgb
    if torch.equal(frames[1], frames[WHITTED_EMITTER_SPP]):
        fail("the emitter picks do not depend on spp")

    # main path through the normal entry point, default device
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=WHITTED_EMITTER_SPP, seed=SEED)
    render = pipeline_from_config(cfg, "whitted")
    mscene = two_emitter_cornell(models, build_cornell_scene)
    render.add_scene(mscene)
    wk.LAUNCHES = 0
    render.draw()
    torch.cuda.synchronize()
    launches = wk.LAUNCHES
    png = OUT_DIR / "chip_smoke_whitted_two_emitters.png"
    render.save(str(png))
    first = render.frame.copy()
    st = dict(render.last_stats[mscene.name])
    if render.device.type != dev.type or launches != 1:
        fail(f"RayTracing.draw() of two emitters on {render.device}: {launches} launches")
    if first.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(first).all():
        fail("the two-emitter frame has the wrong shape or non-finite values")
    if st["dropped_rays"] != 0 or st["rays_main"] <= n:
        fail(f"two-emitter last_stats {st}")
    # the first scene drawn uses the second half of the split key
    ref = whitted_render(rt, WIDTH, HEIGHT, scene.fovy, seed=split(prng_key(SEED))[1],
                         spp=WHITTED_EMITTER_SPP, max_depth=mscene.max_depth)
    if not np.array_equal(first, ref.cpu().numpy()):
        fail("RayTracing.draw() differs from whitted_render under the split key")
    render.draw()
    if np.array_equal(first, render.frame):
        fail("two draws of one RayTracing picked the same emitters")

    times = []
    for spp in (1, WHITTED_EMITTER_SPP):
        t_wrap = cuda_times(lambda: wk.whitted_uber_trace(
            rt, o, d, md, key=SEED, spp=spp), 20)
        args, kw = wk.whitted_launch_args(rt, o, d, md, key=SEED, spp=spp)
        t_bare = cuda_times(lambda: wk.launch_whitted_uber(*args, **kw), 20)
        times.append(f"spp {spp}: wrapper {spread(t_wrap)}, bare launch {spread(t_bare)}")
    phase(19, f"Whitted, Cornell with a mirror, a glass sphere and two emitters, "
              f"{WIDTH}x{HEIGHT} max_depth {md}, kernel vs plain: " + "; ".join(lines)
              + f"; max_abs_err {max_err:.3g}; pipeline_from_config(cfg, \"whitted\") "
              f"on {render.device} -> RayTracing.draw -> {png.name}: launches "
              f"{launches}, last_stats {st}, equal to whitted_render under the "
              f"split key, a second draw differs; ms as median [min-max] of 20 on "
              f"{card}: " + "; ".join(times))
    return {"launches": launches, "max_abs_err": max_err}


def shard_scenes(dev):
    """Phase 30's scenes at WIDTH x HEIGHT on `dev`, as each rank builds
    them for itself: name -> (device scene, fovy); "raster" -> (geometry,
    frame, active shader types)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import stress_cornell, two_emitter_cornell

    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.ops import raster as tr
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh

    def rt_of(scene):
        scene.set_ndc_matrix(WIDTH, HEIGHT)
        return prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev), scene.fovy

    rscene = raster_scene("three")
    rscene.set_ndc_matrix(WIDTH, HEIGHT)
    host = rscene.raster_geometry()
    return {
        "cornell": rt_of(build_cornell_scene()),
        "large": rt_of(stress_cornell(build_cornell_scene, subdivide_mesh, LARGE_LEVELS[0])),
        "two": rt_of(two_emitter_cornell(models, build_cornell_scene)),
        "raster": (tr.prepare_raster_geometry(host, dev),
                   tr.prepare_raster_frame(rscene.raster_frame(), dev),
                   tuple(sorted(set(int(t) for t in host.shader_type)))),
    }


# phase 30's cases: name -> (mesh, scene, kind, spp); kind "path", "whitted",
# "raster" or "raster_shaded"
SHARD_CASES = {
    "path": ((1, SHARD_RANKS), "cornell", "path", SPP),
    "path_spp": ((2, SHARD_RANKS // 2), "cornell", "path", SPP),
    "path_large": ((1, SHARD_RANKS), "large", "path", SHARD_LARGE_SPP),
    "whitted": ((1, SHARD_RANKS), "cornell", "whitted", 1),
    "whitted_two": ((1, SHARD_RANKS), "two", "whitted", 1),
    "whitted_two_spp": ((2, SHARD_RANKS // 2), "two", "whitted", WHITTED_EMITTER_SPP),
    "whitted_large": ((1, SHARD_RANKS), "large", "whitted", 1),
    "raster": ((1, SHARD_RANKS), "raster", "raster", 1),
    "raster_shaded": ((2, SHARD_RANKS // 2), "raster", "raster_shaded", 1),
}


def shard_rank_cases(device: str = "cuda") -> dict:
    """Phase 30 on one rank of the group (every rank runs it): each case
    through the port's sharded render with the launch counts set to 0
    just before and read just after; then, for each case and in step
    with the other ranks, the times (CUDA events, SHARD_REPS each) of
    this rank's kernel call on its own slice, of the sharded call, and of
    the sharded call's collectives alone on tensors of the same shapes.
    Rank 0 returns the frames; every rank their digests."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import raster as tr
    from software_rasterizer_tpu_torch.ops import raster_kernel as rk
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.camera import camera_rays
    from software_rasterizer_tpu_torch.ops.path_kernel import path_camera_render
    from software_rasterizer_tpu_torch.ops.whitted_kernel import whitted_uber_trace
    from software_rasterizer_tpu_torch.parallel import (
        make_render_mesh,
        process_info,
        sharded_path_render,
        sharded_raster_render,
        sharded_whitted_render,
    )
    from software_rasterizer_tpu_torch.parallel.multihost import gather_rows

    info = process_info()
    rank = info["process_index"]
    meshes = {shape: make_render_mesh(*shape, device=device) for shape in
              {c[0] for c in SHARD_CASES.values()}}
    dev = next(iter(meshes.values())).device
    scenes = shard_scenes(dev)
    counters = {"#1": (pk, "LAUNCHES"), "#1b": (pk, "LAUNCHES_CULLED"),
                "#9": (wk, "LAUNCHES"), "#9b": (wk, "LAUNCHES_CULLED"),
                "#10": (rk, "LAUNCHES"), "#11": (rk, "LAUNCHES_SHADED")}
    n = WIDTH * HEIGHT
    out = {"info": info, "device": str(dev), "frames": {}, "digests": {},
           "launches": {}, "stats": {}, "ms": {},
           "coords": {s: (m.spp_index, m.tile_index) for s, m in meshes.items()}}

    def sync_barrier():
        torch.cuda.synchronize()
        dist.barrier()

    def event_ms(fn) -> float:
        sync_barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for name, (shape, scene_name, kind, spp) in SHARD_CASES.items():
        m = meshes[shape]
        if kind == "path":
            rt, fovy = scenes[scene_name]
            lanes, spp_per = n // m.n_tile, spp // m.n_spp

            def call():
                return sharded_path_render(rt, m, WIDTH, HEIGHT, fovy, SEED, spp=spp,
                                           max_bounces=MAX_BOUNCES)

            def own():
                return path_camera_render(rt, SEED, WIDTH, HEIGHT, fovy, spp_per,
                                          start_sample=m.spp_index * spp_per,
                                          lane_offset=m.tile_index * lanes, n_lanes=lanes,
                                          max_bounces=MAX_BOUNCES)

            piece = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)

            def collectives():
                t = piece.clone()
                if m.n_spp > 1:
                    dist.all_reduce(t, group=m.group("spp"))
                return gather_rows(t, m.group("tile")) if m.n_tile > 1 else t
        elif kind == "whitted":
            rt, fovy = scenes[scene_name]
            lanes = n // m.n_devices
            o, d = camera_rays(rt.eye.cpu().numpy(), fovy, WIDTH, HEIGHT, dev)
            o = o[m.index * lanes:(m.index + 1) * lanes].contiguous()
            d = d[m.index * lanes:(m.index + 1) * lanes].contiguous()

            def call():
                return sharded_whitted_render(rt, m, WIDTH, HEIGHT, fovy, SEED, spp=spp,
                                              max_depth=WHITTED_DEPTH, with_stats=True)

            def own():
                return whitted_uber_trace(rt, o, d, WHITTED_DEPTH, key=SEED, spp=spp,
                                          lane_offset=m.index * lanes)

            piece = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)
            counts = torch.zeros(2, dtype=torch.int64, device=dev)

            def collectives():
                dist.all_reduce(counts.clone(), group=m.group())
                return gather_rows(piece, m.group())
        else:
            geom, frame, active = scenes["raster"]
            shaded = kind == "raster_shaded"
            shard_h = HEIGHT // m.n_devices

            def call():
                return sharded_raster_render(geom, frame, m, HEIGHT, WIDTH,
                                             active_types=active, shaded=shaded,
                                             with_stats=True)

            def own():
                return tr.render_raster_frame(geom, frame, shard_h, WIDTH,
                                              active_types=active, shaded=shaded,
                                              row0=m.index * shard_h)

            img_piece = torch.zeros((shard_h, WIDTH, 3), dtype=torch.float32, device=dev)
            z_piece = torch.zeros((shard_h, WIDTH), dtype=torch.float32, device=dev)
            dropped = torch.zeros((), dtype=torch.int32, device=dev)

            def collectives():
                dist.all_reduce(dropped.clone(), group=m.group())
                return gather_rows(img_piece, m.group()), gather_rows(z_piece, m.group())

        sync_barrier()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        res = call()
        torch.cuda.synchronize()
        out["launches"][name] = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()
                                 if getattr(mod, attr)}
        if kind == "path":
            arrays = {"image": res}
        elif kind == "whitted":
            arrays = {"image": res[0]}
            out["stats"][name] = {k: int(v.sum()) for k, v in res[1].items()}
        else:
            arrays = {"image": res[0], "z": res[1]}
            out["stats"][name] = {"bin_dropped": int(res[2]["bin_dropped"]),
                                  "kernel": res[2]["kernel"]}
        arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
        out["digests"][name] = {k: hashlib.sha256(v.tobytes()).hexdigest()
                                for k, v in arrays.items()}
        if rank == 0:
            out["frames"][name] = arrays

        own()
        call()
        collectives()
        out["ms"][name] = {
            "own": [event_ms(own) for _ in range(SHARD_REPS)],
            "call": [event_ms(call) for _ in range(SHARD_REPS)],
            "collectives": [event_ms(collectives) for _ in range(SHARD_REPS)],
        }
    return out


def nccl_probe() -> float:
    """One all-reduce in an NCCL group (phase 30 runs it with two ranks on
    the one card, where NCCL refuses them)."""
    import torch
    import torch.distributed as dist

    t = torch.ones(1, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t)


def sharding_phase(dev, card: str) -> None:
    """Phase 30: the sharded renders of parallel/ on SHARD_RANKS ranks
    that share this card (see the module docstring)."""
    import numpy as np
    import torch

    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import raster as tr
    from software_rasterizer_tpu_torch.ops.path import path_render
    from software_rasterizer_tpu_torch.ops.whitted import whitted_render

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_shards import run_ranks

    torch.cuda.empty_cache()   # the earlier phases' cached blocks, for the ranks
    t0 = time.perf_counter()
    ranks = run_ranks(SHARD_RANKS, shard_rank_cases, (dev.type,), device=dev.type,
                      timeout=600)
    group_s = time.perf_counter() - t0
    info = ranks[0]["info"]
    if info["process_count"] != SHARD_RANKS or info["backend"] != "gloo":
        fail(f"sharding: process_info {info}: expected {SHARD_RANKS} ranks on gloo "
             f"(ranks sharing one card)")
    for r, res in enumerate(ranks):
        for shape, coord in res["coords"].items():
            if coord != (r // shape[1], r % shape[1]):
                fail(f"sharding: rank {r} at {coord} on the {shape} mesh")
    coords = "; ".join(f"rank {r} on {res['device']}: " + ", ".join(
        f"{s[0]}x{s[1]} {c}" for s, c in sorted(res["coords"].items()))
        for r, res in enumerate(ranks))
    phase(30, f"sharding on one card: {SHARD_RANKS} ranks, backend {info['backend']} "
              f"(parallel.initialize's rule: {SHARD_RANKS} ranks share "
              f"{torch.cuda.device_count()} card), world {info['process_count']}, "
              f"(spp, tile) coordinates {coords}; group spawned and run in {group_s:.1f}s")

    scenes = shard_scenes(dev)
    frames = ranks[0]["frames"]
    refs, lines = {}, []
    for name, (shape, scene_name, kind, spp) in SHARD_CASES.items():
        for r, res in enumerate(ranks[1:], 1):
            if res["digests"][name] != ranks[0]["digests"][name]:
                fail(f"sharding {name}: rank {r}'s frame differs from rank 0's")
        want_kernel = {"path": "#1b" if scene_name == "large" else "#1",
                       "whitted": "#9b" if scene_name == "large" else "#9",
                       "raster": "#10", "raster_shaded": "#11"}[kind]
        launches = [res["launches"][name] for res in ranks]
        if any(lc != {want_kernel: 1} for lc in launches):
            fail(f"sharding {name}: launches per rank {launches}, expected "
                 f"{{'{want_kernel}': 1}} on each")
        got = frames[name]
        extra = ""
        if kind == "path":
            rt, fovy = scenes[scene_name]
            mono = functools.partial(path_render, rt, WIDTH, HEIGHT, fovy, SEED, spp=spp,
                                     max_bounces=MAX_BOUNCES)
            want = mono().cpu().numpy()
            if shape[0] == 1:
                same = np.array_equal(got["image"], want)
                extra = "== path_render bit for bit"
            else:
                half = spp // shape[0]
                parts = [pk.path_camera_render(rt, SEED, WIDTH, HEIGHT, fovy, half,
                                               start_sample=s0, max_bounces=MAX_BOUNCES).T
                         for s0 in range(0, spp, half)]
                psum = parts[0]
                for part in parts[1:]:
                    psum = psum + part
                psum = (psum / float(spp)).reshape(HEIGHT, WIDTH, 3).cpu().numpy()
                same = np.array_equal(got["image"], psum)
                extra = (f"== the {shape[0]} partial sums bit for bit; max |diff| from "
                         f"path_render {np.abs(got['image'] - want).max():.3g}")
            if not same:
                fail(f"sharding {name}: the frame differs: {extra}")
            extra += f"; {WIDTH * HEIGHT // shape[1]} lanes x {spp // shape[0]} spp a rank"
        elif kind == "whitted":
            rt, fovy = scenes[scene_name]
            mono = functools.partial(whitted_render, rt, WIDTH, HEIGHT, fovy, SEED, spp=spp,
                                     max_depth=WHITTED_DEPTH, with_stats=True)
            img, st = mono()
            st = {k: int(v.sum()) for k, v in st.items()}
            if not np.array_equal(got["image"], img.cpu().numpy()):
                fail(f"sharding {name}: the frame differs from whitted_render")
            if ranks[0]["stats"][name] != st:
                fail(f"sharding {name}: stats {ranks[0]['stats'][name]} != {st}")
            extra = f"== whitted_render bit for bit, stats {st} equal"
        else:
            geom, frame, active = scenes["raster"]
            shaded = kind == "raster_shaded"
            mono = functools.partial(tr.render_raster_frame, geom, frame, HEIGHT, WIDTH,
                                     active_types=active, shaded=shaded, with_stats=True)
            img, z, st = mono()
            if not (np.array_equal(got["image"], img.cpu().numpy())
                    and np.array_equal(got["z"], z.cpu().numpy())):
                fail(f"sharding {name}: image or z differs from the whole frame")
            mine = ranks[0]["stats"][name]
            if mine["kernel"] != st["kernel"]:
                fail(f"sharding {name}: kernel {mine['kernel']} != {st['kernel']}")
            extra = (f"image and z == the whole frame bit for bit ({st['kernel']}); "
                     f"bin_dropped summed over the ranks {mine['bin_dropped']}, whole "
                     f"frame {int(st['bin_dropped'])}; shard_h "
                     f"{HEIGHT // SHARD_RANKS}")
        refs[name] = mono
        lines.append(f"{name} {shape[0]}x{shape[1]} ({scene_name}, spp {spp}, "
                     f"{want_kernel} x1 a rank): {extra}")
    print("[phase 30] " + "; ".join(lines), flush=True)

    times = []
    for name, mono in refs.items():
        mono_ms = statistics.median(cuda_times(mono, SHARD_REPS))
        per = {k: [statistics.median(res["ms"][name][k]) for res in ranks]
               for k in ("own", "call", "collectives")}
        times.append(f"{name}: rank kernel call {min(per['own']):.3f}-{max(per['own']):.3f}, "
                     f"sharded call {min(per['call']):.3f}-{max(per['call']):.3f}, "
                     f"collectives alone {min(per['collectives']):.3f}-"
                     f"{max(per['collectives']):.3f}; single rank {mono_ms:.3f}")
    print(f"[phase 30] 4 ranks sharing one H100: the cost of sharding, not scaling; "
          f"ms, the lowest-highest of the ranks' medians of {SHARD_REPS} (CUDA events) on "
          f"{card}: " + "; ".join(times), flush=True)

    try:
        run_ranks(NCCL_PROBE_RANKS, nccl_probe, device="cuda", timeout=180,
                  backend="nccl")
        nccl = f"NCCL accepted {NCCL_PROBE_RANKS} ranks on one card"
    except RuntimeError as e:  # the refusal is what the probe records
        said = [ln.strip() for ln in str(e).splitlines()
                if "Duplicate GPU" in ln or "ncclInvalidUsage" in ln or "NCCL error" in ln]
        nccl = ("NCCL refused: " + " | ".join(said) if said
                else "failed otherwise: " + str(e).strip().splitlines()[-1])
    print(f"[phase 30] {NCCL_PROBE_RANKS} ranks on one card with backend nccl: {nccl}",
          flush=True)


def png_pixels(path):
    """(H,W,3) uint8 of a PNG as `utils/image_io.write_png` writes it (8-bit
    RGB, unfiltered scanlines): read without PIL, which the card's machine
    may lack."""
    import struct
    import zlib

    import numpy as np

    data = pathlib.Path(path).read_bytes()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        fail(f"{path}: filtered scanlines")
    return raw[:, 1:].reshape(h, w, 3)


def host_layer_phase(dev, card: str, scenes: dict) -> None:
    """Phase 31: the host layer and the entry point. On phase 20's two
    stress scenes, the native and Python `build_bvh` over the scene's
    triangles in scene order (what `Scene.rt_geometry` builds over): host
    seconds, node order, leaf order and boxes equal, `area` within rtol
    1e-6. `debug_mode` around a Cornell `PathTracing.draw()`,
    `RayTracing.draw()` and `TraditionalRasterizer.draw()` on the card
    (none raises), and around a path draw of Cornell with a NaN in one
    material's kd (FloatingPointError from the camera kernel's wrapper).
    `profiling.trace` around one Cornell path draw: its summary lists
    `path_camera_kernel`. `examples/cornell_pt` at CORNELL_PT_SIZE, 16 spp
    on the card, single shot, --batch 4 with a checkpoint and --tiles 4:
    each writes a PNG with a finite, nonzero mean, through its kernels."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.examples import cornell_pt
    from software_rasterizer_tpu_torch.ops import bvh as tb
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import raster_kernel as rk
    from software_rasterizer_tpu_torch.ops import trace_kernel as tk
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils import profiling
    from software_rasterizer_tpu_torch.utils.debug import debug_mode

    sys.path.insert(0, str(ROOT / "tests"))
    # ---- the BVH builds
    lines = []
    for name, sc in scenes.items():
        g = sc["scene"].rt_geometry(bvh_order=False)
        tv = g.positions[g.faces[g.face_valid]]
        lo, hi = tb.primitive_bounds(tv[:, 0], tv[:, 1], tv[:, 2])
        areas = tb.triangle_areas(tv[:, 0], tv[:, 1], tv[:, 2])
        secs = {}
        for use_native in (True, False):
            t0 = time.perf_counter()
            secs[use_native] = (tb.build_bvh(lo, hi, areas, use_native=use_native),
                                time.perf_counter() - t0)
        (nat, nat_s), (py, py_s) = secs[True], secs[False]
        same = all(np.array_equal(getattr(nat, f), getattr(py, f))
                   for f in ("bb_min", "bb_max", "left", "right", "prim"))
        if not same or not np.array_equal(tb.leaf_order(nat), tb.leaf_order(py)) \
                or not np.allclose(nat.area, py.area, rtol=1e-6, atol=0.0):
            fail(f"{name}: the native BVH differs from the Python one")
        rel = float(np.max(np.abs(nat.area - py.area) / np.abs(py.area)))
        lines.append(f"{name}: {tv.shape[0]} triangles, native {nat_s:.4f} s, Python "
                     f"{py_s:.4f} s ({py_s / nat_s:.1f}x); node and leaf order and boxes "
                     f"equal, area max rel {rel:.2e} in {int((nat.area != py.area).sum())}/"
                     f"{nat.area.size} nodes")
    phase(31, "build_bvh on the host (phase 20's scenes in scene order): " + "; ".join(lines))

    # ---- phase 20's host work (stress_cornell -> prepare_rt_scene on the
    # card) on the native paths, as phase 20 takes it, and on the Python
    # BVH build and OBJ scan, the route before utils/native.py; in turns
    import software_rasterizer_tpu_torch.scenes.cornell as cornell_mod
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
    from torch_scenes import stress_cornell

    def host_s(levels, use_native):
        saved = tb.build_bvh, cornell_mod.load_obj_source
        if not use_native:
            tb.build_bvh = functools.partial(saved[0], use_native=False)
            cornell_mod.load_obj_source = functools.partial(saved[1], use_native=False)
        try:
            t0 = time.perf_counter()
            scene = stress_cornell(build_cornell_scene, subdivide_mesh, levels)
            scene.set_ndc_matrix(WIDTH, HEIGHT)
            prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            tb.build_bvh, cornell_mod.load_obj_source = saved

    lines = []
    for name, levels in zip(scenes, LARGE_LEVELS):
        got = {True: [], False: []}
        for use_native in (True, False, False, True):
            got[use_native].append(host_s(levels, use_native))
        lines.append(f"{name}: native " + " / ".join(f"{t:.3f}" for t in got[True])
                     + " s, Python " + " / ".join(f"{t:.3f}" for t in got[False]) + " s")
    phase(31, "phase 20's host work (stress_cornell -> prepare_rt_scene, BVH leaf order "
              "included), in turns native, Python, Python, native: " + "; ".join(lines))

    # ---- debug_mode on the card
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=MAX_BOUNCES,
                       seed=SEED)
    counts = {}
    for kind, mod in (("path", pk), ("whitted", wk), ("raster", rk)):
        render = pipeline_from_config(cfg, kind, device="cuda")
        render.add_scene(build_cornell_scene())
        mod.LAUNCHES = 0
        with debug_mode():
            render.draw()
        torch.cuda.synchronize()
        counts[kind] = mod.LAUNCHES
        if mod.LAUNCHES < 1 or not np.isfinite(render.frame).all():
            fail(f"debug_mode {kind} draw: {mod.LAUNCHES} launches, finite "
                 f"{bool(np.isfinite(render.frame).all())}")
    bad = build_cornell_scene()
    bad.get_mesh_obj("left").material.Kd = (float("nan"), 0.0, 0.0)
    render = pipeline_from_config(cfg, "path", device="cuda")
    render.add_scene(bad)
    try:
        with debug_mode():
            render.draw()
        fail("debug_mode: a NaN kd on the card raised nothing")
    except FloatingPointError as e:
        raised = str(e)
    if "path_camera_render" not in raised:
        fail(f"debug_mode: the NaN was reported from elsewhere: {raised}")
    phase(31, f"debug_mode around Cornell draw() on the card, {WIDTH}x{HEIGHT}: path, "
              f"Whitted, raster silent (launches {counts}); a NaN kd raises "
              f"FloatingPointError: {raised}")

    # ---- profiling.trace around a Cornell path draw
    render = pipeline_from_config(cfg, "path", device="cuda")
    render.add_scene(build_cornell_scene())
    render.draw()  # warm-up outside the trace
    log_dir = OUT_DIR / "profile"
    with profiling.trace(str(log_dir)):
        render.draw()
    rows = profiling.summarize_device_time(str(log_dir), top=8)
    if not any("path_camera_kernel" in r[0] for r in rows):
        fail(f"profiling: no path_camera_kernel among {rows}")
    phase(31, f"profiling.trace around PathTracing.draw() {WIDTH}x{HEIGHT} {SPP} spp, top "
              "kernels (device s, count): " + "; ".join(
                  f"{n[:60]} {s:.6f} x{c}" for n, s, c in rows[:5]))

    # ---- the entry point, in its three modes
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for mode, extra in (("single shot", []),
                            ("batch 4", ["--batch", "4", "--ckpt", f"{tmp}/ck.npz"]),
                            ("tiles 4", ["--tiles", "4"])):
            out = OUT_DIR / f"cornell_pt_{mode.replace(' ', '_')}.png"
            before = (pk.LAUNCHES, pk.LAUNCHES_BOUNCE, tk.LAUNCHES)
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                frame = cornell_pt.main(["--width", str(CORNELL_PT_SIZE), "--height",
                                         str(CORNELL_PT_SIZE), "--spp", "16",
                                         "--out", str(out), *extra])
            torch.cuda.synchronize()
            launched = [a - b for a, b in zip((pk.LAUNCHES, pk.LAUNCHES_BOUNCE,
                                               tk.LAUNCHES), before)]
            png = png_pixels(out)
            if frame.shape != (CORNELL_PT_SIZE, CORNELL_PT_SIZE, 3) \
                    or not np.isfinite(frame).all() or not frame.mean() > 0 \
                    or not png.mean() > 0 or not sum(launched):
                fail(f"cornell_pt {mode}: frame {frame.shape}, mean {frame.mean()}, "
                     f"PNG mean {png.mean()}, launches {launched}")
            timing = [ln for ln in said.getvalue().splitlines() if " spp on " in ln]
            lines.append(f"{mode}: mean {frame.mean():.5f} (PNG {png.mean():.2f}), "
                         f"launches camera/bounce/trace {launched}, {timing[-1]}")
    phase(31, f"cornell_pt {CORNELL_PT_SIZE}x{CORNELL_PT_SIZE} 16 spp on the card "
              f"({card}): " + "; ".join(lines))


if __name__ == "__main__":
    sys.exit(main())
