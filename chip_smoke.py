"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three pipelines and its explicit-ray layer at full
width (1024x1024) through their hand-written CUDA kernels, and holds each
kernel against its plain PyTorch version: Cornell-box path tracing at 16
spp, Whitted ray tracing at max_depth 5, the rasterizer on a lit,
tessellated Cornell box of 9,216 triangles, the wavefront path
integrator on the frame's 1,048,576 camera rays as explicit tensors, and
the nearest hits of those rays on the box tessellated to 9,216 and to
147,456 triangles through the chunk-culled trace tiers.
Phases, one line each; any failure exits non-zero:

  1. device: CUDA present, card name and power limit, the six CUDA
     libraries built at once (one nvcc each);
  2. path: kernel vs plain on three 4096-lane windows of the full frame;
  3. path golden: 48x48 at 8 spp against tests/goldens path_mean;
  4. path main path: pipeline_from_config -> PathTracing.draw() -> save(),
     accumulate 8 + 8 == draw, and the kernel launch count;
  5. path times of the kernel and the plain version (CUDA events);
  6. Whitted: kernel vs plain on Cornell, Cornell with a mirror and a
     glass sphere, and Cornell with a textured back wall;
  7. Whitted golden: 64x64 at max_depth 4 against tests/goldens whitted;
  8. Whitted main path: pipeline_from_config -> RayTracing.draw() ->
     save(), one kernel launch, the frame and stats of phase 6;
  9. Whitted times of the kernel and the plain version (CUDA events);
 10. raster: the fused tile kernel vs plain on the whole frame (winners,
     depth, attribute planes, ids);
 11. raster: the shaded tile kernel vs plain on the whole frame, and the
     shaded image against the deferred one;
 12. raster golden: Cornell 96x96 against tests/goldens raster / raster_z;
 13. raster main path: pipeline_from_config(cfg, "raster") on the default
     device -> TraditionalRasterizer.draw() -> save(), deferred and
     shaded, and draw_batch() of 8 turned frames; launch counts,
     bin_dropped, coverage; then the batch against 8 draw()s;
 14. raster times (CUDA events, median and range): the frame, the bare
     launch of each kernel, the stages around it, draw_batch per frame,
     and the plain versions;
 15. trace: the nearest-triangle kernel vs plain on all camera rays and
     on as many bounce rays from their hit points (winners and t
     identical), and `nearest_hit` over the kernel against `nearest_hit`
     over the plain version, field by field;
 16. bounce: the fused bounce kernel vs plain on the whole frame's state
     at 1 bounce and at 16 (acc, live and state lane for lane);
 17. wavefront main path: camera rays -> path_render_accumulate on the
     default device, 16 samples (16 + 16 launches), against the camera
     kernel's frame of phase 4 and the golden; PathTracing.draw() of
     Cornell with a textured light through pipeline_from_config, and at
     one bounce every pixel on the light a texel exactly; the
     plain wavefront (fused=False) on a quarter frame, nothing dropped;
 18. wavefront times (CUDA events, median and range): both kernels bare
     and wrapped, nearest_hit and path_trace whole, the host's share,
     Mpaths/s beside the camera kernel's, the plain versions, the bounds;
 19. Whitted with two emitters: kernel vs plain on the whole frame at
     spp 1 and 4, RayTracing.draw() through pipeline_from_config, two draws
     differ, times beside the one-emitter frame;
 20. large scenes: the tessellated Cornell boxes and their chunk tables
     on the card, camera rays and bounce rays from their hit points;
 21. the cull prepass kernel vs plain: the whole (ray block, chunk) mask
     on both scenes and both ray sets, and the share that survives;
 22. the fused-cull, listed and streamed kernels: (hit, idx, t) bit for
     bit against the unculled trace kernel over the whole table and
     against their own plain versions, at every ray-block size (a ray that
     differs must be a proven knife edge of the slab test, and is printed);
 23. large-scene main path: nearest_hit, nearest_emit_hit and classify_hit
     with no backend named take the fused-cull kernel at 9,216 triangles
     and the prepass + streamed kernel at 147,456 (launch counts), every
     field equal to backend="vpu"; backend="mm2" takes the listed kernel;
 24. large-scene times (CUDA events, median and range): each kernel bare
     and wrapped, the list build, the unculled kernel on the same rays,
     nearest_hit whole, the ray-block sizes, one path_trace sample by both
     routes, and the bounds from this run's own masks.

The last lines are a JSON line of per-kernel results (time beside the
card's bound for the same work; the Whitted kernel's `launches` is phase
8's main path and `launches_two_emitters` phase 19's), the card's
`nvidia-smi` name and power limit, and `{"ok": true, "device": ...}`.
Images go to chiprun_out/ under the repository root.
"""

from __future__ import annotations

import json
import pathlib
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
# the card's published peaks (H100 SXM data sheet): float32 outside the
# tensor cores, and device memory
FP32_PEAK = 67e12
HBM_RATE = 3.35e12


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


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    k_ms = cuda_ms(lambda: pk.path_camera_render(*args, **kw))
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
    bare_ms = cuda_ms(lambda: pk.launch_path_camera(
        *operands, n_tri=rt.n_tri, n_sph=n_sph, n_emitters=rt.n_emitters,
        lane_offset=0, n_lanes=n, width=WIDTH, height=HEIGHT, **kw))
    phase(5, f"kernel {k_ms:.3f} ms ({paths / k_ms / 1e3:.2f} Mpaths/s; bare "
             f"launch {bare_ms:.3f} ms), "
             f"plain {p_ms:.1f} ms ({paths / p_ms / 1e3:.3f} Mpaths/s; {how}) "
             f"at {WIDTH}x{HEIGHT} {SPP} spp on {card}")

    # the kernel's bound: each lane-iteration intersects two rays with
    # every primitive (~80 float32 operations a triangle, ~40 a sphere)
    # and spends ~300 on sampling and shading; the tables and the (3,N)
    # sum are the only bytes
    path_bound, path_by = bound(
        tensor_bytes(rt.tri_table, attr_t, sph_t, rt.emitter_cr, full) + 4 * SPP + 32,
        work["lane_iterations"] * (80 * rt.n_tri + 40 * n_sph + 300))
    print(f"[phase 5] bound {path_bound:.4f} ms by {path_by} "
          f"({work['lane_iterations']} lane-iterations of this frame)", flush=True)

    whitted = whitted_phases(dev, card)
    raster = raster_phases(dev, card)
    cam_mean = float(torch.clamp(full.T / float(SPP), 0, 1).mean())
    wavefront = wavefront_phases(dev, card, cam_mean, paths / k_ms / 1e3)
    picks = whitted_emitter_phases(dev, card)
    tiers = large_scene_phases(dev, card)
    whitted["launches_two_emitters"] = picks["launches"]
    whitted["max_abs_err"] = max(whitted["max_abs_err"], picks["max_abs_err"])

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
    }, whitted, *raster, *wavefront, *tiers]}))
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
        tri, attr, sph, n_tri, n_sph = wk.pack_whitted_tables(r["rt"])
        ops = (tri, attr, sph, wk.whitted_scalars(r["rt"], wk.SHADOW_BIAS),
               r["rt"].textures.contiguous(), r["rt"].tex_wh.contiguous(),
               r["o"], r["d"])
        bare_ms = cuda_ms(lambda: wk.launch_whitted_uber(
            *ops, n_tri=n_tri, n_sph=n_sph, max_depth=md), repeats=20)
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
    tri, attr, sph, n_tri, n_sph = wk.pack_whitted_tables(r["rt"])
    w_bound, w_by = bound(
        tensor_bytes(tri, attr, sph, r["o"], r["d"], r["rgb"]) + 8 * n + 32,
        (main_rays + shadow_rays) * (30 * n_tri + 25 * n_sph) + 200 * shadow_rays)
    phase(9, f"Whitted cornell bound {w_bound:.4f} ms by {w_by}")
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
    }


def raster_scene(variant: str):
    """The lit, tessellated Cornell box of tests/torch_scenes.py, built
    with the port's models."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import raster_cornell

    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.ops.shading import ShaderType
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
    from software_rasterizer_tpu_torch.utils.texture import Texture

    return raster_cornell(models, build_cornell_scene, subdivide_mesh,
                          ShaderType, Texture, RASTER_LEVELS, variant)


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

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenes import set_raster_cornell_angle

    H, W = HEIGHT, WIDTH
    n = H * W

    def setup(variant):
        scene = raster_scene(variant)
        scene.set_ndc_matrix(W, H)
        host = scene.raster_geometry()
        geom = tr.prepare_raster_geometry(host, dev)
        frame = tr.prepare_raster_frame(scene.raster_frame(), dev)
        active = tuple(sorted(set(int(t) for t in host.shader_type)))
        return scene, geom, frame, active, tr.raster_tables(geom, frame)

    def check(name, c):
        line = (f"{name}: winners differ on {c['winners']}/{c['n']} pixels, any "
                f"output on {c['any']}, {c['bad']} outside rtol={RASTER_RTOL} "
                f"atol={RASTER_ATOL}, max |diff| {c['max_abs_err']:.3g}, "
                f"bin_dropped {c['dropped'][0]} / {c['dropped'][1]}")
        if (c["winners"] > (1.0 - RASTER_SHARE) * c["n"] or c["bad"] > 0
                or c["dropped"] != (0, 0)):
            fail(f"raster kernel disagrees with plain: {line}")
        return line

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
    phase(10, f"raster fused kernel vs plain {W}x{H}, {n_faces} triangles, "
              f"coverage {coverage:.4f}, whole frame (plain {plain_f_s:.2f}s): "
              + check("five shaders", c_f))

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
              f"{plain_s_s:.2f}s): " + check("three shaders", c_s)
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

    # ---- 13. main path through the normal entry point, default device
    angles = [8.0 + 5.0 * i for i in range(RASTER_BATCH)]
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
    phase(13, f"pipeline_from_config(cfg, \"raster\") on {render.device} -> draw -> "
              f"{png5.name} / {png3.name}: coverage {cov_d:.4f} (>= "
              f"{RASTER_COVERAGE_MIN}), mean {frame_d.mean():.5f} / "
              f"{render_s.frame.mean():.5f}, launches fused {launches} shaded "
              f"{launches_s}, bin_dropped 0, equal to phases 10 and 11; "
              f"draw_batch of {RASTER_BATCH} turned frames bit-identical to "
              f"{RASTER_BATCH} draws")

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
    th, tw = rk.TILE_H, rk.TILE_W
    gh, gw = -(-H // th), -(-W // tw)
    cap = min(2048, max(256, ((tab5[0].shape[0] + 127) // 128) * 128))
    t_bin = cuda_times(lambda: rk.bin_triangles(tab5[2], tab5[3], gh, gw, th, tw, cap), reps)
    kw = dict(height=H, width=W, gh=gh, gw=gw, tile_h=th, tile_w=tw)
    lists5, counts5, _ = rk.bin_triangles(tab5[2], tab5[3], gh, gw, th, tw, cap)
    lists3, counts3, _ = rk.bin_triangles(tab3[2], tab3[3], gh, gw, th, tw, cap)
    t_wrap_f = cuda_times(lambda: rk.raster_tiles_fused(*tab5, H, W), reps)
    t_wrap_s = cuda_times(lambda: rk.raster_tiles_shaded(*tab3, lights, H, W), reps)
    t_bare_f = cuda_times(lambda: rk.launch_raster_tiles(
        tab5[0], tab5[1], lists5, counts5, None, **kw), reps)
    t_bare_s = cuda_times(lambda: rk.launch_raster_tiles(
        tab3[0], tab3[1], lists3, counts3, lights, **kw), reps)
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
              f"tables {spread(t_tables)}, binning {spread(t_bin)}, fused wrapper "
              f"(binning + launch) {spread(t_wrap_f)} with the bare launch "
              f"{spread(t_bare_f)}, shaded wrapper {spread(t_wrap_s)} with the "
              f"bare launch {spread(t_bare_s)}, "
              f"deferred shading {spread(t_shade_d)}, texel quadratic "
              f"{spread(t_shade_s)}; draw_batch per frame {spread(t_batch)} "
              f"(5 batches of {RASTER_BATCH}); one draw() with its copy to the "
              f"host {draw_wall:.1f} ms wall; plain fused {spread(t_plain_f)}, "
              f"plain shaded {spread(t_plain_s)} (3 each)")

    # the wrappers' bounds: ~21 float32 operations a pixel and list entry in
    # the walk, ~60 to interpolate a covered pixel, and for the shaded
    # kernel ~30 + 70 a light on top; the four operand tables read once,
    # every output plane written once (the lists are an intermediate)
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
    phase(14, f"bounds: fused {b_f:.4f} ms by {by_f} ({entries5} list entries, mean "
              f"{entries5 / (gh * gw):.1f} a tile, longest {int(counts5.max())}), "
              f"shaded {b_s:.4f} ms by {by_s}")

    common = {"route": "cuda",
              "source": "software_rasterizer_tpu_torch/csrc/raster_tiles.cu",
              "library_ms": None}
    return [
        {"name": "raster_tiles",
         "replaces": "software_rasterizer_tpu/ops/pallas_raster.py:86",
         "launches": launches, "max_abs_err": c_f["max_abs_err"],
         "ms": med(t_wrap_f), "bare_ms": med(t_bare_f),
         "plain_ms": med(t_plain_f),
         "bound_ms": b_f, "bound_by": by_f, **common},
        {"name": "raster_tiles_shaded",
         "replaces": "software_rasterizer_tpu/ops/pallas_raster.py:167",
         "launches": launches_s, "max_abs_err": c_s["max_abs_err"],
         "ms": med(t_wrap_s), "bare_ms": med(t_bare_s),
         "plain_ms": med(t_plain_s),
         "bound_ms": b_s, "bound_by": by_s, **common},
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
    trace_err, lines = 0.0, []
    for name, (o_, d_) in {"camera": (o, d), "bounce": (o2, d2)}.items():
        k = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
        torch.cuda.synchronize()
        p = tk.trace_nearest_vpu_plain(rt.tri_table, rt.n_tri, o_, d_)
        if k[0].shape != (n,) or k[1].dtype != torch.int64 or k[2].dtype != torch.float32:
            fail(f"trace kernel outputs have the wrong shape or type on {name} rays")
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
        lines.append(f"{name} rays: {bad}/{n} differ in (hit, idx, t), "
                     f"{int(k[0].sum())} hit; nearest_hit fields differ on "
                     f"{int(off.sum())} rays" + (f" ({', '.join(fields)})" if fields else ""))
        if bad > allowed or int(off.sum()) > allowed:
            fail(f"trace kernel disagrees with plain: {lines[-1]}")
    phase(15, f"trace kernel vs plain, {rt.n_tri} triangles: " + "; ".join(lines)
              + f"; max |t diff| {trace_err:.3g}")

    # ---- 16. bounce kernel vs plain on the whole frame's state
    state = tp.primary_state(hit).contiguous()
    live = hit.hit.contiguous()
    seed = int(key_bits(fold_in(fold_in(SEED, 0), 0)))   # sample 0, block 0
    bounce_err, lines = 0.0, []
    lane_bounces, plain_bounce_ms = {}, {}
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
    phase(16, f"bounce kernel vs plain on {n} lanes (rtol={LANE_RTOL} "
              f"atol={LANE_ATOL}): " + "; ".join(lines)
              + f"; max_abs_err {bounce_err:.3g}")

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
    t_trace = cuda_times(lambda: tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o, d), reps)
    t_trace2 = cuda_times(lambda: tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o2, d2), reps)
    t_nh = cuda_times(lambda: ti.nearest_hit(rt, o, d), reps)
    t_state = cuda_times(lambda: tp.primary_state(hit), reps)
    t_bounce_bare = cuda_times(lambda: bare_bounce(MAX_BOUNCES), reps)
    t_bounce_bare1 = cuda_times(lambda: bare_bounce(1), reps)
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
              f"bare {spread(t_trace_bare)}, wrapper {spread(t_trace)} on camera rays "
              f"and {spread(t_trace2)} on bounce rays; nearest_hit whole "
              f"{spread(t_nh)}; state stack {spread(t_state)}; bounce kernel bare "
              f"{spread(t_bounce_bare)} at {MAX_BOUNCES} bounces and "
              f"{spread(t_bounce_bare1)} at 1, wrapper {spread(t_bounce)}; path_trace "
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
    # the state read and written once, live and the (3,N) sum beside it
    b_t, by_t = bound(tensor_bytes(rt.tri_table, o, d) + 13 * n,
                      58.0 * n * rt.n_tri)
    b_b, by_b = bound(
        tensor_bytes(tri, attr, sph, ecr, live) + 2 * tensor_bytes(state) + 13 * n,
        lane_bounces[MAX_BOUNCES] * (80.0 * rt.n_tri + 40.0 * n_sph + 300.0))
    phase(18, f"bounds: trace {b_t:.4f} ms by {by_t}, bounce {b_b:.4f} ms by {by_b} "
              f"({lane_bounces[MAX_BOUNCES]} lane-bounces of this frame)")
    return [
        {"name": "trace_nearest", "route": "cuda",
         "source": "software_rasterizer_tpu_torch/csrc/trace_nearest.cu",
         "replaces": "software_rasterizer_tpu/ops/pallas_trace.py:431",
         "launches": launches[0], "max_abs_err": trace_err,
         "ms": med(t_trace), "bare_ms": med(t_trace_bare),
         "plain_ms": med(t_trace_plain), "bound_ms": b_t, "bound_by": by_t,
         "library_ms": None},
        {"name": "path_bounce", "route": "cuda",
         "source": "software_rasterizer_tpu_torch/csrc/path_bounce.cu",
         "replaces": "software_rasterizer_tpu/ops/pallas_path.py:635",
         "launches": launches[1], "max_abs_err": bounce_err,
         "ms": med(t_bounce), "bare_ms": med(t_bounce_bare),
         "plain_ms": plain_bounce_ms[MAX_BOUNCES], "bound_ms": b_b,
         "bound_by": by_b, "library_ms": None},
    ]


def large_scene_phases(dev, card: str) -> list:
    """Phases 20-24: nearest hits of explicit rays on large scenes, the
    Cornell box tessellated to 9,216 and to 147,456 triangles. Returns
    the entries of the four chunk-culled kernels for the JSON line."""
    import torch

    from software_rasterizer_tpu_torch.ops import intersect as ti
    from software_rasterizer_tpu_torch.ops import path as tp
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

    def wall_ms(fn):
        """fn() once: (its result, wall ms with the device drained)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

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
        # bounce rays from the hit points, as phase 15 makes them
        hit = ti.nearest_hit(rt, o, d, backend="vpu")
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        w = torch.randn((n, 3), generator=gen, device=dev)
        w = w / torch.sqrt((w * w).sum(dim=1, keepdim=True))
        w = torch.where(((w * hit.normal).sum(dim=1) < 0)[:, None], -w, w)
        o2 = torch.where(hit.hit[:, None], hit.coords + 1e-6 * hit.normal, o).contiguous()
        d2 = torch.where(hit.hit[:, None], w, d).contiguous()
        scenes[name] = dict(scene=scene, rt=rt, rays={"camera": (o, d), "bounce": (o2, d2)},
                            backend=ti._trace_backend(f_pad))
        lines.append(f"{name}: {rt.n_tri} triangles ({f_pad} rows), nc {rt.chunk_lo.shape[0]} "
                     f"at granule {rt.cull_chunk}, tier {scenes[name]['backend']}, "
                     f"{int(hit.hit.sum())}/{n} camera rays hit, host {host_s:.2f}s")
    if scenes["mid"]["backend"] != "mm2c" or scenes["large"]["backend"] != "mm2s":
        fail(f"tiers by triangle count: {lines}")
    phase(20, "stress_cornell -> prepare_rt_scene on the card, 1,048,576 camera rays "
              "and as many bounce rays: " + "; ".join(lines))

    # ---- 21. the cull prepass against its plain version
    lines, cull_bad, cull_plain_ms, masks = [], 0, {}, {}
    for name, sc in scenes.items():
        rt = sc["rt"]
        for kind, (o_, d_) in sc["rays"].items():
            k = tt.cull_prepass(rt.chunk_lo, rt.chunk_hi, o_, d_, block)
            torch.cuda.synchronize()
            p_, cull_plain_ms[name, kind] = wall_ms(lambda: tt.cull_prepass_plain(
                rt.chunk_lo, rt.chunk_hi, o_, d_, block))
            if k.shape != (-(-n // block), rt.chunk_lo.shape[0]) or k.dtype != torch.uint8:
                fail(f"cull mask has shape {tuple(k.shape)} and type {k.dtype}")
            bad = int((k != p_).sum())
            cull_bad += bad
            masks[name, kind] = k
            lines.append(f"{name} {kind}: {bad}/{k.numel()} mask entries differ, "
                         f"{float(k.float().mean()):.4f} of the (block, chunk) pairs "
                         f"survive, plain {cull_plain_ms[name, kind]:.0f} ms")
    if cull_bad:
        fail("cull prepass kernel disagrees with plain: " + "; ".join(lines))
    phase(21, f"cull prepass kernel vs plain, blocks of {block} rays: " + "; ".join(lines))

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
    o_, d_ = scenes["mid"]["rays"]["camera"]
    ref = tk.trace_nearest_vpu(rt.tri_table, rt.n_tri, o_, d_)
    a = (rt.tri_table, rt.chunk_lo, rt.chunk_hi, o_, d_)
    for b in BLOCK_SIZES:
        for tier, fn in (("mm2c", tt.trace_nearest_mm2c), ("mm2", tt.trace_nearest_mm2),
                         ("mm2s", tt.trace_nearest_mm2_stream)):
            off = differing(fn(*a, chunk=rt.cull_chunk, block=b), ref)
            if bool((off & ~explained["mid", "camera"]).any()):
                fail(f"{tier} at block={b}: {int(off.sum())} rays differ from kernel #2")
    phase(22, f"tiers vs kernel #2 over the whole table and vs their plain versions, "
              f"(hit, idx, t) bit for bit, blocks of {block} rays: " + "; ".join(lines)
              + f"; blocks of {BLOCK_SIZES} rays give the same on the mid scene")

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
        t = {
            "mm2c bare": cuda_times(lambda: tt.launch_trace_fused_cull(
                *a, lo2, hi2, o_, d_, **kw), reps),
            "mm2c": cuda_times(lambda: tt.trace_nearest_mm2c(*a, o_, d_, **kw), reps),
            "cull": cuda_times(lambda: tt.cull_prepass(
                rt.chunk_lo, rt.chunk_hi, o_, d_, block), reps),
            "lists": cuda_times(lambda: tt.chunk_lists(mask), reps),
            "mm2 bare": cuda_times(lambda: tt.launch_trace_listed(
                rt.tri_table, counts_, lists_, o_, d_, **kw), reps),
            "mm2": cuda_times(lambda: tt.trace_nearest_mm2(*a, o_, d_, **kw), reps),
            "mm2s bare": cuda_times(lambda: tt.launch_trace_listed(
                rt.tri_table, counts_, lists_, o_, d_, stream=True, **kw), reps),
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
              f"cull=False of 3) on {card}: " + "; ".join(times))

    # one sample of the wavefront on the large scene, both routes
    rt = scenes["large"]["rt"]
    lo_ = n // 2 - PLAIN_WAVE_LANES // 2
    po, pd = (x[lo_:lo_ + PLAIN_WAVE_LANES] for x in scenes["large"]["rays"]["camera"])
    kw = dict(p_rr=scenes["large"]["scene"].rr, max_bounces=MAX_BOUNCES)
    (plain_r, st), plain_ms = wall_ms(lambda: tp.path_trace(
        rt, po, pd, SEED, fused=False, with_stats=True, **kw))
    fused_r, fused_ms = wall_ms(lambda: tp.path_trace(rt, po, pd, SEED, fused=True, **kw))
    pm = float(torch.clamp(plain_r, 0, 1).mean())
    fm = float(torch.clamp(fused_r, 0, 1).mean())
    if int(st["dropped_lanes"]) != 0 or not bool(torch.isfinite(plain_r).all()) \
            or not bool(torch.isfinite(fused_r).all()) or abs(pm - fm) / fm > 0.05:
        fail(f"path_trace on the large scene: dropped {int(st['dropped_lanes'])}, "
             f"clipped means {pm} (fused=False) and {fm} (fused=True)")
    phase(24, f"path_trace, one sample of {PLAIN_WAVE_LANES} lanes on {rt.n_tri} "
              f"triangles (wall ms, once each): fused=False {plain_ms:.1f} (nearest_hit "
              f"over the tiers, dropped_lanes 0, clipped mean {pm:.5f}), fused=True "
              f"{fused_ms:.1f} (the bounce kernel sweeps every triangle, clipped mean "
              f"{fm:.5f})")

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
    b5, by5 = bound(tensor_bytes(large.chunk_lo, large.chunk_hi, o_, d_,
                                 masks["large", "camera"]),
                    21.0 * n * large.chunk_lo.shape[0])
    phase(24, f"bounds: mm2c (mid) {b4:.4f} ms by {by4} ({tests4:.3g} tests), cull "
              f"prepass (large) {b5:.4f} ms by {by5}, mm2s (large) {b6:.4f} ms by {by6} "
              f"({tests6:.3g} tests), mm2 (mid) {b7:.4f} ms by {by7}")

    src = "software_rasterizer_tpu_torch/csrc/trace_culled.cu"
    jax_file = "software_rasterizer_tpu/ops/pallas_trace.py"
    tm, tl = entries_ms["mid"], entries_ms["large"]

    def entry(name, line, n_launches, err, ms, bare, plain_ms, b, by):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"{jax_file}:{line}", "launches": n_launches,
                "max_abs_err": err, "ms": ms, "bare_ms": bare, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "library_ms": None}

    return [
        entry("trace_fused_cull", 235, launches[0], tier_err["mm2c"], med(tm["mm2c"]),
              med(tm["mm2c bare"]), tier_plain_ms["mid", "camera", "mm2c"], b4, by4),
        entry("cull_prepass", 559, launches[1], float(cull_bad), med(tl["cull"]),
              med(tl["cull"]), cull_plain_ms["large", "camera"], b5, by5),
        entry("trace_listed_stream", 801, launches[3], tier_err["mm2s"], med(tl["mm2s"]),
              med(tl["mm2s bare"]), tier_plain_ms["large", "camera", "mm2s"], b6, by6),
        entry("trace_listed", 634, launches[2], tier_err["mm2"], med(tm["mm2"]),
              med(tm["mm2 bare"]), tier_plain_ms["mid", "camera", "mm2"], b7, by7),
    ]


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

    tri, attr, sph, n_tri, n_sph = wk.pack_whitted_tables(rt)
    ops = (tri, attr, sph, wk.whitted_scalars(rt, wk.SHADOW_BIAS),
           rt.textures.contiguous(), rt.tex_wh.contiguous(), o, d)
    ecr = rt.emitter_cr.float().contiguous()
    times = []
    for spp in (1, WHITTED_EMITTER_SPP):
        seeds = torch.as_tensor(wk.pick_seed_table(SEED, md, spp), device=dev)
        t_wrap = cuda_times(lambda: wk.whitted_uber_trace(
            rt, o, d, md, key=SEED, spp=spp), 20)
        t_bare = cuda_times(lambda: wk.launch_whitted_uber(
            *ops, n_tri=n_tri, n_sph=n_sph, max_depth=md, ecr=ecr,
            pick_seeds=seeds, n_emitters=rt.n_emitters), 20)
        times.append(f"spp {spp}: wrapper {spread(t_wrap)}, bare launch {spread(t_bare)}")
    phase(19, f"Whitted, Cornell with a mirror, a glass sphere and two emitters, "
              f"{WIDTH}x{HEIGHT} max_depth {md}, kernel vs plain: " + "; ".join(lines)
              + f"; max_abs_err {max_err:.3g}; pipeline_from_config(cfg, \"whitted\") "
              f"on {render.device} -> RayTracing.draw -> {png.name}: launches "
              f"{launches}, last_stats {st}, equal to whitted_render under the "
              f"split key, a second draw differs; ms as median [min-max] of 20 on "
              f"{card}: " + "; ".join(times))
    return {"launches": launches, "max_abs_err": max_err}


if __name__ == "__main__":
    sys.exit(main())
