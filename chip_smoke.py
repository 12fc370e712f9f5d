"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, Cornell-box path tracing, at its full
width (1024x1024, 16 spp) through the hand-written CUDA kernel, and
holds the kernel against its plain PyTorch version. Phases, one line
each; any failure exits non-zero:

  1. device: CUDA present, card name and power limit, kernel build;
  2. kernel vs plain on three 4096-lane windows of the full frame;
  3. golden: 48x48 at 8 spp against tests/goldens path_mean;
  4. main path: pipeline_from_config -> PathTracing.draw() -> save(),
     accumulate 8 + 8 == draw, and the kernel launch count;
  5. times of the kernel and the plain version (CUDA events).

The last lines are a JSON line of per-kernel results, the card's
`nvidia-smi` name and power limit, and `{"ok": true, "device": ...}`.
Images go to chiprun_out/ under the repository root.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
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


def cuda_ms(fn, repeats: int = 3) -> float:
    """Median wall time of fn() on the device (CUDA events), after one
    warm-up call."""
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
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.ops.path import path_render
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils.cuda_build import BUILD_LOGS

    OUT_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 1. device + build
    t0 = time.perf_counter()
    pk.build_kernel()
    build_s = time.perf_counter() - t0
    log = BUILD_LOGS.get("path_camera", "")
    (OUT_DIR / "path_camera_build.log").write_text(log)
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
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
    pk.path_camera_render_plain(*args, **kw)
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
    phase(5, f"kernel {k_ms:.3f} ms ({paths / k_ms / 1e3:.2f} Mpaths/s), "
             f"plain {p_ms:.1f} ms ({paths / p_ms / 1e3:.3f} Mpaths/s; {how}) "
             f"at {WIDTH}x{HEIGHT} {SPP} spp on {card}")

    print(json.dumps({"kernels": [{
        "name": "path_camera",
        "route": "cuda",
        "source": "software_rasterizer_tpu_torch/csrc/path_camera.cu",
        "replaces": "software_rasterizer_tpu/ops/pallas_path.py:940",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
