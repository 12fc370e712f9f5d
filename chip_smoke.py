"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two pipelines at full width (1024x1024) through their
hand-written CUDA kernels, and holds each kernel against its plain
PyTorch version: Cornell-box path tracing at 16 spp, and Whitted ray
tracing at max_depth 5. Phases, one line each; any failure exits
non-zero:

  1. device: CUDA present, card name and power limit, both kernels
     built at once (one nvcc each);
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
  9. Whitted times of the kernel and the plain version (CUDA events).

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
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.ops.path import path_render
    from software_rasterizer_tpu_torch.render import pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils.cuda_build import BUILD_LOGS

    OUT_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 1. device + build (one nvcc per kernel, started together)
    t0 = time.perf_counter()
    errors = []

    def build(mod):
        try:
            mod.build_kernel()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m,)) for m in (pk, wk)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    build_s = time.perf_counter() - t0
    ptxas = []
    for name in ("path_camera", "whitted_uber"):
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

    whitted = whitted_phases(dev, card)

    print(json.dumps({"kernels": [{
        "name": "path_camera",
        "route": "cuda",
        "source": "software_rasterizer_tpu_torch/csrc/path_camera.cu",
        "replaces": "software_rasterizer_tpu/ops/pallas_path.py:940",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, whitted]}))
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
        times[name] = (k_ms, p_ms)
        phase(9, f"Whitted {name}: kernel {k_ms:.3f} ms ({n / k_ms / 1e3:.2f} M "
                 f"primary rays/s; bare launch {bare_ms:.3f} ms, median of 20), "
                 f"plain {p_ms:.1f} ms ({n / p_ms / 1e3:.4f} M "
                 f"primary rays/s; {how}, median of 3 after warm-up) at "
                 f"{WIDTH}x{HEIGHT} max_depth {md} on {card}")

    k_ms, p_ms = times["cornell"]
    return {
        "name": "whitted_uber",
        "route": "cuda",
        "source": "software_rasterizer_tpu_torch/csrc/whitted_uber.cu",
        "replaces": "software_rasterizer_tpu/ops/pallas_whitted.py:173",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }


if __name__ == "__main__":
    sys.exit(main())
