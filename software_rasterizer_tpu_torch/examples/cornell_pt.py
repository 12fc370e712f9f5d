"""Cornell Box path tracing — the README's path-tracing walkthrough
(README.md:478-560: PathTracing render, Cornell parts, 16-2048 spp), the
port of the JAX package's examples/cornell_pt.py.

Usage: python -m software_rasterizer_tpu_torch.examples.cornell_pt
       [--width 256] [--height 256] [--spp 16] [--out cornell.png]
       [--cpu]       (render on the CPU; the default is the card, and
                      without one the run raises)
       [--ckpt PATH] [--batch N]   (renders progressively in N-sample
                      batches, checkpointing after each; an existing
                      checkpoint resumes at its sample count)
       [--config cfg.json]  (RenderConfig JSON; CLI flags override)
       [--tiles N]   (render via N restartable tile jobs with retries)

The render is timed by `utils.metrics.MetricsRecorder`, which waits for
the card; the first run of a process includes the kernels' build.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Render, write the PNG and return the frame (H,W,3) float32."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--batch", type=int, default=0,
                    help="progressive batch size (0 = single shot)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "cornell.png"))
    ap.add_argument("--ckpt", default="", help="checkpoint path for resume")
    ap.add_argument("--config", default="", help="RenderConfig JSON file")
    ap.add_argument("--tiles", type=int, default=0,
                    help="render as N restartable tile jobs (TileJobRunner)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from software_rasterizer_tpu_torch.config import RenderConfig
    from software_rasterizer_tpu_torch.render import Primitive, pipeline_from_config
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils.metrics import MetricsRecorder

    device = "cpu" if args.cpu else "cuda"
    # config layer: file defaults, CLI overrides (SURVEY.md 5.6)
    if args.config:
        with open(args.config) as f:
            cfg = RenderConfig.from_json(f.read())
    else:
        cfg = RenderConfig()
    cfg.width, cfg.height, cfg.spp = args.width, args.height, args.spp
    render = pipeline_from_config(cfg, "path", device=device)
    scene = build_cornell_scene()
    render.add_scene(scene)
    rec = MetricsRecorder()

    t0 = time.perf_counter()
    with rec.timed("path", scene.name, args.width, args.height, args.spp):
        if args.tiles:
            from software_rasterizer_tpu_torch.ops.camera import camera_rays
            from software_rasterizer_tpu_torch.ops.path import path_render_accumulate
            from software_rasterizer_tpu_torch.parallel.jobs import TileJobRunner
            from software_rasterizer_tpu_torch.utils.rng import fold_in, prng_key

            rt = render._rt_scene(scene)
            n = args.width * args.height
            orig, d = camera_rays(rt.eye.cpu().numpy(), scene.fovy, args.width,
                                  args.height, rt.device)
            key = prng_key(cfg.seed)

            def render_tile(start, count):
                o = orig[start:start + count].contiguous()
                dd = d[start:start + count].contiguous()
                # per-tile key: decorrelates RNG streams across tiles
                acc = path_render_accumulate(
                    rt, o, dd, fold_in(key, start),
                    torch.zeros((count, 3), dtype=torch.float32, device=rt.device),
                    0, args.spp, p_rr=scene.rr, max_bounces=cfg.max_bounces,
                    block=min(count, 1 << 16),
                )
                return acc.cpu().numpy() / args.spp

            # TileJobRunner needs tile_lanes | n_lanes: round the requested
            # tile count to the nearest-from-below divisor of n
            tiles = max(1, min(args.tiles, n))
            while n % tiles:
                tiles -= 1
            if tiles != args.tiles:
                print(f"# tiles {args.tiles} does not divide {n} lanes; using {tiles}")
            runner = TileJobRunner(n, n // tiles)
            img = runner.run(render_tile,
                             on_progress=lambda k, m: print(f"tile {k}/{m}"))
            render.frame = img.reshape(args.height, args.width, 3).astype(np.float32)
        elif args.batch:
            if args.ckpt and os.path.exists(args.ckpt):
                render.load_checkpoint(scene.name, args.ckpt)
                print(f"resumed at {render.samples_done(scene.name)} spp")
            while render.samples_done(scene.name) < args.spp:
                n = min(args.batch, args.spp - render.samples_done(scene.name))
                render.accumulate(scene.name, n)
                done = render.samples_done(scene.name)
                print(f"{done}/{args.spp} spp, {time.perf_counter() - t0:.1f}s")
                if args.ckpt:
                    render.save_checkpoint(scene.name, args.ckpt)
            render.resolve(scene.name)
        else:
            render.draw(Primitive.TRIANGLES)
    m = rec.frames[-1]
    print(f"{args.width}x{args.height} @ {args.spp} spp on {device} in {m.draw_s:.2f}s "
          f"({m.mpaths_per_s:.2f} Mpaths/s incl. the kernels' build at first use)")
    render.save(args.out)
    print(f"wrote {args.out}")
    return render.frame


if __name__ == "__main__":
    main()
