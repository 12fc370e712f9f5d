"""Run a function on every rank of a fresh process group, and the cases of
the port's sharded renders that tests/test_torch_parallel.py holds
against the single-rank renders and the JAX package. Imports no JAX, so
the spawned ranks start fast.

    run_ranks(world, fn, args, device)

spawns `world` processes (start method "spawn": CUDA may be initialised
in the caller), starts a process group in each through the port's
`parallel.initialize` with a `file://` rendezvous in a temporary
directory, calls `fn(*args)` and returns the ranks' results in rank
order. A rank that raises fails the whole run with its traceback; the
others are killed, never left waiting in a collective.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

# the cases' sizes (the JAX package's tests/test_parallel.py uses 32x32,
# spp 4, 8 bounces, Whitted max_depth 3, and 16x16 for its fused case)
W = H = 32
SPP = 4
BOUNCES = 8
BLOCK = W * H // 4
PATH_SEED = 42
WHITTED_SEED = 7
WHITTED_SPP = 2
WHITTED_DEPTH = 3
FUSED_W, FUSED_BOUNCES, FUSED_SEED = 16, 6, 3
RASTER_SIZE, RASTER_LEVELS = 64, 2
MESHES = ((1, 4), (2, 2), (4, 1))
PIPE_SPP = 8                      # PathTracing(mesh=...) draws, 32x32
COLLECTIVES = ("srt.all_reduce", "srt.gather")


def _entry(rank, world, init_method, device, backend, fn, args, results):
    import torch

    torch.set_num_threads(1)  # 4 ranks x 8 threads on 8 cores crawl
    try:
        from software_rasterizer_tpu_torch.parallel import initialize

        initialize(init_method, world, rank, backend=backend, device=device)
        results.put((rank, fn(*args), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, fn, args=(), device: str = "cpu", timeout: float = 600.0,
              backend=None) -> list:
    """`fn(*args)` on `world` ranks of one process group, one PyTorch
    thread each; the results in rank order (they travel pickled: send
    numpy, not CUDA tensors). `backend`: None takes
    `parallel.initialize`'s rule."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = [None] * world
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_entry, args=(r, world, init, device, backend, fn, args,
                                                  results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for _ in range(world):
                while True:
                    try:
                        rank, res, err = results.get(timeout=1.0)
                        break
                    except queue.Empty:
                        dead = [r for r, p in enumerate(procs)
                                if p.exitcode not in (None, 0) and out[r] is None]
                        if dead:
                            raise RuntimeError(f"rank {dead[0]} exited with code "
                                               f"{procs[dead[0]].exitcode}, no result")
                        if time.monotonic() > deadline:
                            raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                out[rank] = res
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return out


def _np(t):
    return t.detach().cpu().numpy()


def _raises(fn) -> str:
    """The message of the ValueError `fn()` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def cornell_rt(width, device, build=None):
    """The Cornell box (or `build()`'s scene) as the port's device scene
    at width x width, with its fovy."""
    from software_rasterizer_tpu_torch.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene

    scene = (build or build_cornell_scene)()
    scene.set_ndc_matrix(width, width)
    return prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), device), scene.fovy


def two_emitter_scene():
    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from torch_scenes import two_emitter_cornell

    return two_emitter_cornell(models, build_cornell_scene)


def lit_raster_scene(size=RASTER_SIZE, levels=RASTER_LEVELS):
    """`torch_scenes.raster_cornell` (variant "three") in the port's
    models at size x size: (scene, active shader types)."""
    from software_rasterizer_tpu_torch import models
    from software_rasterizer_tpu_torch.ops import shading
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
    from software_rasterizer_tpu_torch.utils.texture import Texture
    from torch_scenes import raster_cornell

    scene = raster_cornell(models, build_cornell_scene, subdivide_mesh,
                           shading.ShaderType, Texture, levels)
    scene.set_ndc_matrix(size, size)
    active = tuple(sorted(set(int(t) for t in scene.raster_geometry().shader_type)))
    return scene, active


def pipeline_draw(mesh=None):
    """A `PathTracing` of the Cornell box at W x H, PIPE_SPP samples,
    BOUNCES bounces and PATH_SEED on the CPU (sharded on `mesh`), drawn
    once: (pipeline, its frame, {collective span: (count, bytes)} that
    the draw added)."""
    from software_rasterizer_tpu_torch.render.pathtracer import PathTracing
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene
    from software_rasterizer_tpu_torch.utils import profiling

    pipe = PathTracing(W, H, spp=PIPE_SPP, max_bounces=BOUNCES, seed=PATH_SEED,
                       device="cpu", mesh=mesh)
    pipe.add_scene(build_cornell_scene())
    count0, bytes0 = profiling.span_totals(), profiling.span_bytes()
    pipe.draw()
    count1, bytes1 = profiling.span_totals(), profiling.span_bytes()
    added = {name: (count1.get(name, (0, 0.0))[0] - count0.get(name, (0, 0.0))[0],
                    bytes1.get(name, 0) - bytes0.get(name, 0)) for name in COLLECTIVES}
    return pipe, pipe.frame, added


def cpu_cases() -> dict:
    """Every case of tests/test_torch_parallel.py, on this rank (CPU)."""
    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.parallel import (
        gather_image,
        make_render_mesh,
        process_info,
        sharded_path_render,
        sharded_raster_render,
        sharded_whitted_render,
        sharded_whitted_render_exact,
    )

    import numpy as np

    out = {"info": process_info()}
    meshes = {shape: make_render_mesh(*shape, device="cpu") for shape in MESHES}
    out["coords"] = {s: (m.spp_index, m.tile_index, m.n_devices) for s, m in meshes.items()}
    out["default_mesh"] = (lambda m: (m.n_spp, m.n_tile))(make_render_mesh(2, device="cpu"))
    one = make_render_mesh(1, 1, device="cpu")
    out["one"] = (one.n_devices, one.mesh is None)
    out["bad_mesh"] = {
        "spp3": _raises(lambda: make_render_mesh(3, device="cpu")),
        "2x4": _raises(lambda: make_render_mesh(2, 4, device="cpu")),
        "2x1": _raises(lambda: make_render_mesh(2, 1, device="cpu")),
    }

    rt, fovy = cornell_rt(W, "cpu")
    out["path"] = {}
    for shape, m in meshes.items():
        for fused in (True, False):
            before = pk.LAUNCHES
            img = sharded_path_render(rt, m, W, H, fovy, PATH_SEED, spp=SPP,
                                      max_bounces=BOUNCES, block=BLOCK, fused=fused)
            assert pk.LAUNCHES == before    # CPU tensors: the plain versions
            out["path"][shape, fused] = _np(img)
            if shape == (2, 2):
                out["gather_path", fused] = gather_image(img)
    frt, ffovy = cornell_rt(FUSED_W, "cpu")
    out["path_jax"] = _np(sharded_path_render(
        frt, meshes[2, 2], FUSED_W, FUSED_W, ffovy, FUSED_SEED, spp=SPP,
        max_bounces=FUSED_BOUNCES, fused=True))

    m22 = meshes[2, 2]
    out["bad_args"] = {
        "spp": _raises(lambda: sharded_path_render(rt, m22, W, H, fovy, 0, spp=3,
                                                   block=BLOCK)),
        "pixels": _raises(lambda: sharded_path_render(rt, meshes[1, 4], 30, 31, fovy, 0,
                                                      spp=2)),
        "block": _raises(lambda: sharded_path_render(rt, meshes[1, 4], W, H, fovy, 0,
                                                     spp=1, block=96)),
        "whitted_pixels": _raises(lambda: sharded_whitted_render(rt, m22, 30, 31, fovy, 0)),
    }

    wrt, wfovy = cornell_rt(W, "cpu", two_emitter_scene)
    out["whitted"] = {}
    for name, scene_rt, sfovy, spp in (("one", rt, fovy, 1), ("two", wrt, wfovy, WHITTED_SPP)):
        img, st = sharded_whitted_render(scene_rt, m22, W, H, sfovy, WHITTED_SEED,
                                         spp=spp, max_depth=WHITTED_DEPTH,
                                         with_stats=True)
        ex, ex_st = sharded_whitted_render_exact(scene_rt, meshes[1, 4], W, H, sfovy,
                                                 WHITTED_SEED, spp=spp,
                                                 max_depth=WHITTED_DEPTH,
                                                 return_stats=True)
        out["whitted"][name] = (_np(img), {k: _np(v) for k, v in st.items()},
                                _np(ex), {k: _np(v) for k, v in ex_st.items()},
                                _np(sharded_whitted_render(scene_rt, m22, W, H, sfovy,
                                                           WHITTED_SEED, spp=spp,
                                                           max_depth=WHITTED_DEPTH)))
        out["gather_whitted", name] = (gather_image(img), gather_image(ex))

    scene, active = lit_raster_scene()
    geom, frame = scene.raster_geometry(), scene.raster_frame()
    out["raster"] = {}
    for shaded in (False, True):
        img, zb, st = sharded_raster_render(geom, frame, m22, RASTER_SIZE, RASTER_SIZE,
                                            active_types=active, shaded=shaded,
                                            with_stats=True)
        out["raster"][shaded] = (_np(img), _np(zb), int(st["bin_dropped"]), st["kernel"])
        out["gather_raster", shaded] = (gather_image(img), gather_image(zb))
    out["raster_bad"] = _raises(lambda: sharded_raster_render(
        geom, frame, m22, RASTER_SIZE - 2, RASTER_SIZE, active_types=active))

    rank = out["info"]["process_index"]
    out["gather"] = gather_image(np.full((2, 3), rank, np.float32))

    out["pipeline"] = {}
    for shape, m in meshes.items():
        pipe, frame, added = pipeline_draw(m)
        name = next(iter(pipe.scenes))
        out["pipeline"][shape] = (frame, added,
                                  _raises(lambda: pipe.accumulate(name, 1)))
    return out


def card_cases(width: int) -> dict:
    """Path (camera kernel) and Whitted on a width x width Cornell box on
    this rank's card, on a (1, world) mesh and a (world, 1) one, with the
    kernels' launch counts and the backend taken."""
    import torch

    from software_rasterizer_tpu_torch.ops import path_kernel as pk
    from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
    from software_rasterizer_tpu_torch.parallel import (
        make_render_mesh,
        process_info,
        sharded_path_render,
        sharded_whitted_render,
    )

    rt, fovy = cornell_rt(width, "cuda")
    world = torch.distributed.get_world_size()
    out = {"backend": process_info()["backend"], "device": str(rt.device)}
    for shape in ((1, world), (world, 1)):
        m = make_render_mesh(*shape)
        p0, w0 = pk.LAUNCHES, wk.LAUNCHES
        out[shape] = (_np(sharded_path_render(rt, m, width, width, fovy, PATH_SEED, spp=SPP,
                                              max_bounces=BOUNCES)),
                      _np(sharded_whitted_render(rt, m, width, width, fovy, WHITTED_SEED,
                                                 max_depth=WHITTED_DEPTH)),
                      pk.LAUNCHES - p0, wk.LAUNCHES - w0)
    return out
