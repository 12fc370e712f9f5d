"""sharded_path_draw: a frame is one `PathTracing.draw()` of the scene on
every rank of a sample-parallel mesh, one process and one card a rank:
the render node of a viewer whose frame's samples are split over its
cards (`PathTracing(mesh=...)` over `parallel.sharded_path_render`).

The configuration's `node` is the deployment's layout: its cards, its
("spp", "tile") mesh and its backend. The traffic's ranks, mesh and
backend have to be the same, or the driver refuses it.

The harness's process is rank 0 on card 0; the driver spawns ranks
1 .. ranks - 1 (`harness/ranks.py`), one card each. Every rank starts
the group (`parallel.initialize`, the traffic's backend, its collective
timeout), lays the traffic's ("spp", "tile") mesh and makes a
`PathTracing` on the same scene with the configuration's size, bounces
and roulette and `spp` = the configuration's samples x the mesh's spp
ranks: each spp rank draws the configuration's samples, keyed by
absolute sample index, and one all-reduce sums the frame. `frame(i)`
sends the frame's seed (drawn from the run's seed and the frame's index,
as `path_draw`) to the workers, draws on rank 0, waits for every
worker's "done" and returns rank 0's host image `frame`: the whole
frame, a frame of every rank in lockstep. A dead or failed worker makes
`frame()` raise, never block. A rank lost inside the all-reduce leaves
the others in it until the traffic's collective timeout: over gloo they
then raise; over NCCL its watchdog ends their processes, so the run
fails, and never hangs.

Only rank 0 is profiled (a traced run's `torch.profiler` runs in the
harness's process): its device events are card 0's, which wait in the
all-reduce for the slowest rank.

The check renders the same seed's samples, all of the frame's, at a
sample of the frame's pixels with the plain path integrator
(`reference.path`). `min_bytes` is the frame's bytes, W x H x 3 float32:
what the spp all-reduce sums (`allreduce_roofline.sharded4`).

On the CPU (the benchmark's tests) the ranks share the host over gloo.
"""

from __future__ import annotations

import datetime
import inspect

import numpy as np
import torch

from harness import discover
from harness.inputs import scene_inputs
from harness.ranks import Workers
from reference.path import render_pixels
from reference.scene import trace_space
from software_rasterizer_tpu_torch import parallel
from software_rasterizer_tpu_torch.render.pathtracer import PathTracing

SEED_TABLE = 1 << 17
# seconds for the workers to start (imports, the CUDA context, the
# group, the program's libraries) and answer "ready"
START_DEADLINE_S = 600.0


def _check_program() -> None:
    """Raise at once where the program has no sharded pipeline."""
    for fn, arg in ((PathTracing.__init__, "mesh"), (parallel.initialize, "timeout")):
        if arg not in inspect.signature(fn).parameters:
            raise RuntimeError(f"the program's {fn.__qualname__} takes no {arg}=: "
                               "no sample-parallel PathTracing")


def _check_node(config: dict, traffic: dict) -> None:
    """Raise where the traffic does not run the configuration's node."""
    node = config["node"]
    want = (node["cards"], node["mesh"], node["backend"])
    got = (traffic["ranks"], traffic["mesh"], traffic["backend"])
    if want != got:
        raise ValueError(f"the traffic's ranks, mesh and backend {got} are not "
                         f"the configuration's node {want}")


def _pipeline(rank: int, world: int, init_method: str, config: dict, traffic: dict,
              device: str, scene=None) -> PathTracing:
    """This rank's group, mesh and pipeline, with the scene added."""
    backend = traffic["backend"] if device == "cuda" else "gloo"
    parallel.initialize(init_method, world, rank, backend=backend, device=device,
                        timeout=datetime.timedelta(seconds=traffic["collective_timeout_s"]))
    mesh = parallel.make_render_mesh(traffic["mesh"]["spp"], traffic["mesh"]["tile"],
                                     device=device)
    p = config["path"]
    if scene is None:
        spec = config["scenes"][traffic["scene"]]
        scene = discover.load_module("scenes", spec["builder"]).build(**spec.get("args", {}))
    scene.rr = float(p["rr"])
    pipe = PathTracing(config["width"], config["height"],
                       spp=int(p["spp"]) * traffic["mesh"]["spp"],
                       max_bounces=int(p["max_bounces"]), device=device, mesh=mesh)
    pipe.add_scene(scene)
    return pipe


def worker(rank: int, world: int, init_method: str, conn, config: dict, traffic: dict,
           device: str) -> None:
    """Ranks 1 ..: draw a frame for each seed rank 0 sends, until None."""
    try:
        pipe = _pipeline(rank, world, init_method, config, traffic, device)
        conn.send("ready")
        while (seed := conn.recv()) is not None:
            pipe.seed = seed
            pipe.draw()
            conn.send("done")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, scene_mod, seed: int,
                 device: str):
        _check_program()
        _check_node(config, traffic)
        self.width, self.height = config["width"], config["height"]
        self.max_bounces = int(config["path"]["max_bounces"])
        self.spp = int(config["path"]["spp"]) * traffic["mesh"]["spp"]
        self.cuda = device == "cuda"
        self.deadline_s = float(traffic["collective_timeout_s"])
        self.workers = Workers("sharded_path_draw", "worker", int(traffic["ranks"]),
                               (config, traffic, device))
        try:
            self.pipe = _pipeline(0, int(traffic["ranks"]), self.workers.init_method,
                                  config, traffic, device, scene)
            self.workers.wait("ready", START_DEADLINE_S)
        except BaseException:
            self.close()
            raise
        self.inputs = scene_inputs(scene)
        self.seeds = np.random.default_rng(seed).integers(0, 2 ** 31, SEED_TABLE)
        self.work_per_frame = self.width * self.height * self.spp
        self.min_bytes = self.width * self.height * 3 * 4

    def params(self, i: int) -> dict:
        return {"seed": int(self.seeds[i % SEED_TABLE])}

    def frame(self, i: int):
        seed = self.params(i)["seed"]
        self.workers.check()
        self.workers.send(seed)
        self.pipe.seed = seed
        with torch.profiler.record_function("bench.draw"):
            self.pipe.draw()
        with torch.profiler.record_function("bench.wait_ranks"):
            self.workers.wait("done", self.deadline_s)
        return self.pipe.frame, False

    def close(self) -> None:
        # every rank tears its group down at once: NCCL's teardown waits
        # for its peers'
        self.workers.stop()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        self.workers.close()
        self.pipe = None
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, params: dict, pixels: torch.Tensor, dtype, device):
        ts = trace_space(self.inputs, dtype, device)
        counts: dict = {}
        out = render_pixels(ts, params["seed"], self.width, self.height,
                            self.inputs["fovy"], self.spp, self.inputs["rr"],
                            self.max_bounces, pixels, counts)
        return out.float(), counts
