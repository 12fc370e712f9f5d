"""path_draw: a frame is one `PathTracing.draw()` of the scene at the
configuration's size, samples, bounces and roulette, under a new
`PathTracing.seed` drawn from the run's seed and the frame's index, and
ends in the pipeline's host image `frame`. The check renders the same
seed's samples at a sample of the frame's pixels with the plain path
integrator (`reference.path`)."""

from __future__ import annotations

import numpy as np
import torch

from harness.inputs import scene_inputs
from reference.path import render_pixels
from reference.scene import trace_space
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.render.pipeline import pipeline_from_config

SEED_TABLE = 1 << 17


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, scene_mod, seed: int,
                 device: str):
        p = config["path"]
        self.width, self.height = config["width"], config["height"]
        self.spp, self.max_bounces = int(p["spp"]), int(p["max_bounces"])
        scene.rr = float(p["rr"])
        self.cuda = device == "cuda"
        self.pipe = pipeline_from_config(
            RenderConfig(width=self.width, height=self.height, spp=self.spp,
                         max_bounces=self.max_bounces), "path", device=device)
        self.pipe.add_scene(scene)
        self.inputs = scene_inputs(scene)
        self.seeds = np.random.default_rng(seed).integers(0, 2 ** 31, SEED_TABLE)
        self.work_per_frame = self.width * self.height * self.spp
        n_tri = sum(m["faces"].shape[0] for m in self.inputs["meshes"])
        # each triangle's row and attributes read once, the image written once
        self.min_bytes = n_tri * (12 + 16) * 4 + self.width * self.height * 3 * 4

    def params(self, i: int) -> dict:
        return {"seed": int(self.seeds[i % SEED_TABLE])}

    def frame(self, i: int):
        self.pipe.seed = self.params(i)["seed"]
        with torch.profiler.record_function("bench.draw"):
            self.pipe.draw()
        return self.pipe.frame, False

    def close(self) -> None:
        del self.pipe
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, params: dict, pixels: torch.Tensor, dtype, device):
        ts = trace_space(self.inputs, dtype, device)
        counts: dict = {}
        out = render_pixels(ts, params["seed"], self.width, self.height,
                            self.inputs["fovy"], self.spp, self.inputs["rr"],
                            self.max_bounces, pixels, counts)
        return out.float(), counts
