"""whitted_draw: a frame is one `RayTracing.draw()` of the scene at the
configuration's size, samples and recursion depth, the pipeline splitting
its key at each draw, and ends in the pipeline's host image `frame`. A
frame whose `last_stats` report dropped rays has failed. The check traces
a sample of the frame's pixels with the plain Whitted tracer
(`reference.whitted`)."""

from __future__ import annotations

import torch

from harness.inputs import scene_inputs
from reference.scene import trace_space
from reference.whitted import render_pixels
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.render.pipeline import pipeline_from_config


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, scene_mod, seed: int,
                 device: str):
        w = config["whitted"]
        self.width, self.height = config["width"], config["height"]
        scene.max_depth = int(w["max_depth"])
        self.name = scene.name
        self.cuda = device == "cuda"
        self.pipe = pipeline_from_config(
            RenderConfig(width=self.width, height=self.height, spp=int(w["spp"]),
                         max_depth=int(w["max_depth"]), seed=seed), "whitted",
            device=device)
        self.pipe.add_scene(scene)
        self.inputs = scene_inputs(scene)
        self.max_depth = int(w["max_depth"])
        self.work_per_frame = self.width * self.height

    def params(self, i: int) -> dict:
        return {"draw": i}

    def frame(self, i: int):
        with torch.profiler.record_function("bench.draw"):
            self.pipe.draw()
        return self.pipe.frame, self.pipe.last_stats[self.name]["dropped_rays"] > 0

    def close(self) -> None:
        del self.pipe
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, params: dict, pixels: torch.Tensor, dtype, device):
        ts = trace_space(self.inputs, dtype, device)
        out = render_pixels(ts, self.width, self.height, self.inputs["fovy"], pixels,
                            self.max_depth)
        return out.float(), {}
