"""raster_draw: the reference's animation loop. A frame is `clear()`, a
turn of the scene to its angle (the scene builder's `turn`: the angle of
frame i is a start angle drawn from the run's seed plus i times the
traffic's `angle_step`, in degrees), and one `TraditionalRasterizer.draw()`
ending in the pipeline's host image `frame`. A frame whose `last_stats`
report binned triangles dropped has failed. The check rasterizes a sample
of the frame's pixels at the same angle with the plain rasterizer
(`reference.raster`)."""

from __future__ import annotations

import numpy as np
import torch

from harness.inputs import scene_inputs
from reference.raster import raster_tables, render_pixels
from software_rasterizer_tpu_torch.config import RenderConfig
from software_rasterizer_tpu_torch.render.pipeline import pipeline_from_config


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, scene_mod, seed: int,
                 device: str):
        self.width, self.height = config["width"], config["height"]
        self.scene, self.turn = scene, scene_mod.turn
        self.name = scene.name
        self.cuda = device == "cuda"
        self.pipe = pipeline_from_config(
            RenderConfig(width=self.width, height=self.height), "raster", device=device)
        self.pipe.shaded = bool(config["raster"]["shaded"])
        self.pipe.add_scene(scene)
        self.start = float(np.random.default_rng(seed).integers(0, 360))
        self.step = float(traffic["angle_step"])
        self.work_per_frame = self.width * self.height

    def params(self, i: int) -> dict:
        return {"angle": (self.start + i * self.step) % 360.0}

    def frame(self, i: int):
        self.pipe.clear()
        self.turn(self.scene, self.params(i)["angle"])
        with torch.profiler.record_function("bench.draw"):
            self.pipe.draw()
        return self.pipe.frame, self.pipe.last_stats[self.name]["bin_dropped"] > 0

    def close(self) -> None:
        del self.pipe
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, params: dict, pixels: torch.Tensor, dtype, device):
        self.turn(self.scene, params["angle"])
        tables = raster_tables(scene_inputs(self.scene), dtype, device)
        return render_pixels(tables, self.width, pixels).float(), {}
