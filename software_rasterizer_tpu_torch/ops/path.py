"""Monte-Carlo path tracing of the camera frame (reference:
Scene::pathTracing, Scene.cpp:671-866, driven by src/PathTracing.cpp).

`path_render` renders one frame through the persistent camera kernel
(ops/path_kernel.py): every pixel lane runs its samples' paths back to
back, restarting the next sample where a path ends. The kernel shades
every hit's color as its Kd, which is exact unless an EMISSIVE triangle
is textured (an emissive shading point adds its texture color); such a
scene needs the wavefront integrator, which is not ported yet.
"""

from __future__ import annotations

import torch

from software_rasterizer_tpu_torch.ops.intersect import RTScene
from software_rasterizer_tpu_torch.ops.path_kernel import path_camera_render


def check_kernel_scene(scene: RTScene) -> None:
    """Raise for a scene the camera kernel cannot shade exactly."""
    if scene.tex_on_emitter:
        raise NotImplementedError(
            "a textured emitter needs the wavefront path_trace integrator, "
            "which is not ported yet (ROADMAP queue 1 step 4)")


def path_render(scene: RTScene, width: int, height: int, fovy: float,
                seed: int, spp: int = 16, p_rr: float = 0.8,
                max_bounces: int = 16, start_sample: int = 0) -> torch.Tensor:
    """Mean of `spp` samples [start_sample, start_sample+spp) per pixel:
    (H,W,3) float32 radiance (pre-clamp) on the scene's device.

    Unlike the JAX package, all samples go to one kernel call: a CUDA
    thread reads its sample's seed directly, so nothing is batched over
    start_sample (sums then differ from the JAX batched sum only by
    float32 reassociation)."""
    check_kernel_scene(scene)
    acc = path_camera_render(scene, seed, width, height, fovy, spp,
                             start_sample=start_sample, p_rr=p_rr,
                             max_bounces=max_bounces)
    return (acc.T / float(spp)).reshape(height, width, 3)
