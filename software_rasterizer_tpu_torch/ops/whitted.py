"""Whitted-style ray tracing of the camera frame (reference:
Scene::whittedRayTracing, Scene.cpp:478-617).

`whitted_render` traces one camera ray per pixel through the Whitted
über-kernel (ops/whitted_kernel.py): each lane walks its whole
reflect/refract tree depth-first, so no child ray is ever dropped.

Faithful quirks (the JAX package's ops/whitted.py docstring has the
reference citations): the depth cap returns black, a miss returns the
background; shadow rays leave from the hit point lifted along the normal
by SHADOW_BIAS (scaled by the coordinate magnitude) and succeed only on
an emissive nearest hit, with the |t^2 - dist^2| shadow test; Phong aims
at the emitter's bounding-sphere centre and uses Ka/Ks/the specular
exponent with the hit's diffuse colour (the texel or Kd; zero for
spheres); reflect/refract children carry kr / (1-kr) (1 for mirrors)
and start EPSILON off the surface.

With one emitter the reference's per-sample emitter pick always lands on
it, so the image does not depend on `seed` or `spp`. With more, every
diffuse hit averages the Phong term over `spp` emitter picks keyed by
(key, depth, sample, ray id), the JAX package's `lane_uniforms` chain
(ops/whitted_kernel.py), so a frame equals the JAX wavefront's under the
same `jax.random.PRNGKey`.
"""

from __future__ import annotations

import torch

from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import RTScene
from software_rasterizer_tpu_torch.ops.whitted_kernel import (
    EPS as EPSILON,
    SHADOW_BIAS,
    check_max_depth,
    whitted_uber_trace,
)

__all__ = ["EPSILON", "SHADOW_BIAS", "check_whitted_scene", "whitted_render",
           "whitted_render_exact"]


def check_whitted_scene(scene: RTScene, max_depth: int) -> None:
    """Raise for a depth the Whitted kernel cannot render (its per-thread
    stack bound). The kernel has no cap on triangles, spheres or
    emitters."""
    check_max_depth(max_depth)


def whitted_render(scene: RTScene, width: int, height: int, fovy: float,
                   seed: int = 0, spp: int = 1, max_depth: int = 5,
                   shadow_bias: float = SHADOW_BIAS, with_stats: bool = False):
    """Render one Whitted frame: (H,W,3) float32 (pre-clamp) on the
    scene's device, or (image, stats) when `with_stats`. stats:
    rays_main / rays_shadow (main rays traced; diffuse hits shaded,
    counted once per emitter-table row when spp > 1, as the JAX package
    counts its shadow evaluations), dropped_rays = 0 and an all-False
    (H,W) dropped_px: the per-thread DFS and the direct texel fetch lose
    nothing. `seed` (an integer or a (2,) uint32 key) and `spp` drive the
    emitter picks of a scene with several emitters; a one-emitter frame
    does not read them."""
    check_whitted_scene(scene, max_depth)
    if width <= 0 or height <= 0:
        raise ValueError(f"bad frame size {width}x{height}")
    dev = scene.device
    orig, d = camera_rays(scene.eye.cpu().numpy(), fovy, width, height, dev)
    rgb, nray = whitted_uber_trace(scene, orig.contiguous(), d.contiguous(),
                                   max_depth=max_depth,
                                   shadow_bias=shadow_bias, key=seed, spp=spp)
    img = rgb.reshape(height, width, 3)
    if not with_stats:
        return img
    sums = nray.sum(dim=1)
    shadow_evals = scene.emitter_cr.shape[0] if spp > 1 else 1
    return img, {
        "dropped_rays": torch.zeros((), dtype=torch.int64, device=dev),
        "rays_main": sums[0],
        "rays_shadow": sums[1] * shadow_evals,
        "dropped_px": torch.zeros((height, width), dtype=torch.bool, device=dev),
    }


def whitted_render_exact(scene: RTScene, width: int, height: int,
                         fovy: float, seed: int = 0, spp: int = 1,
                         max_depth: int = 5,
                         shadow_bias: float = SHADOW_BIAS,
                         return_stats: bool = False):
    """`whitted_render` with the JAX package's exact-render name. The JAX
    version re-traces the pixels whose wavefront queues overflowed in a
    second pass; here the kernel walks every tree in full, so no pixel
    loses a ray and there is no second pass."""
    img, stats = whitted_render(scene, width, height, fovy, seed, spp,
                                max_depth, shadow_bias, with_stats=True)
    return (img, stats) if return_stats else img
