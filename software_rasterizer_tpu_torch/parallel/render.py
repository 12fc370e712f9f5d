"""Sharded render drivers over a ("spp", "tile") RenderMesh: the port of
the JAX package's parallel/render.py on `torch.distributed`.

SPMD: every rank calls the same function with the same arguments and
its own copy of the scene, and gets the whole frame back on its device,
marked (`multihost.mark_whole_frame`) so that `gather_image` passes it
through as one frame.

Design:
  * geometry is REPLICATED: each rank builds and uploads its own scene;
    only sizes and the key travel;
  * camera-ray lanes are split along the mesh's tile axis (Whitted: along
    ALL ranks, since its per-lane work is deterministic and the spp axis
    folds into the tile axis; raster: rows along all ranks);
  * path tracing also splits the spp range across the spp axis: each rank
    sums its samples, keyed by ABSOLUTE sample, pixel and block indices,
    then one all-reduce over the spp group merges the partial sums, so the
    per-sample radiance equals the single-rank render's and only the final
    sum's association differs;
  * the tile (or row) shards are gathered onto every rank at the end.

Each rank launches the same kernels as the single-rank render, on its
slice: the path camera kernel with `start_sample` / `lane_offset` /
`n_lanes`, the Whitted kernel with `lane_offset`, the raster tile
kernels with `row0`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import RTScene
from software_rasterizer_tpu_torch.ops.path import (
    _blocked_path_trace,
    camera_kernel_exact,
    check_kernel_scene,
)
from software_rasterizer_tpu_torch.ops.path_kernel import path_camera_render
from software_rasterizer_tpu_torch.ops.raster import (
    DeviceRasterGeometry,
    prepare_raster_geometry,
    render_raster_frame,
)
from software_rasterizer_tpu_torch.ops.whitted import check_whitted_scene
from software_rasterizer_tpu_torch.ops.whitted_kernel import (
    SHADOW_BIAS,
    whitted_uber_trace,
)
from software_rasterizer_tpu_torch.parallel.mesh import RenderMesh
from software_rasterizer_tpu_torch.parallel.multihost import (
    gather_rows,
    mark_whole_frame,
)
from software_rasterizer_tpu_torch.utils.rng import as_key, fold_in


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group` in place (nothing for no group)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `t` of `group` stacked along dim 0 (`t` for no group)."""
    return t if group is None else gather_rows(t, group)


def _camera_lanes(scene: RTScene, fovy: float, width: int, height: int,
                  lane0: int, n_lanes: int):
    """The camera rays of lanes [lane0, lane0 + n_lanes), as the frame's."""
    orig, d = camera_rays(scene.eye.cpu().numpy(), fovy, width, height,
                          scene.device)
    return (orig[lane0:lane0 + n_lanes].contiguous(),
            d[lane0:lane0 + n_lanes].contiguous())


def sharded_path_render(
    scene: RTScene,
    rmesh: RenderMesh,
    width: int,
    height: int,
    fovy: float,
    key,
    spp: int = 16,
    p_rr: float = 0.8,
    max_bounces: int = 16,
    block: int = 8192,
    chunk: int = 512,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Path-trace with lanes split over `tile` and the spp range over
    `spp`. Returns the (H,W,3) mean radiance on every rank's device.

    The route is `path_render`'s: `fused` None takes the camera kernel
    where it shades the scene exactly (`camera_kernel_exact`), True the
    camera kernel, False the plain wavefront in lane blocks of `block`.
    On the camera kernel each rank renders its own pixel range
    (lane_offset) and sample range (start_sample) in one launch; draws
    are keyed by absolute (pixel, sample), so with one spp rank the frame
    equals the single-rank render's bit for bit. The wavefront keys each
    sample by its absolute index and each block by its absolute block
    index. `chunk` is accepted for the JAX signature and not read.

    Constraints: spp % n_spp == 0, width*height % n_tile == 0, and the
    per-rank lane count a multiple of `block` where it exceeds it."""
    n_spp, n_tile = rmesh.n_spp, rmesh.n_tile
    n = width * height
    if spp % n_spp:
        raise ValueError(f"spp={spp} not divisible by mesh spp axis {n_spp}")
    if n % n_tile:
        raise ValueError(f"{n} pixels not divisible by tile axis {n_tile}")
    lanes_per = n // n_tile
    spp_per = spp // n_spp
    if lanes_per % block and lanes_per > block:
        raise ValueError("block must divide the per-device lane count")
    use_fused = camera_kernel_exact(scene) if fused is None else fused
    lane0 = rmesh.tile_index * lanes_per
    sample0 = rmesh.spp_index * spp_per

    if use_fused:
        check_kernel_scene(scene)
        acc = path_camera_render(
            scene, key, width, height, fovy, spp_per, start_sample=sample0,
            lane_offset=lane0, n_lanes=lanes_per, p_rr=p_rr,
            max_bounces=max_bounces).T.contiguous()
    else:
        key = as_key(key)
        orig, d = _camera_lanes(scene, fovy, width, height, lane0, lanes_per)
        # absolute block index of this rank's first lane (keys each block
        # as the single-rank blocked render does)
        blk0 = rmesh.tile_index * max(lanes_per // block, 1)
        acc = torch.zeros((lanes_per, 3), dtype=torch.float32, device=scene.device)
        for s in range(spp_per):
            acc = acc + _blocked_path_trace(
                scene, orig, d, fold_in(key, sample0 + s), p_rr, max_bounces,
                block, block_offset=blk0, fused=fused)
    acc = _all_sum(acc, rmesh.group("spp") if n_spp > 1 else None)
    img_sum = _gather(acc, rmesh.group("tile") if n_tile > 1 else None)
    return mark_whole_frame((img_sum / float(spp)).reshape(height, width, 3))


def sharded_whitted_render(
    scene: RTScene,
    rmesh: RenderMesh,
    width: int,
    height: int,
    fovy: float,
    key,
    spp: int = 1,
    max_depth: int = 5,
    block: int = 8192,
    chunk: int = 512,
    queue_factor: int = 2,
    queue_shrink: float = 0.5,
    with_stats: bool = False,
    shade_cap=(0.375, 0.125, 0.125),
    shadow_bias: Optional[float] = None,
):
    """Whitted render with framebuffer lanes split across ALL ranks (both
    mesh axes flattened: the integrator is deterministic per lane, so
    there is no sample axis to split). Returns (H,W,3) on every rank's
    device; with `with_stats`, (image, stats) with `whitted_render`'s
    counters summed over the mesh and `dropped_px` the whole frame's
    (H,W) mask.

    Emitter picks are keyed by the ABSOLUTE lane (`lane_offset`), so the
    frame equals the single-rank `whitted_render` bit for bit, with any
    number of emitters. The JAX queue knobs (`block`, `chunk`,
    `queue_factor`, `queue_shrink`, `shade_cap`) are accepted and not
    read: the kernel walks each pixel's whole tree and drops nothing."""
    if shadow_bias is None:
        shadow_bias = SHADOW_BIAS
    check_whitted_scene(scene, max_depth)
    n = width * height
    n_dev = rmesh.n_devices
    if n % n_dev:
        raise ValueError(f"{n} pixels not divisible by {n_dev} devices")
    lanes_per = n // n_dev
    lane0 = rmesh.index * lanes_per
    orig, d = _camera_lanes(scene, fovy, width, height, lane0, lanes_per)
    rgb, nray = whitted_uber_trace(scene, orig, d, max_depth=max_depth,
                                   shadow_bias=shadow_bias, key=key, spp=spp,
                                   lane_offset=lane0)
    img = mark_whole_frame(_gather(rgb, rmesh.group()).reshape(height, width, 3))
    if not with_stats:
        return img
    sums = _all_sum(nray.sum(dim=1), rmesh.group())
    # whitted_render's count: a diffuse hit is shaded once per emitter row
    # when spp > 1
    shadow_evals = scene.emitter_cr.shape[0] if spp > 1 else 1
    dev = scene.device
    return img, {
        "dropped_rays": torch.zeros((), dtype=torch.int64, device=dev),
        "rays_main": sums[0],
        "rays_shadow": sums[1] * shadow_evals,
        "dropped_px": torch.zeros((height, width), dtype=torch.bool, device=dev),
    }


def sharded_whitted_render_exact(
    scene: RTScene,
    rmesh: RenderMesh,
    width: int,
    height: int,
    fovy: float,
    key,
    spp: int = 1,
    max_depth: int = 5,
    block: int = 8192,
    chunk: int = 512,
    queue_factor: int = 2,
    queue_shrink: float = 0.5,
    shade_cap=(0.375, 0.125, 0.125),
    shadow_bias: Optional[float] = None,
    bucket: int = 2048,
    return_stats: bool = False,
):
    """`sharded_whitted_render` with stats, under the JAX package's
    overflow-exact name. The JAX version re-traces the pixels whose
    wavefront queues overflowed in a second sharded pass
    (`_sharded_retrace`); here the kernel walks every tree in full, no
    pixel loses a ray, and that pass has no counterpart. `bucket` is
    accepted and not read."""
    img, stats = sharded_whitted_render(
        scene, rmesh, width, height, fovy, key, spp, max_depth, block, chunk,
        queue_factor, queue_shrink, with_stats=True, shade_cap=shade_cap,
        shadow_bias=shadow_bias)
    return (img, stats) if return_stats else img


def sharded_raster_render(
    geom,
    frame,
    rmesh: RenderMesh,
    height: int,
    width: int,
    active_types=None,
    cull: bool = True,
    shaded: bool = False,
    with_stats: bool = False,
):
    """Rasterize with framebuffer ROWS split across ALL ranks (both mesh
    axes flattened: the pipeline is deterministic, so there is no sample
    axis to split). Returns (image (H,W,3), zbuf (H,W)) on every rank's
    device; with `with_stats` also `render_raster_frame`'s stats, with
    `bin_dropped` summed over the ranks.

    `geom` is a host `RasterGeometry` (uploaded to the mesh's device) or
    `prepare_raster_geometry`'s result. Each rank rasterizes the absolute
    rows [dev*sh, (dev+1)*sh) through `render_raster_frame(row0=...)`, and
    the tile kernels place their own tile grid at `row0`, so every
    per-pixel float32 operation sees the monolithic frame's operands and
    the frame reassembles BIT-EXACTLY. There is no communication until
    the gather. Where the shard height is not a multiple of the kernel
    tile height, the tile grids differ from the whole frame's, and
    `bin_dropped` (the binning cap's drops) may differ with them; the
    pixels differ only where a tile overflows."""
    n_dev = rmesh.n_devices
    if height % n_dev:
        raise ValueError(f"height {height} not divisible by {n_dev} devices")
    shard_h = height // n_dev
    if not isinstance(geom, DeviceRasterGeometry):
        geom = prepare_raster_geometry(geom, rmesh.device)
    img, zb, stats = render_raster_frame(
        geom, frame, shard_h, width, cull=cull, active_types=active_types,
        with_stats=True, row0=rmesh.index * shard_h, shaded=shaded)
    group = rmesh.group()
    img = mark_whole_frame(_gather(img, group))
    zb = mark_whole_frame(_gather(zb, group))
    if not with_stats:
        return img, zb
    stats = dict(stats)
    stats["bin_dropped"] = _all_sum(stats["bin_dropped"].clone(), group)
    return img, zb, stats
