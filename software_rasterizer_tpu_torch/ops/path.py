"""Monte-Carlo path tracing (reference: Scene::pathTracing,
Scene.cpp:671-866, driven by src/PathTracing.cpp).

Two routes render a frame:

  * `path_render` through the persistent camera kernel
    (ops/path_kernel.path_camera_render): every pixel lane runs its
    samples' paths back to back. The kernel shades every hit's colour as
    its Kd, which is exact unless an EMISSIVE triangle is textured (an
    emissive shading point adds its texture colour);
  * the wavefront integrator on EXPLICIT rays: `path_trace` takes any
    (N,3) lane set, finds the primary hits with `nearest_hit` (texel
    colours included) and advances every lane bounce by bounce;
    `path_render_accumulate` adds samples of it into a running sum, and
    `path_render` takes this route for a scene the camera kernel cannot
    shade exactly.

The wavefront itself has two forms. `fused=True`: all bounces of all
lanes in one launch of the bounce kernel (ops/path_kernel.
fused_bounce_group), at full width and lossless. `fused=False`: plain
PyTorch on `nearest_hit` (a shadow trace and a bounce trace a bounce),
with lane compaction between bounce groups and draws from a
`torch.Generator`; it is the reference semantics of the integrator.

The routes by triangle count. The JAX package caps its fused routes at
512 triangles (and at sphere and emitter counts), limits of the TPU's
scalar memory. Here both kernels read tables of any size from device
memory, and above 512 triangles they take their chunk-culled walk (each
ray tests only the rows of the leaves whose boxes it enters), so no cap
applies, by measurement (chip_smoke.py phase 27, NVIDIA H100 80GB HBM3,
700 W, 16 bounces):
  * `path_trace(fused=None)` takes the bounce kernel at every count. One
    sample of 262,144 lanes: 40.3 ms against 211.4 for `fused=False` at
    9,216 triangles, 147.3 against 1077.0 at 147,456; at Cornell's 36 the
    bounce kernel takes 1.9 ms a million lanes and the plain wavefront
    0.48 s a quarter frame (phases 17-18).
  * `path_render_sum` (and `path_render`, `PathTracing`) with `fused=None`
    takes the camera kernel wherever it is exact. One sample of the
    1024x1024 frame: 84.2 ms against 87.0 for a wavefront sample
    (`path_trace`, fused) at 9,216 triangles, 340.1 against 343.7 at
    147,456; the camera kernel also needs no ray tensors.
A textured emitter is exact on the fused route too: the
primary hit is made outside the kernel by `nearest_hit`, which hands the
texel in as the state's colour, and a lane whose bounce ray lands on an
emitter dies there, so no later shading point is emissive and the
kernel's colour-as-Kd is never read.

Faithful reference semantics (per lane, Scene.cpp citations):
  * primary miss -> background (:857-866);
  * direct light at an EMISSIVE hit returns the hit's diffuse COLOUR
    (not its emission) (:676-680);
  * NEE: bounding-sphere light direction sampling (sampleLight,
    :429-476), pdf = cos(theta)/2pi; contribution
    emit * Fr * cos_o * cos_l / (pdf * dist^2) gated on the shadow hit
    being emissive and |t^2 - dist^2| <= 1e-4 (:682-717);
  * indirect: RR with survival p_rr BEFORE sampling (:797-798);
    wi ~ uniform hemisphere (Material.cpp:14-34); paths whose next hit
    is emissive are DISCARDED (:813-815); weight
    Fr * cos / (pdf * p_rr) (:826-830);
  * shadow/bounce ray origins offset by +1e-6*N (:689, :801);
  * pdf < epsilon (1e-5, Scene.hpp) kills the branch.

Keys are the JAX chain's (utils/rng): sample s of a render uses
fold_in(key, start_sample + s), a lane block fold_in(., block index),
and the fused route's seed is key_bits of that, so the port's fused
wavefront draws the JAX package's numbers under the same PRNGKey.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from software_rasterizer_tpu_torch.ops import optics, sampling
from software_rasterizer_tpu_torch.ops.camera import camera_rays
from software_rasterizer_tpu_torch.ops.intersect import Hit, RTScene, nearest_hit
from software_rasterizer_tpu_torch.ops.path_kernel import (
    fused_bounce_group,
    path_camera_render,
)
from software_rasterizer_tpu_torch.utils.debug import nan_check
from software_rasterizer_tpu_torch.utils.rng import as_key, fold_in, key_bits

EPSILON = 1e-5  # Scene.hpp m_epsilon
COMPACT_SCHEDULE = (1.0, 0.55, 0.3, 0.18, 0.1, 0.07)


def camera_kernel_exact(scene: RTScene) -> bool:
    """Whether the camera kernel shades the scene exactly: it reads every
    hit's colour as its Kd, so a textured emitter needs the wavefront."""
    return not scene.tex_on_emitter


def check_kernel_scene(scene: RTScene) -> None:
    """Raise for a scene the camera kernel cannot shade exactly."""
    if not camera_kernel_exact(scene):
        raise ValueError(
            "the camera kernel shades an emitter's colour as its Kd; a scene "
            "with a textured emitter renders through path_render_accumulate "
            "(path_render with fused=None takes that route by itself)")


def _emissive(emit: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(emit, dim=-1) > EPSILON


def _nee_eval(scene: RTScene, hit: Hit, n, l, pdf, shadow: Hit) -> torch.Tensor:
    """pathTracingDirectLight evaluation (Scene.cpp:671-717) given the
    sampled light direction `l` / `pdf` and the traced shadow hit."""
    lit = shadow.hit & _emissive(shadow.emit)
    dist2 = ((hit.coords - shadow.coords) ** 2).sum(dim=-1)
    not_shadow = (shadow.t * shadow.t - dist2).abs() <= 1e-4

    cos_o = torch.clamp((n * l).sum(dim=-1), min=0.0)
    cos_l = torch.clamp((shadow.normal * (-l)).sum(dim=-1), min=0.0)
    fr = sampling.fr_diffuse(hit.kd, l, n)

    pdf_ok = torch.isfinite(pdf) & (pdf >= EPSILON)
    denom = torch.where(pdf_ok, pdf, 1.0) * torch.clamp(dist2, min=1e-30)
    nee = shadow.emit * fr * (cos_o * cos_l / denom)[:, None]
    nee = torch.where((lit & not_shadow & pdf_ok)[:, None], nee, 0.0)
    # an emissive shading point short-circuits to its diffuse colour (:676-680)
    return torch.where(_emissive(hit.emit)[:, None], hit.color, nee)


def _direct_light(scene: RTScene, hit: Hit, gen: torch.Generator) -> torch.Tensor:
    """pathTracingDirectLight (Scene.cpp:671-717) for a lane batch."""
    n = optics.normalize(hit.normal)
    l, pdf = sampling.sample_light_dir(scene, gen, hit.coords)
    shadow = nearest_hit(scene, hit.coords + 1e-6 * n, l, lite=True)
    return _nee_eval(scene, hit, n, l, pdf, shadow)


def _align_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compact_perm(live: torch.Tensor, cap: int):
    """Stable-partition permutation without a sort: slot k of the output
    is the k-th live lane (prefix sum of liveness -> target slot, one
    scatter). Returns (perm (cap,) int64, n_live () int64); slots >=
    n_live alias lane 0 and MUST be masked dead by the caller; live lanes
    beyond `cap` are left out."""
    n = live.shape[0]
    pos = torch.cumsum(live.to(torch.int64), dim=0) - 1
    n_live = live.sum()
    tgt = torch.where(live & (pos < cap), pos, cap)
    perm = torch.zeros(cap + 1, dtype=torch.int64, device=live.device)
    perm.scatter_(0, tgt, torch.arange(n, dtype=torch.int64, device=live.device))
    return perm[:cap], n_live


def primary_state(hit: Hit) -> torch.Tensor:
    """The bounce kernel's (18,N) state of lanes standing on their primary
    hits: [pos | nrm | kd | emit | color | throughput = 1]."""
    ones = torch.ones_like(hit.t)
    return torch.stack([
        *hit.coords.unbind(dim=1), *hit.normal.unbind(dim=1),
        *hit.kd.unbind(dim=1), *hit.emit.unbind(dim=1),
        *hit.color.unbind(dim=1), ones, ones, ones,
    ])


def _fused_path_trace(scene: RTScene, hit: Hit, key, p_rr: float,
                      max_bounces: int, radiance: torch.Tensor,
                      with_stats: bool):
    """All `max_bounces` bounces in ONE bounce-kernel call at FULL
    wavefront width: no compaction, lossless (`dropped_lanes` is exactly
    0). A thread leaves the loop when its lane dies, so dead lanes cost
    a load and a store."""
    acc, _, _ = fused_bounce_group(scene, primary_state(hit), hit.hit,
                                   int(key_bits(key)), max_bounces, p_rr=p_rr)
    radiance = radiance + acc.T
    if with_stats:
        return radiance, {"dropped_lanes": torch.zeros(
            (), dtype=torch.int64, device=radiance.device)}
    return radiance


def path_trace(scene: RTScene, orig: torch.Tensor, d: torch.Tensor, key,
               p_rr: float = 0.8, max_bounces: int = 16,
               compact_schedule: Sequence[float] = COMPACT_SCHEDULE,
               with_stats: bool = False, fused: Optional[bool] = None):
    """One path-tracing sample per lane. orig/d: (N,3) float32 on the
    scene's device; key: a (2,) uint32 key or an integer seed. Returns
    (N,3) radiance (the reference's Scene::pathTracing per camera ray),
    or (radiance, {"dropped_lanes": int64 scalar}) when `with_stats`.

    `fused` None or True: every bounce in one launch of the bounce
    kernel, at full width. `fused=False`: the plain wavefront with
    COMPACTION: `max_bounces` is split into len(compact_schedule) groups,
    and before each group the live lanes are compacted to `schedule[g] *
    N` slots (a stable partition by liveness). Russian roulette kills
    about (1 - p_rr) of the lanes a bounce, so the live share stays under
    the default capacity curve. Live lanes that overflow ARE dropped, and
    COUNTED in stats["dropped_lanes"], so a scene whose survival curve
    beats the schedule (p_rr near 1) is detected, never silently biased.
    compact_schedule=(1.0,) disables compaction (lossless)."""
    key = as_key(key)
    n_lanes = orig.shape[0]
    dev = orig.device
    hit = nearest_hit(scene, orig, d)
    radiance = torch.where((~hit.hit)[:, None], scene.background, 0.0)

    if fused is None or fused:
        return nan_check("path_trace", _fused_path_trace(
            scene, hit, key, p_rr, max_bounces, radiance, with_stats))

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key_bits(key)))
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    live = hit.hit
    tp = torch.ones((n_lanes, 3), dtype=torch.float32, device=dev)
    pixel = torch.arange(n_lanes, dtype=torch.int64, device=dev)

    n_groups = min(len(compact_schedule), max_bounces)
    per_group = [max_bounces // n_groups] * n_groups if n_groups else []
    for i in range(max_bounces % n_groups if n_groups else 0):
        per_group[i] += 1

    compacted = False
    for g in range(n_groups):
        cap = min(_align_up(int(n_lanes * compact_schedule[g]), 256), n_lanes)
        if cap < pixel.shape[0]:
            perm, n_live = compact_perm(live, cap)
            dropped = dropped + torch.clamp(n_live - cap, min=0)
            hit = Hit._make(f[perm] for f in hit)
            tp, pixel = tp[perm], pixel[perm]
            # slots beyond n_live alias lane 0: mask them dead
            live = live[perm] & (torch.arange(cap, device=dev) < n_live)
            compacted = True

        acc = torch.zeros((pixel.shape[0], 3), dtype=torch.float32, device=dev)
        for _ in range(per_group[g]):
            cap = pixel.shape[0]
            n = optics.normalize(hit.normal)
            l, pdf_l = sampling.sample_light_dir(scene, gen, hit.coords)
            # Russian roulette (survive iff u <= p_rr, Scene.cpp:797-798)
            survive = torch.rand(cap, generator=gen, device=dev) <= p_rr
            wi = optics.normalize(sampling.sample_uniform_hemisphere(gen, n))
            pdf = sampling.hemisphere_pdf(wi, n)
            fr = sampling.fr_diffuse(hit.kd, wi, n)
            cos_o = torch.clamp((wi * n).sum(dim=-1), min=0.0)
            pdf_ok = torch.isfinite(pdf) & (pdf >= EPSILON)

            # two traces a bounce (NEE shadow + next bounce) from the same
            # offset origin
            o2 = hit.coords + 1e-6 * n
            shadow = nearest_hit(scene, o2, l, lite=True)
            nxt = nearest_hit(scene, o2, wi)

            direct = _nee_eval(scene, hit, n, l, pdf_l, shadow)
            acc = acc + torch.where(live[:, None], tp * direct, 0.0)
            # indirect discards emitter hits (:813-815)
            live = live & survive & pdf_ok & nxt.hit & ~_emissive(nxt.emit)
            w = cos_o / torch.clamp(pdf * p_rr, min=1e-30)
            tp = tp * fr * w[:, None]
            hit = nxt
        if compacted:
            radiance = radiance.index_add(0, pixel, acc)
        else:
            radiance = radiance + acc
    nan_check("path_trace", radiance)
    if with_stats:
        return radiance, {"dropped_lanes": dropped}
    return radiance


def _blocked_path_trace(scene: RTScene, orig, d, key, p_rr, max_bounces,
                        block: int, block_offset: int = 0,
                        compact_schedule: Sequence[float] = COMPACT_SCHEDULE,
                        fused: Optional[bool] = None) -> torch.Tensor:
    """path_trace over fixed-size lane blocks, to bound the plain
    wavefront's working set (the analog of the reference's 16x16 pixel
    tiles, PathTracing.cpp:44-46). `block_offset` keys the RNG by ABSOLUTE
    block index, so a lane range processed apart reproduces the monolithic
    render. The FUSED route ignores `block` and takes the whole wavefront
    in one call, keyed by fold_in(key, block_offset)."""
    n = orig.shape[0]
    kw = dict(p_rr=p_rr, max_bounces=max_bounces,
              compact_schedule=compact_schedule)
    if fused is None or fused or n <= block:
        return path_trace(scene, orig, d, fold_in(key, block_offset),
                          fused=fused, **kw)
    out = [path_trace(scene, orig[s:s + block], d[s:s + block],
                      fold_in(key, block_offset + i), fused=fused, **kw)
           for i, s in enumerate(range(0, n, block))]
    return torch.cat(out)


def path_render_accumulate(scene: RTScene, orig: torch.Tensor,
                           d: torch.Tensor, key, acc: torch.Tensor,
                           start_sample: int, n_samples: int,
                           p_rr: float = 0.8, max_bounces: int = 16,
                           block: int = 1 << 16,
                           compact_schedule: Sequence[float] = COMPACT_SCHEDULE,
                           fused: Optional[bool] = None) -> torch.Tensor:
    """Add `n_samples` fresh per-lane samples into the running sum `acc`
    (N,3) and return it. Sample indices [start_sample, start_sample +
    n_samples) key the RNG, so progressive, resumed and sample-sharded
    renders reproduce the monolithic one (the sample accumulator is the
    checkpoint and the merge format)."""
    key = as_key(key)
    for s in range(n_samples):
        acc = acc + _blocked_path_trace(
            scene, orig, d, fold_in(key, start_sample + s), p_rr, max_bounces,
            block, compact_schedule=compact_schedule, fused=fused)
    return nan_check("path_render_accumulate", acc)


def path_render_sum(scene: RTScene, width: int, height: int, fovy: float,
                    seed, start_sample: int, n_samples: int,
                    p_rr: float = 0.8, max_bounces: int = 16,
                    block: int = 1 << 16,
                    compact_schedule: Sequence[float] = COMPACT_SCHEDULE,
                    fused: Optional[bool] = None) -> torch.Tensor:
    """Sum of the camera frame's samples [start_sample, start_sample +
    n_samples) per pixel: (N,3) float32 on the scene's device. The one
    place that picks the route of a frame (see `path_render` for `fused`)."""
    if camera_kernel_exact(scene) if fused is None else fused:
        check_kernel_scene(scene)
        return path_camera_render(scene, seed, width, height, fovy, n_samples,
                                  start_sample=start_sample, p_rr=p_rr,
                                  max_bounces=max_bounces).T
    orig, d = camera_rays(scene.eye.cpu().numpy(), fovy, width, height,
                          scene.device)
    return path_render_accumulate(
        scene, orig.contiguous(), d.contiguous(), seed,
        torch.zeros((width * height, 3), dtype=torch.float32,
                    device=scene.device),
        start_sample, n_samples, p_rr=p_rr, max_bounces=max_bounces,
        block=block, compact_schedule=compact_schedule, fused=fused)


def path_render(scene: RTScene, width: int, height: int, fovy: float,
                seed, spp: int = 16, p_rr: float = 0.8,
                max_bounces: int = 16, start_sample: int = 0,
                block: int = 1 << 16,
                compact_schedule: Sequence[float] = COMPACT_SCHEDULE,
                fused: Optional[bool] = None) -> torch.Tensor:
    """Mean of `spp` samples [start_sample, start_sample+spp) per pixel:
    (H,W,3) float32 radiance (pre-clamp) on the scene's device. `seed` is
    an integer or a (2,) uint32 key.

    `fused` None: the camera kernel where it is exact, else the wavefront
    on explicit camera rays with its bounce kernel. True: the camera
    kernel (raises for a scene it cannot shade exactly). False: the plain
    wavefront, in lane blocks of `block`.

    Unlike the JAX package, all samples go to one camera-kernel call: a
    CUDA thread reads its sample's seed directly, so nothing is batched
    over start_sample (sums then differ from the JAX batched sum only by
    float32 reassociation)."""
    acc = path_render_sum(scene, width, height, fovy, seed, start_sample, spp,
                          p_rr=p_rr, max_bounces=max_bounces, block=block,
                          compact_schedule=compact_schedule, fused=fused)
    return (acc / float(spp)).reshape(height, width, 3)
