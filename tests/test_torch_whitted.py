"""The plain PyTorch Whitted kernel against the JAX package's Whitted
renders, at 64x64 (and 128x16 for the interpret-mode Pallas kernel).

Both sides get the identical scene (the JAX `RTScene` arrays, through
`rt_scene_from_numpy`); the port's `whitted_render` on CPU tensors runs
`whitted_uber_trace_plain`. The JAX targets are:
  * the level-synchronous wavefront at lossless queue capacity
    (queue_shrink=1.0, queue_factor=2**max_depth): the full binary tree
    per pixel, as the port's per-lane DFS walks it;
  * the Cornell golden of tests/test_goldens.py, by its own rule;
  * the Pallas über-kernel run in interpret mode (uber=True);
  * the literal scalar recursion of tests/oracle_whitted.py (float64), on
    the pixels and with the tolerance tests/test_whitted_oracle.py holds
    the JAX package to.

Tolerances. Both sides follow the same formulas, but XLA's CPU backend
contracts multiplies and adds into FMAs, while torch rounds every
operation on its own; deposits are also summed in another order (DFS
order here, the wavefront's parent-chain fold there). Pixel values then
agree within rtol=1e-4, atol=1e-5 except where the last bit decides a
knife edge. In the diffuse scenes the only such pixels are those whose
camera ray passes exactly through the edge shared by two walls (the box's
corner edges fall on the image diagonals; in float64 the ray meets both
triangles at the same t, with a barycentric of 1e-17): there each side
may shade the other wall. Measured on Cornell at 64x64: 11 of 4096 pixels
(0.27%), every one of them such an edge pixel; the frame means then
differ by 2.7e-4 relative (the walls are ~40 bright before the clamp),
while the means over the other pixels are equal. So the rule for (a) and
(d) is: >= 99.5% of pixels agree, every other pixel is an edge pixel,
the means off the edge pixels agree within 1e-4 relative, and the frame
means within 1e-3. The specular scene (c) follows the rule of
tests/test_uber.py:66-69: a flipped winner diverges through the whole
reflect/refract chain behind it.
"""

import functools
import pathlib

import jax
import numpy as np
import oracle_whitted
import pytest

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.ops.shading import ShaderType
from software_rasterizer_tpu.ops.whitted import whitted_render as jwhitted_render
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.utils.texture import Texture
from software_rasterizer_tpu_torch.ops import whitted_kernel as wk
from software_rasterizer_tpu_torch.ops.intersect import rt_scene_from_numpy
from software_rasterizer_tpu_torch.ops.whitted import whitted_render
from torch_scenes import edge_tie_pixels, mirror_glass_cornell, textured_cornell

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "cornell_goldens.npz"
PIX_RTOL, PIX_ATOL, PIX_SHARE = 1e-4, 1e-5, 0.995
MEAN_RTOL = 1e-4       # over the pixels off the shared edges
FRAME_MEAN_RTOL = 1e-3  # over the whole frame (edge flips included)

# name -> (scene build function, max_depth)
CASES = {
    "cornell": (jcornell, 4),
    "mirror_glass": (lambda: mirror_glass_cornell(jmodels, jcornell), 5),
    "textured": (lambda: textured_cornell(jcornell, ShaderType, Texture), 4),
}


def _arrays(build, w, h):
    scene = build()
    scene.set_ndc_matrix(w, h)
    rt = jprepare(scene.rt_geometry(), scene.rt_frame())
    return scene.fovy, rt, {k: np.asarray(v) for k, v in rt._asdict().items()}


def _port(arrays, w, h, fovy, max_depth):
    launches = wk.LAUNCHES
    img, st = whitted_render(rt_scene_from_numpy(arrays, "cpu"), w, h, fovy,
                             max_depth=max_depth, with_stats=True)
    assert wk.LAUNCHES == launches          # CPU tensors: the plain version
    assert int(st["dropped_rays"]) == 0 and not bool(st["dropped_px"].any())
    return img.numpy(), {k: int(st[k]) for k in ("rays_main", "rays_shadow")}


@functools.lru_cache(maxsize=None)
def _render(name):
    build, md = CASES[name]
    fovy, rt, arrays = _arrays(build, 64, 64)
    want, wst = jwhitted_render(
        rt, 64, 64, fovy, jax.random.PRNGKey(0), spp=1, max_depth=md,
        uber=False, queue_shrink=1.0, queue_factor=2 ** md, with_stats=True)
    assert int(wst["dropped_rays"]) == 0    # the lossless target
    got, st = _port(arrays, 64, 64, fovy, md)
    dirs = np.asarray(jcamera_rays(arrays["eye"], fovy, 64, 64)[1])
    return (got, st, np.asarray(want),
            {k: int(wst[k]) for k in ("rays_main", "rays_shadow")},
            edge_tie_pixels(arrays, dirs).reshape(64, 64))


@pytest.mark.parametrize("name", ["cornell", "textured"])
def test_plain_matches_lossless_wavefront(name):
    got, st, want, wst, edge = _render(name)
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    ok = np.isclose(got, want, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    assert ok.mean() >= PIX_SHARE, (name, int((~ok).sum()))
    assert edge[~ok].all(), np.argwhere(~ok & ~edge)
    assert edge.mean() < 0.02              # the edges are thin (69 of 4096)
    off = ~edge
    m_got, m_want = got[off].mean(dtype=np.float64), want[off].mean(dtype=np.float64)
    assert abs(m_got - m_want) <= MEAN_RTOL * abs(m_want), (m_got, m_want)
    assert abs(got.mean() - want.mean()) <= FRAME_MEAN_RTOL * abs(want.mean())
    assert st == wst, (st, wst)


def test_plain_matches_golden():
    got = _render("cornell")[0]
    want = np.load(GOLDENS)["whitted"]
    # tests/test_goldens.py's rule: a handful of knife-edge pixels may flip
    assert np.isclose(got, want, rtol=5e-3, atol=5e-3).mean() > 0.995


def test_plain_matches_wavefront_mirror_glass():
    got, st, want, wst, _ = _render("mirror_glass")
    assert np.isfinite(got).all()
    flipped = (np.abs(got - want).max(-1) > 1e-3).mean()
    assert flipped < 0.01, f"{flipped:.2%} pixels diverged"
    assert abs(got.mean() - want.mean()) < 0.01 * abs(want.mean())
    for k in st:
        assert abs(st[k] - wst[k]) <= 0.01 * wst[k], (k, st[k], wst[k])
    # the specular branches ran: more main rays than pixels
    assert st["rays_main"] > 64 * 64


def test_plain_matches_pallas_kernel_interpret():
    fovy, rt, arrays = _arrays(jcornell, 128, 16)
    want, wst = jwhitted_render(rt, 128, 16, fovy, jax.random.PRNGKey(0),
                                spp=1, max_depth=3, uber=True, with_stats=True)
    got, st = _port(arrays, 128, 16, fovy, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=PIX_RTOL,
                               atol=PIX_ATOL)
    assert st == {k: int(wst[k]) for k in ("rays_main", "rays_shadow")}


def test_plain_matches_scalar_oracle():
    """The port's Whitted render of Cornell at 24x24, max_depth 5, against
    `oracle_whitted.whitted` on the pixel grid of
    tests/test_whitted_oracle.py (every fifth pixel from (2, 2)), by its
    rule: rtol = atol = 2e-2, at most 2 pixels off (the |t^2 - d^2| > 1e-6
    shadow test flips between float32 and the float64 oracle where squared
    distances near 1 sit at float32's resolution). Pixels whose camera ray
    meets an edge shared by two triangles (`edge_tie_pixels`) are left
    out: there the last bit picks the wall."""
    w = h = 24
    fovy, rt, arrays = _arrays(jcornell, w, h)
    got, _ = _port(arrays, w, h, fovy, 5)
    orig, d = (np.asarray(a) for a in jcamera_rays(rt.eye, fovy, w, h))
    edge = edge_tie_pixels(arrays, d)
    pixels = [(y, x) for y in range(2, h, 5) for x in range(2, w, 5)
              if not edge[y * w + x]]
    assert len(pixels) >= 20
    bad = []
    for py, px in pixels:
        lane = py * w + px
        want = oracle_whitted.whitted(arrays, orig[lane], d[lane])
        if not np.allclose(got[py, px], want, rtol=2e-2, atol=2e-2):
            bad.append(((py, px), got[py, px], want))
    assert len(bad) <= 2, f"mismatches: {bad}"
    assert got[[p[0] for p in pixels], [p[1] for p in pixels]].max() > 0.1
