"""The raster kernels' two-level binning against `bin_triangles`, on the CPU.

On the card the tile kernels bin for themselves (csrc/raster_tiles.cu):
one block per coarse tile compacts the kept triangles whose box meets the
coarse rectangle, in ascending order; each kernel tile then filters its
coarse tile's list with `bin_triangles`' own comparisons.
`raster_kernel.bin_triangles_two_level_plain` is the plain model of that
scan. Its lists, counts and `dropped` must equal `bin_triangles`' entry
for entry: on the lit Cornell box at three tiles, two row offsets and an
overflowing cap, on adversarial boxes (NaN, +-inf, boxes on coarse and
fine tile edges, outside the frame, over the whole frame, nothing kept,
F = 0 and 1, a frame the tiles do not divide), and, for two of the cases,
against the JAX package's `ops/pallas_raster.bin_triangles`. The
`cuda`-marked cases hold the kernels' own lists (`bin_triangles_device`
and the tile launch's `lists_out`) and frames against the same on the
card; they skip here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from software_rasterizer_tpu.ops import pallas_raster as jpr
from software_rasterizer_tpu_torch import models
from software_rasterizer_tpu_torch.ops import raster as tr
from software_rasterizer_tpu_torch.ops import raster_kernel as rk
from software_rasterizer_tpu_torch.ops.shading import ShaderType
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from software_rasterizer_tpu_torch.utils.texture import Texture
from torch_scenes import raster_cornell

SIZE = 128


def _equal(want, got):
    """Lists, counts and dropped equal entry for entry, dtypes included."""
    for name, w, g in zip(("lists", "counts", "dropped"), want, got):
        assert w.dtype == g.dtype == torch.int32, name
        assert w.shape == g.shape, name
        assert torch.equal(w.cpu(), g.cpu()), name


def _lit_tables(device="cpu", size=SIZE, levels=2):
    scene = raster_cornell(models, build_cornell_scene, subdivide_mesh, ShaderType,
                           Texture, levels, "three")
    scene.set_ndc_matrix(size, size)
    geom = tr.prepare_raster_geometry(scene.raster_geometry(), device)
    frame = tr.prepare_raster_frame(scene.raster_frame(), device)
    return tr.raster_tables(geom, frame), frame.lights.contiguous()


@pytest.fixture(scope="module")
def lit():
    (geo, attr, bbox, keep), lights = _lit_tables()
    return {"geo": geo, "attr": attr, "bbox": bbox, "keep": keep, "lights": lights}


def _adversarial(case: str, seed: int = 5):
    """(tri_bbox (F,4) f32, keep (F,) bool) of one adversarial case, in a
    128x128 frame with (16, 32) kernel tiles (coarse tiles of 128x128:
    `coarse_grid`), so edges at multiples of 16 / 32 and of 128 are tile
    and coarse-tile edges."""
    rng = np.random.default_rng(seed)
    f = 64
    lo = rng.uniform(-40.0, 260.0, (f, 2))
    box = np.concatenate([lo, lo + rng.uniform(0.0, 50.0, (f, 2))], 1)
    keep = rng.random(f) < 0.85
    if case == "nan_inf":
        box[0:6, 0] = np.nan
        box[6:12, 3] = np.nan
        box[12:18, 2] = np.inf
        box[18:24, 0] = -np.inf
        box[24:30, 1] = np.inf
        box[30:36] = [-np.inf, -np.inf, np.inf, np.inf]
        box[36:40] = np.nan
    elif case == "edges":
        # the last pixel of a tile, the first of the next, and a coarse edge
        e = np.asarray([15.0, 16.0, 31.0, 32.0, 127.0, 128.0, 255.0, 256.0])
        k = np.arange(f)
        box[:, 0] = e[k % 8]
        box[:, 1] = e[(k // 8) % 8]
        box[:, 2] = box[:, 0] + e[(k * 3) % 8] % 2
        box[:, 3] = box[:, 1] + np.asarray([0.0, 1.0])[(k // 3) % 2]
        box[::5, 2] = box[::5, 0] - 1.0          # inverted: max below min
    elif case == "outside":
        box[0:16] = [-50.0, -50.0, -1.0, -1.0]   # left of and above the frame
        box[16:32] = [300.0, 300.0, 400.0, 400.0]  # past the frame
        box[32:40] = [-50.0, 10.0, 0.0, 20.0]    # ends on column 0
        box[40:48] = [127.0, 127.0, 900.0, 900.0]  # starts on the last pixel
    elif case == "whole_frame":
        box[:] = [0.0, 0.0, 127.0, 127.0]
        box[::2] = [-1e30, -1e30, 1e30, 1e30]
    elif case == "none_kept":
        keep[:] = False
    elif case == "empty":
        return torch.zeros((0, 4)), torch.zeros(0, dtype=torch.bool)
    elif case == "one":
        return torch.tensor([[20.0, 10.0, 40.0, 30.0]]), torch.ones(1, dtype=torch.bool)
    elif case != "random":
        raise ValueError(case)
    return torch.tensor(box.astype(np.float32)), torch.tensor(keep)


CASES = ["random", "nan_inf", "edges", "outside", "whole_frame", "none_kept", "empty", "one"]


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("cap", [2048, 16])
@pytest.mark.parametrize("row0", [0, 40])
@pytest.mark.parametrize("tile", [(16, 32), (8, 8), (32, 32)])
def test_two_level_model_equals_bin_triangles_on_the_lit_box(lit, tile, row0, cap):
    th, tw = tile
    gh, gw = -(-SIZE // th), -(-SIZE // tw)
    want = rk.bin_triangles(lit["bbox"], lit["keep"], gh, gw, th, tw, cap, row0=row0)
    got = rk.bin_triangles_two_level_plain(lit["bbox"], lit["keep"], gh, gw, th, tw, cap,
                                           row0=row0)
    _equal(want, got)
    assert int(want[1].sum()) > 0
    if cap == 16 and tile == (32, 32):
        assert int(want[2]) > 0               # the overflow is exercised


@pytest.mark.parametrize("tile,size", [((16, 32), (128, 128)), ((8, 8), (120, 100)),
                                       ((3, 7), (61, 50)), ((1, 1), (40, 40))])
@pytest.mark.parametrize("case", CASES)
def test_two_level_model_equals_bin_triangles_on_adversarial_boxes(case, tile, size):
    bbox, keep = _adversarial(case)
    th, tw = tile
    h, w = size
    gh, gw = -(-h // th), -(-w // tw)
    for cap, row0 in ((256, 0), (3, -17)):
        want = rk.bin_triangles(bbox, keep, gh, gw, th, tw, cap, row0=row0)
        _equal(want, rk.bin_triangles_two_level_plain(bbox, keep, gh, gw, th, tw, cap,
                                                      row0=row0))


def test_adversarial_cases_reach_what_they_name():
    """The edge boxes land in tiles on both sides of fine and coarse edges,
    the NaN boxes in none, and the overflow case drops."""
    bbox, keep = _adversarial("edges")
    lists, counts, _ = rk.bin_triangles(bbox, keep, 2, 9, 16, 32, 256)
    assert int(counts.sum()) > 0 and int((counts > 0).sum()) > 4
    bbox, keep = _adversarial("nan_inf")
    keep[:] = True
    nan_rows = torch.isnan(bbox).any(dim=1)
    lists, counts, _ = rk.bin_triangles(bbox, keep, 8, 4, 16, 32, 256)
    listed = set(torch.cat([lists[t, :int(counts[t])] for t in range(32)]).tolist())
    assert not listed & set(torch.nonzero(nan_rows).flatten().tolist())
    bbox, keep = _adversarial("whole_frame")
    assert int(rk.bin_triangles(bbox, keep, 8, 4, 16, 32, 16)[2]) > 0


@pytest.mark.parametrize("tile,want", [((16, 32), (8, 4, 1, 1)), ((8, 8), (16, 16, 1, 1)),
                                       ((1, 1024), (128, 1, 1, 1)), ((32, 32), (4, 4, 1, 1)),
                                       ((3, 7), (42, 18, 2, 2)), ((200, 5), (1, 25, 1, 2))])
def test_coarse_grid(tile, want):
    """Coarse tiles of about COARSE_PX pixels a side in whole kernel tiles,
    at least one; a grid they do not divide gets a partial last tile."""
    th, tw = tile
    assert rk.coarse_grid(-(-SIZE // th), -(-SIZE // tw), th, tw) == want
    assert rk.coarse_grid(9, 9, 16, 32) == (8, 4, 2, 3)


@pytest.mark.parametrize("case,tile,cap,row0", [("nan_inf", (16, 32), 256, 0),
                                               ("edges", (8, 8), 3, 40)])
def test_two_level_model_equals_jax_bin_triangles(case, tile, cap, row0):
    bbox, keep = _adversarial(case)
    th, tw = tile
    gh, gw = -(-SIZE // th), -(-SIZE // tw)
    want = jpr.bin_triangles(jnp.asarray(bbox.numpy()), jnp.asarray(keep.numpy()), gh, gw,
                             th, tw, cap, row0=row0)
    want = tuple(torch.as_tensor(np.array(x)) for x in want)
    _equal(want, rk.bin_triangles_two_level_plain(bbox, keep, gh, gw, th, tw, cap,
                                                  row0=row0))


def test_device_binning_rejects_cpu_tensors():
    bbox, keep = _adversarial("one")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.bin_triangles_device(bbox, keep, 1, 1, 16, 32, 16)


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_device_lists_equal_bin_triangles(card, case):
    bbox, keep = (x.to(card) for x in _adversarial(case))
    for (th, tw), (h, w), cap, row0 in (((16, 32), (128, 128), 256, 0),
                                        ((8, 8), (120, 100), 3, 40),
                                        ((3, 7), (61, 50), 5, -17)):
        gh, gw = -(-h // th), -(-w // tw)
        want = rk.bin_triangles(bbox, keep, gh, gw, th, tw, cap, row0=row0)
        _equal(want, rk.bin_triangles_device(bbox, keep, gh, gw, th, tw, cap, row0=row0))


@pytest.mark.cuda
@pytest.mark.parametrize("shaded", [False, True])
def test_kernel_frame_equals_plain_with_an_overflowing_cap(card, shaded):
    (geo, attr, bbox, keep), lights = _lit_tables(card)
    lights = lights if shaded else None
    th, tw, cap = 16, 32, 16
    gh, gw = -(-SIZE // th), -(-SIZE // tw)
    want = rk.bin_triangles(bbox, keep, gh, gw, th, tw, cap)
    lists = torch.zeros((gh * gw, cap), dtype=torch.int32, device=card)
    counts = torch.zeros(gh * gw, dtype=torch.int32, device=card)
    *out, dropped = rk.launch_raster_tiles(
        geo, attr, bbox, keep, lights, height=SIZE, width=SIZE, gh=gh, gw=gw, tile_h=th,
        tile_w=tw, cap=cap, lists_out=lists, counts_out=counts)
    _equal(want, (lists, counts, dropped))
    assert int(dropped) > 0
    plain = rk._tiles_plain(geo, attr, want[0], want[1], lights, SIZE, SIZE, gw, th, tw, 0)
    for name, k, p in zip(("best_z", "best_idx", "planes", "ids"), out, plain):
        if name == "planes" and shaded:   # expf / logf may differ in a last bit
            torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(k, p), name
