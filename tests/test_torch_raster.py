"""The port's raster slice against the JAX package, on the CPU.

Both packages get the same NumPy arrays: the flattened scene tables of
`tests/torch_scenes.raster_cornell` (equal in both packages,
tests/test_torch_scene.py) or arrays from a NumPy seed. On the CPU the
port's tile-kernel wrappers run their plain PyTorch versions; the JAX
package's Pallas kernels run in interpret mode on the very same operand
tables.

XLA:CPU contracts multiply-adds into FMAs and the port rounds every
operation, so a pixel whose barycentric sits at 0 or 1, or whose two
candidate depths are equal, to the last bit may pick another winner.
Winners therefore must agree on >= 99.9% of pixels and every other pixel
must be such a knife edge in float64
(`torch_scenes.raster_knife_edge_pixels`); values are compared on the
agreeing pixels at rtol 1e-5 (float32 rounding of a few operations).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.ops import lines as jlines
from software_rasterizer_tpu.ops import pallas_raster as jpr
from software_rasterizer_tpu.ops import raster as jr
from software_rasterizer_tpu.ops import shading as jsh
from software_rasterizer_tpu.ops import texture_ops as jtex
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.scenes.stress import subdivide_mesh as jsubdivide
from software_rasterizer_tpu.utils.texture import Texture as JTexture
from software_rasterizer_tpu_torch.ops import lines as tlines
from software_rasterizer_tpu_torch.ops import raster as tr
from software_rasterizer_tpu_torch.ops import raster_kernel as rk
from software_rasterizer_tpu_torch.ops import shading as tsh
from software_rasterizer_tpu_torch.ops import texture_ops as ttex
from software_rasterizer_tpu_torch.scenes import build_cornell_scene as tcornell
from torch_scenes import raster_cornell, raster_knife_edge_pixels

GOLDENS = "tests/goldens/cornell_goldens.npz"
SIZE = 128


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _lit(variant, levels=2, size=SIZE):
    """The JAX package's lit Cornell tables (host NumPy) at size x size."""
    scene = raster_cornell(jmodels, jcornell, jsubdivide, jsh.ShaderType,
                           JTexture, levels, variant)
    scene.set_ndc_matrix(size, size)
    geom = scene.raster_geometry()
    active = tuple(sorted(set(int(t) for t in geom.shader_type)))
    return geom, scene.raster_frame(), active


@pytest.fixture(scope="module")
def lit_three():
    return _lit("three")


@pytest.fixture(scope="module")
def tables(lit_three):
    """The tile kernels' operands of the lit scene, computed by the port
    and handed to both packages as NumPy arrays."""
    geom, frame, _ = lit_three
    g = tr.prepare_raster_geometry(geom, "cpu")
    fr = tr.prepare_raster_frame(frame, "cpu")
    geo, attr, bbox, keep = tr.raster_tables(g, fr)
    pos, _ = tr.raster_vertex_stage(g.positions, g.normals, g.vertex_mesh,
                                    fr.ndc_mvp, fr.normal_mat, fr.z_scale,
                                    fr.z_offset)
    tri_pos = pos[g.faces]
    return {"geo": geo.numpy(), "attr": attr.numpy(), "bbox": bbox.numpy(),
            "keep": keep.numpy(), "lights": fr.lights.numpy(),
            "tri_pos": tri_pos.numpy()}


# ------------------------------------------------------------ the stages


def test_vertex_stage_matches(lit_three):
    geom, frame, _ = lit_three
    jp, jn = jr.raster_vertex_stage(
        geom.positions, geom.normals, geom.vertex_mesh, frame.ndc_mvp,
        frame.normal_mat, frame.z_scale, frame.z_offset)
    g = tr.prepare_raster_geometry(geom, "cpu")
    fr = tr.prepare_raster_frame(frame, "cpu")
    tp, tn = tr.raster_vertex_stage(
        g.positions, g.normals, g.vertex_mesh, fr.ndc_mvp, fr.normal_mat,
        fr.z_scale, fr.z_offset)
    # a 4-term dot and a divide per component: float32 rounding only
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-5)
    assert np.array_equal(fr.lights.numpy()[:3], np.asarray(frame.eye, np.float32))
    assert np.array_equal(fr.light_pos.numpy(), frame.light_pos)
    assert np.array_equal(fr.light_int.numpy(), frame.light_int)


def test_triangle_setup_matches():
    rng = np.random.default_rng(5)
    tri = (rng.random((200, 3, 3)) * 64.0).astype(np.float32)
    tri[7, 1] = tri[7, 0]          # a degenerate triangle: inf/nan rows
    jc, jz = jr.triangle_setup(jnp.asarray(tri[..., :2]), jnp.asarray(tri[..., 2]))
    tc, tz = tr.triangle_setup(_t(tri[..., :2]), _t(tri[..., 2]))
    ok = np.ones(200, bool)
    ok[7] = False
    assert not np.isfinite(tc.numpy()[7]).all()
    assert not np.isfinite(np.asarray(jc)[7]).all()
    # the constant terms are differences of products of pixel coordinates
    # (up to 64^2 / area): rtol 1e-5 plus that cancellation's absolute share
    np.testing.assert_allclose(tc.numpy()[ok], np.asarray(jc)[ok], rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(tz.numpy()[ok], np.asarray(jz)[ok], rtol=1e-5, atol=2e-5)


def test_face_cull_mask_matches(tables, lit_three):
    geom, frame, _ = lit_three
    jk = jr.face_cull_mask(jnp.asarray(tables["tri_pos"]), jnp.asarray(frame.eye),
                           jnp.asarray(geom.face_valid))
    assert np.array_equal(np.asarray(jk), tables["keep"])
    assert 0 < tables["keep"].sum() < geom.face_valid.sum()


def test_pack_raster_tables_matches():
    rng = np.random.default_rng(6)
    f = 37
    coef = rng.standard_normal((f, 2, 3)).astype(np.float32)
    zrow = rng.standard_normal((f, 3)).astype(np.float32)
    nrm = rng.standard_normal((f, 3, 3)).astype(np.float32)
    uv = rng.random((f, 3, 2)).astype(np.float32)
    col = rng.random((f, 3, 3)).astype(np.float32)
    st = rng.integers(0, 5, f).astype(np.float32)
    tid = rng.integers(-1, 2, f).astype(np.float32)
    jg, ja = jpr.pack_raster_tables(*map(jnp.asarray, (coef, zrow, nrm, uv, col, st, tid)))
    tg, ta = rk.pack_raster_tables(*map(_t, (coef, zrow, nrm, uv, col, st, tid)))
    assert tg.shape == (f, 12) and ta.shape == (f, 28)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(ta.numpy(), np.asarray(ja))


def _assert_bins_equal(jout, tout):
    (jl, jc, jd), (tl, tc, td) = jout, tout
    jl, jc, tl, tc = np.asarray(jl), np.asarray(jc), tl.numpy(), tc.numpy()
    assert np.array_equal(jc, tc) and int(jd) == int(td)
    live = np.arange(jl.shape[1])[None, :] < jc[:, None]
    assert np.array_equal(jl[live], tl[live])
    assert (np.diff(np.where(live, tl, np.iinfo(np.int32).max), axis=1) >= 0).all()


def test_bin_triangles_overflow_counted():
    """tests/test_raster.py::test_bin_overflow_counted on both packages:
    triangles past the per-tile cap are counted, never lost silently."""
    f = 300
    bbox = np.tile(np.asarray([[10.0, 10.0, 40.0, 40.0]], np.float32), (f, 1))
    keep = np.ones(f, bool)
    tout = rk.bin_triangles(_t(bbox), _t(keep), 1, 2, 128, 128, 256)
    _assert_bins_equal(
        jpr.bin_triangles(jnp.asarray(bbox), jnp.asarray(keep), 1, 2, 128, 128, 256),
        tout)
    assert int(tout[1][0]) == 256 and int(tout[2]) == f - 256 and int(tout[1][1]) == 0


@pytest.mark.parametrize("tile,cap,row0", [((16, 32), 2048, 0), ((8, 8), 16, 0),
                                           ((32, 32), 256, 40)])
def test_bin_triangles_matches(tables, tile, cap, row0):
    th, tw = tile
    gh, gw = -(-SIZE // th), -(-SIZE // tw)
    _assert_bins_equal(
        jpr.bin_triangles(jnp.asarray(tables["bbox"]), jnp.asarray(tables["keep"]),
                          gh, gw, th, tw, cap, row0=row0),
        rk.bin_triangles(_t(tables["bbox"]), _t(tables["keep"]), gh, gw, th, tw,
                         cap, row0=row0))


# --------------------------------------------------------------- shading


def _fragments(n=512, seed=9):
    rng = np.random.default_rng(seed)
    atlas = rng.integers(0, 256, (2, 8, 16, 3), dtype=np.uint8)
    tex_wh = np.asarray([[16, 8], [5, 7]], np.int32)
    uv = rng.random((n, 2)).astype(np.float32)
    uv[:8, 0] = 1.0                   # u == 1 -> black
    uv[8:16, 1] = 1.0                 # v == 1 -> black
    uv[16:24] = -0.25                 # clamped to 0
    uv[24:32] = 1.5                   # clamped to 1 -> black
    tex_id = rng.integers(0, 2, n).astype(np.int32)
    tex_id[32:48] = -1                # no texture -> black
    return {
        "atlas": atlas, "tex_wh": tex_wh, "uv": uv, "tex_id": tex_id,
        "shader_type": rng.integers(0, 5, n).astype(np.int32),
        "eye": np.asarray([0.0, 0.0, -0.9], np.float32),
        "position": np.concatenate([rng.random((n, 2)) * 64.0,
                                    90.0 + rng.random((n, 1))], 1).astype(np.float32),
        "normal": rng.standard_normal((n, 3)).astype(np.float32),
        "color": rng.random((n, 3)).astype(np.float32),
        "light_pos": np.asarray([[0.9, 0.9, -0.9], [0.0, 0.8, 0.9]], np.float32),
        "light_int": np.asarray([[100.0] * 3, [50.0, 40.0, 30.0]], np.float32),
    }


@pytest.mark.parametrize("packed", [False, True])
def test_fetch_nearest_matches(packed):
    fr = _fragments()
    jp = jnp.asarray(jtex.pack_atlas(fr["atlas"])) if packed else None
    tp = _t(ttex.pack_atlas(fr["atlas"])) if packed else None
    want = np.asarray(jtex.fetch_nearest(
        jnp.asarray(fr["atlas"]), jnp.asarray(fr["tex_wh"]),
        jnp.asarray(fr["tex_id"]), jnp.asarray(fr["uv"]), packed=jp))
    got = ttex.fetch_nearest(_t(fr["atlas"]), _t(fr["tex_wh"]), _t(fr["tex_id"]),
                             _t(fr["uv"]), packed=tp).numpy()
    # texels are u8 / 255 on both sides: the same float32 values
    assert np.array_equal(got, want)
    assert (got[:16] == 0).all() and (got[24:48] == 0).all() and got[48:].any()


@pytest.mark.parametrize("types", [(0,), (1,), (2,), (3,), (4,), None],
                         ids=["normal", "texture", "phong", "displacement",
                              "bump", "all"])
def test_shade_fragments_matches(types):
    fr = _fragments()
    st = fr["shader_type"] if types is None else np.full_like(fr["shader_type"], types[0])
    names = ("eye", "position", "normal", "uv", "color", "tex_id", "atlas",
             "tex_wh", "light_pos", "light_int")
    want = np.asarray(jsh.shade_fragments(
        jnp.asarray(st), *(jnp.asarray(fr[k]) for k in names), active_types=types))
    got = tsh.shade_fragments(_t(st), *(_t(fr[k]) for k in names),
                              active_types=types).numpy()
    assert got.shape == want.shape == (st.shape[0], 3) and np.isfinite(got).all()
    # sums of a few float32 products, a pow and square roots per light
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------ the tile kernels' plain versions


def _check_winners(tables, got_idx, want_idx, row0=0):
    got_idx, want_idx = np.asarray(got_idx), np.asarray(want_idx)
    differ = got_idx != want_idx
    assert differ.mean() <= 1e-3, f"{int(differ.sum())} winners differ"
    knife = raster_knife_edge_pixels(tables["geo"], got_idx, want_idx, row0=row0)
    assert (knife == differ).all(), f"{int((differ & ~knife).sum())} real disagreements"
    return ~differ


@pytest.mark.parametrize("cap,tile,row0", [(2048, (16, 32), 0), (8, (128, 128), 0),
                                           (2048, (8, 16), 64)],
                         ids=["default", "tiny_cap_overflows", "row0"])
def test_fused_plain_matches_pallas_interpret(tables, cap, tile, row0):
    """Kernel #10: `_tile_kernel` in interpret mode against the port's
    plain version, on the same geo / attr / bbox arrays. With the tiny
    cap both bin with the same tile, so both drop the same triangles."""
    h = SIZE - row0
    jtile = (128, 128)
    ttile = jtile if cap < 256 else tile
    want = jpr.raster_tiles_fused(
        *(jnp.asarray(tables[k]) for k in ("geo", "attr", "bbox", "keep")),
        h, SIZE, tile_h=jtile[0], tile_w=jtile[1], cap=cap, interpret=True,
        row0=row0)
    got = rk.raster_tiles_fused(
        *(_t(tables[k]) for k in ("geo", "attr", "bbox", "keep")), h, SIZE,
        tile_h=ttile[0], tile_w=ttile[1], cap=cap, row0=row0)
    assert int(got["bin_dropped"]) == int(want["bin_dropped"])
    assert (int(got["bin_dropped"]) > 0) == (cap < 256)
    same = _check_winners(tables, got["best_idx"].numpy(), want["best_idx"], row0)
    assert (got["best_idx"].numpy() >= 0).mean() > (0.3 if cap >= 256 else 0.01)
    np.testing.assert_allclose(got["best_z"].numpy()[same],
                               np.asarray(want["best_z"])[same], rtol=1e-5)
    for k in ("normal", "uv", "color"):
        # barycentrics carry an absolute error of ~1e-6 (the affine terms
        # cancel), which the attribute inherits
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(want[k])[same],
                                   rtol=1e-5, atol=1e-5)
    for k in ("shader_type", "tex_id"):
        assert np.array_equal(got[k].numpy()[same], np.asarray(want[k])[same])
    unc = got["best_idx"].numpy() < 0
    assert np.isinf(got["best_z"].numpy()[unc]).all()
    assert (got["tex_id"].numpy()[unc] == -1).all()


def test_shaded_plain_matches_pallas_interpret(tables, lit_three):
    """Kernel #11: `_tile_kernel_shaded` in interpret mode against the
    port's plain version, on the same arrays and light table."""
    n_lights = (tables["lights"].size - 3) // 6
    want = jpr.raster_tiles_shaded(
        *(jnp.asarray(tables[k]) for k in ("geo", "attr", "bbox", "keep", "lights")),
        SIZE, SIZE, interpret=True, n_lights=n_lights, active_types=lit_three[2])
    got = rk.raster_tiles_shaded(
        *(_t(tables[k]) for k in ("geo", "attr", "bbox", "keep", "lights")),
        SIZE, SIZE)
    assert int(got["bin_dropped"]) == int(want["bin_dropped"]) == 0
    same = _check_winners(tables, got["best_idx"].numpy(), want["best_idx"])
    np.testing.assert_allclose(got["best_z"].numpy()[same],
                               np.asarray(want["best_z"])[same], rtol=1e-5)
    for k in ("direct", "tex_a", "tex_b", "uv"):
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(want[k])[same],
                                   rtol=1e-5, atol=1e-5)
    assert np.array_equal(got["tex_id"].numpy()[same], np.asarray(want["tex_id"])[same])
    assert (got["tex_id"].numpy() >= 0).any() and got["direct"].numpy().any()


@pytest.mark.parametrize("tile", [(8, 8), (32, 32), (64, 64)])
def test_outputs_do_not_depend_on_tile(tables, tile):
    args = [_t(tables[k]) for k in ("geo", "attr", "bbox", "keep", "lights")]
    ref = rk.raster_tiles_shaded(*args, SIZE, SIZE)
    got = rk.raster_tiles_shaded(*args, SIZE, SIZE, tile_h=tile[0], tile_w=tile[1])
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_launch_rejects_cpu_tensors():
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.launch_raster_tiles(z((1, 12)), z((1, 28)), z((1, 4), dtype=torch.int32),
                               z(1, dtype=torch.int32), None, height=4, width=4,
                               gh=1, gw=1, tile_h=4, tile_w=4)


# ------------------------------------------------------------ whole slice


def test_shaded_equals_deferred(lit_three):
    """The claim of tests/test_raster_shaded.py inside the port: identical
    z-buffers, and images equal to reassociation (rtol = atol = 1e-5)."""
    geom, frame, active = lit_three
    g = tr.prepare_raster_geometry(geom, "cpu")
    img_d, z_d, st_d = tr.render_raster_frame(g, frame, SIZE, SIZE,
                                              active_types=active, with_stats=True)
    img_s, z_s, st_s = tr.render_raster_frame(g, frame, SIZE, SIZE, shaded=True,
                                              active_types=active, with_stats=True)
    assert st_d["kernel"] == "raster_tiles" and st_s["kernel"] == "raster_tiles_shaded"
    assert torch.equal(z_s, z_d)
    np.testing.assert_allclose(img_s.numpy(), img_d.numpy(), rtol=1e-5, atol=1e-5)


def test_shaded_request_falls_back_to_fused_for_bump():
    """The JAX dispatch rule: BUMP / DISPLACEMENT keep the deferred path,
    and stats names the kernel that ran."""
    geom, frame, active = _lit("five", size=32)
    assert set(active) == {0, 1, 2, 3, 4}
    g = tr.prepare_raster_geometry(geom, "cpu")
    _, _, st = tr.render_raster_frame(g, frame, 32, 32, shaded=True,
                                      active_types=active, with_stats=True)
    assert st["kernel"] == "raster_tiles" and int(st["bin_dropped"]) == 0
    _, _, st = tr.render_raster_frame(g, frame, 32, 32, shaded=True,
                                      with_stats=True)
    assert st["kernel"] == "raster_tiles"     # active_types unknown


def test_raster_golden():
    """tests/test_goldens.py::test_raster_golden's rule on the port."""
    goldens = np.load(GOLDENS)
    scene = tcornell()
    scene.set_ndc_matrix(96, 96)
    g = tr.prepare_raster_geometry(scene.raster_geometry(), "cpu")
    img, z = tr.render_raster_frame(g, scene.raster_frame(), 96, 96)
    img, z = img.numpy(), z.numpy()
    got_cov, want_cov = np.isfinite(z), np.isfinite(goldens["raster_z"])
    assert (got_cov != want_cov).mean() < 0.01
    both = got_cov & want_cov
    assert both.sum() > 500
    np.testing.assert_allclose(img[both], goldens["raster"][both], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(z[both], goldens["raster_z"][both], rtol=1e-5)


@pytest.mark.parametrize("variant", ["three", "five"])
def test_lit_cornell_matches_jax(variant):
    """`render_raster_frame` of both packages (the JAX one on its XLA
    route) on the lit, tessellated Cornell box."""
    size = 96
    geom, frame, active = _lit(variant, levels=2, size=size)
    jimg, jz = jr.render_raster_frame(geom, frame, size, size, active_types=active)
    jimg, jz = np.asarray(jimg), np.asarray(jz)
    g = tr.prepare_raster_geometry(geom, "cpu")
    img, z = tr.render_raster_frame(g, frame, size, size, active_types=active)
    img, z = img.numpy(), z.numpy()
    got_cov, want_cov = np.isfinite(z), np.isfinite(jz)
    assert (got_cov != want_cov).mean() < 0.01
    both = got_cov & want_cov
    assert both.mean() > 0.4 and img[both].std() > 0.05
    np.testing.assert_allclose(img[both], jimg[both], rtol=1e-3, atol=1e-3)
    # each package rounds its own triangle setup, and the affine depth's
    # terms cancel, so z agrees to 1e-4, not to the 1e-5 of the kernel
    # tests that share one coefficient table
    np.testing.assert_allclose(z[both], jz[both], rtol=1e-4)


def _oracle_coverage(tri, h, w):
    """tests/test_raster.py's NumPy brute-force min-z rasterization."""
    ys, xs = np.mgrid[0:h, 0:w]
    best_z = np.full((h, w), np.inf)
    best_i = np.full((h, w), -1)
    for t in range(tri.shape[0]):
        a_, b_, c_ = tri[t]
        d = (b_[0] - a_[0]) * (c_[1] - a_[1]) - (b_[1] - a_[1]) * (c_[0] - a_[0])
        a = ((b_[1] - c_[1]) * xs + (c_[0] - b_[0]) * ys + b_[0] * c_[1] - c_[0] * b_[1]) / d
        b = ((c_[1] - a_[1]) * xs + (a_[0] - c_[0]) * ys + c_[0] * a_[1] - a_[0] * c_[1]) / d
        g = 1 - a - b
        inside = (a > 0) & (a < 1) & (b > 0) & (b < 1) & (g > 0) & (g < 1)
        zz = a * tri[t, 0, 2] + b * tri[t, 1, 2] + g * tri[t, 2, 2]
        upd = inside & (zz < best_z)
        best_z[upd] = zz[upd]
        best_i[upd] = t
    return best_i, best_z


def test_colored_triangles_match_oracle_and_jax():
    h = w = 160
    rng = np.random.RandomState(3)
    tri = rng.rand(8, 3, 3).astype(np.float32)
    tri[..., 0] *= w
    tri[..., 1] *= h
    col = rng.rand(8, 3, 3).astype(np.float32)
    img, z = tr.render_colored_triangles(_t(tri), _t(col), torch.ones(8, dtype=torch.bool), h, w)
    img, z = img.numpy(), z.numpy()
    oi, oz = _oracle_coverage(tri, h, w)
    assert ((z < np.inf) == (oi >= 0)).all()
    np.testing.assert_allclose(np.where(np.isfinite(z), z, 0),
                               np.where(oi >= 0, oz, 0), atol=2e-3)
    jimg, jz = jr.render_colored_triangles(jnp.asarray(tri), jnp.asarray(col),
                                           jnp.ones(8, bool), h, w, tile=(32, 128))
    assert np.array_equal(np.isfinite(z), np.isfinite(np.asarray(jz)))
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shaded", [False, True])
def test_row0_shards_reassemble_bit_exactly(lit_three, shaded):
    geom, frame, active = lit_three
    g = tr.prepare_raster_geometry(geom, "cpu")
    kw = dict(active_types=active, shaded=shaded)
    img, z = tr.render_raster_frame(g, frame, SIZE, SIZE, **kw)
    parts = [tr.render_raster_frame(g, frame, 32, SIZE, row0=r, **kw)
             for r in range(0, SIZE, 32)]
    assert torch.equal(torch.cat([p[0] for p in parts]), img)
    assert torch.equal(torch.cat([p[1] for p in parts]), z)


def test_wireframe_matches_jax():
    """The z plane (a scatter-min) is defined in both packages; a pixel's
    colour is compared where a single edge touches it."""
    SIZE = 64
    geom, frame, _ = _lit("three", levels=1, size=SIZE)
    jimg, jz = jlines.rasterize_wireframe(geom, frame, SIZE, SIZE)
    jimg, jz = np.asarray(jimg), np.asarray(jz)
    g = tr.prepare_raster_geometry(geom, "cpu")
    img, z = tlines.rasterize_wireframe(g, frame, SIZE, SIZE)
    img, z = img.numpy(), z.numpy()
    cov = np.isfinite(z)
    # a sample within float32 rounding of a pixel boundary may land in the
    # neighbouring pixel
    assert (cov != np.isfinite(jz)).mean() < 2e-3
    both = cov & np.isfinite(jz)
    assert both.sum() > 200
    np.testing.assert_allclose(z[both], jz[both], rtol=1e-5, atol=1e-5)
    # pixels that one edge alone touches: count the edges per pixel
    fr = tr.prepare_raster_frame(frame, "cpu")
    pos, _ = tr.raster_vertex_stage(g.positions, g.normals, g.vertex_mesh,
                                    fr.ndc_mvp, fr.normal_mat, fr.z_scale, fr.z_offset)
    tri = pos[g.faces]
    p0 = torch.cat([tri[:, 1], tri[:, 1], tri[:, 0]])
    p1 = torch.cat([tri[:, 0], tri[:, 2], tri[:, 2]])
    valid = torch.cat([g.face_valid] * 3)
    touched = np.zeros((SIZE, SIZE), np.int64)
    for e in np.flatnonzero(valid.numpy()):
        one, _ = tlines.draw_lines(p0[e:e + 1], p1[e:e + 1], torch.ones(1, 3),
                                   valid[e:e + 1], SIZE, SIZE)
        touched += one.numpy().any(-1)
    single = both & (touched == 1)
    assert single.sum() > 50
    np.testing.assert_allclose(img[single], jimg[single], rtol=1e-6, atol=1e-6)
