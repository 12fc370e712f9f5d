"""The port's explicit-ray tracing layer against the JAX package's:
`nearest_hit` (full, `lite`, `defer_color`), `nearest_emit_hit`,
`classify_hit` + `surface_attrs`, `intersect_spheres` and
`intersect_triangles`, on Cornell, Cornell with a mirror and a glass
sphere, Cornell with a textured back wall and an emissive-sphere scene.

Both sides get the identical scene (the JAX `RTScene` arrays, through
`rt_scene_from_numpy`) and the same rays: the 32x32 camera rays and
seeded bounce rays leaving the surfaces they hit. On the CPU the JAX
side searches with its XLA sweep (`_intersect_tri_raw`) and the port
with the plain version of its trace kernel.

Tolerances. Where the two sides pick the same winner, the integer fields
(prim, mat, obj, mat_type, tex, is_sphere, hit) are equal and the floats
agree within rtol=1e-5, atol=1e-6 (XLA:CPU contracts multiply-adds into
FMAs, torch rounds each operation); t, u and v within 1e-6 absolute
beside the same rtol. That is for the camera rays; the seeded bounce
rays include grazing ones, whose |det| is small and whose u, v and t
carry the rounding noise times 1/|det|, so they are held to rtol=1e-4,
atol=1e-5. The winners agree on >= 99% of the rays (Cornell's
corner edges fall on the image diagonals: at 32x32 about 0.9% of the
camera rays meet an edge shared by two triangles), and every other ray
is a proven knife edge (`torch_scenes.mt_knife_edge_rays`) or has a
sphere among its two winners at t within 1e-5 relative.

The trace tiers (`_trace_backend`, `backend=`): on the Cornell box
tessellated by `torch_scenes.stress_cornell`, every `backend` gives the
same record in all fields bit for bit (the tiers run the same
Moller-Trumbore expressions under a conservative cull; a ray proven to
meet its winner's chunk box on a knife edge,
`torch_scenes.slab_knife_edge_rays`, would be excused, and none is
needed at these sizes), and at 147,456 triangles the culled tiers and the
BVH traversal equal the unculled sweep.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.models.scene import Scene as JScene
from software_rasterizer_tpu.ops import intersect as ji
from software_rasterizer_tpu.ops.camera import camera_rays as jcamera_rays
from software_rasterizer_tpu.ops.shading import ShaderType
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.scenes.stress import subdivide_mesh as jsubdivide
from software_rasterizer_tpu.utils.texture import Texture
from software_rasterizer_tpu_torch.ops import intersect as ti
from software_rasterizer_tpu_torch.ops import trace_kernel as tk
from software_rasterizer_tpu_torch.ops import bvh as tbvh
from software_rasterizer_tpu_torch.ops import trace_tiers as tt
from software_rasterizer_tpu_torch.ops.camera import camera_rays as tcamera_rays
from software_rasterizer_tpu_torch.scenes import build_cornell_scene as tcornell
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh as tsubdivide
from torch_scenes import (
    mirror_glass_cornell,
    mt_knife_edge_rays,
    slab_knife_edge_rays,
    spheres,
    stress_cornell,
    textured_cornell,
)

W = H = 32
RTOL, ATOL, WIN_SHARE = 1e-5, 1e-6, 0.99

SCENES = {
    "cornell": jcornell,
    "cornell_spheres": lambda: mirror_glass_cornell(jmodels, jcornell),
    "textured": lambda: textured_cornell(jcornell, ShaderType, Texture),
    "emissive_sphere": lambda: spheres(jmodels, JScene),
}
INT_FIELDS = ("hit", "is_sphere", "prim", "mat", "obj", "mat_type", "tex")
FLOAT_FIELDS = ("coords", "normal", "color", "emit", "kd", "ior", "tuv")


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX scene, port scene, arrays, {"camera": (o, d), "bounce": (o, d)})."""
    scene = SCENES[name]()
    scene.set_ndc_matrix(W, H)
    jrt = ji.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    trt = ti.rt_scene_from_numpy(arrays, "cpu")
    orig, d = (np.asarray(x) for x in jcamera_rays(jrt.eye, scene.fovy, W, H))
    h = ti.nearest_hit(trt, torch.from_numpy(orig.copy()), torch.from_numpy(d.copy()))
    keep = h.hit.numpy()
    g = np.random.default_rng(3)
    bd = g.normal(size=(int(keep.sum()), 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    # off the surface along the normal, as the integrators offset
    bo = (h.coords + 1e-4 * h.normal).numpy()[keep]
    return jrt, trt, arrays, {"camera": (orig, d), "bounce": (bo, bd)}


def _same_winner(arrays, orig, d, got, want):
    """(N,) bool: both sides picked the same primitive; checks the share
    and proves the rest knife edges."""
    g_sph, w_sph = got.is_sphere.numpy(), np.asarray(want.is_sphere)
    g_hit, w_hit = got.hit.numpy(), np.asarray(want.hit)
    g_prim = np.where(g_hit, got.prim.numpy(), -1)
    w_prim = np.where(w_hit, np.asarray(want.prim), -1)
    same = (g_prim == w_prim) & (g_sph == w_sph) & (g_hit == w_hit)
    assert same.mean() >= WIN_SHARE, int((~same).sum())
    tris = ~g_sph & ~w_sph
    edge = mt_knife_edge_rays(arrays["tri_table"], orig, d, g_prim, w_prim)
    g_t, w_t = got.t.numpy(), np.asarray(want.t)
    tie = np.abs(g_t - w_t) <= 1e-5 * np.maximum(np.abs(g_t), np.abs(w_t))
    explained = np.where(tris, edge, tie)
    assert explained[~same].all(), np.flatnonzero(~same & ~explained)
    return same


def _compare_hits(arrays, orig, d, got, want, bary=True, loose=False):
    same = _same_winner(arrays, orig, d, got, want)
    RTOL, ATOL = (1e-4, 1e-5) if loose else (1e-5, 1e-6)
    T_ATOL = 1e-5 if loose else 1e-6
    for f in INT_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert np.array_equal(g[same], w[same]), f
    hit = same & got.hit.numpy()
    for f in FLOAT_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_allclose(g[hit], w[hit], rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=RTOL, atol=T_ATOL)
    if bary:
        tri = hit & ~got.is_sphere.numpy()
        for f in ("bary_u", "bary_v"):
            np.testing.assert_allclose(getattr(got, f).numpy()[tri],
                                       np.asarray(getattr(want, f))[tri],
                                       rtol=RTOL, atol=T_ATOL, err_msg=f)
    # a miss has t = BIG on both sides; a sphere's colour is 0
    miss = same & ~got.hit.numpy()
    assert (got.t.numpy()[miss] == np.float32(1e30)).all()
    assert (np.asarray(want.t)[miss] == np.float32(1e30)).all()
    assert (got.color.numpy()[got.is_sphere.numpy()] == 0).all()
    return same


def _rays(rays):
    o, d = rays
    return (torch.from_numpy(o.copy()), torch.from_numpy(d.copy()),
            jnp.asarray(o), jnp.asarray(d))


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_nearest_hit_matches_jax(name, kind):
    jrt, trt, arrays, rays = _setup(name)
    to, td, jo, jd = _rays(rays[kind])
    launches = tk.LAUNCHES
    got = ti.nearest_hit(trt, to, td)
    assert tk.LAUNCHES == launches            # CPU tensors: the plain version
    want = ji.nearest_hit(jrt, jo, jd)
    _compare_hits(arrays, *rays[kind], got, want, loose=kind == "bounce")
    assert got.hit.any()
    if name == "textured" and kind == "camera":
        # the back wall shows texels, not its Kd
        texed = (got.tex >= 0) & got.hit
        assert texed.any() and not torch.equal(got.color[texed], got.kd[texed])
    if name == "cornell_spheres" and kind == "camera":
        assert got.is_sphere.any() and (got.tex[got.is_sphere] == -1).all()


@pytest.mark.parametrize("mode", ["lite", "defer_color", "sphere_t_min"])
@pytest.mark.parametrize("name", ["cornell_spheres", "textured"])
def test_nearest_hit_modes_match_jax(name, mode):
    jrt, trt, arrays, rays = _setup(name)
    to, td, jo, jd = _rays(rays["camera"])
    kw = {"lite": dict(lite=True), "defer_color": dict(defer_color=True),
          "sphere_t_min": dict(sphere_t_min=0.5)}[mode]
    got = ti.nearest_hit(trt, to, td, **kw)
    want = ji.nearest_hit(jrt, jo, jd, **kw)
    _compare_hits(arrays, *rays["camera"], got, want)
    hit = got.hit
    if mode == "lite":
        assert (got.color == 0).all() and (got.tuv == 0).all()
    if mode == "defer_color":
        tri = hit & ~got.is_sphere
        assert torch.equal(got.color[tri], got.kd[tri])
        if name == "textured":
            assert (got.tex[tri] >= 0).any()     # the texel is still to fetch


@pytest.mark.parametrize("name", sorted(SCENES))
def test_nearest_emit_hit_matches_jax(name):
    jrt, trt, arrays, rays = _setup(name)
    to, td, jo, jd = _rays(rays["bounce"])
    got = ti.nearest_emit_hit(trt, to, td)
    want = ji.nearest_emit_hit(jrt, jo, jd)
    full = ti.nearest_hit(trt, to, td)
    same = _same_winner(arrays, *rays["bounce"], full, ji.nearest_hit(jrt, jo, jd))
    assert np.array_equal(got.hit.numpy()[same], np.asarray(want.hit)[same])
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same],
                               rtol=1e-4, atol=1e-5)      # bounce rays
    np.testing.assert_allclose(got.emit.numpy()[same], np.asarray(want.emit)[same],
                               rtol=RTOL, atol=ATOL)
    # the minimal epilogue agrees with the full one
    assert torch.equal(got.t, full.t) and torch.equal(got.hit, full.hit)
    hit = full.hit
    assert torch.equal(got.emit[hit], full.emit[hit])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_classify_then_surface_attrs_matches_jax(name):
    jrt, trt, arrays, rays = _setup(name)
    to, td, jo, jd = _rays(rays["camera"])
    lh = ti.classify_hit(trt, to, td)
    jlh = ji.classify_hit(jrt, jo, jd)
    got = ti.surface_attrs(trt, to, td, lh)
    want = ji.surface_attrs(jrt, jo, jd, jlh)
    same = _compare_hits(arrays, *rays["camera"], got, want)
    for f in ("hit", "use_s", "mat_type"):
        assert np.array_equal(getattr(lh, f).numpy()[same],
                              np.asarray(getattr(jlh, f))[same]), f
    for f, sel in (("tri", ~lh.use_s & lh.hit), ("sph", lh.use_s)):
        s = same & sel.numpy()
        assert np.array_equal(getattr(lh, f).numpy()[s], np.asarray(getattr(jlh, f))[s])
    np.testing.assert_allclose(lh.st.numpy(), np.asarray(jlh.st), rtol=RTOL)
    np.testing.assert_allclose(lh.t_tri.numpy()[same], np.asarray(jlh.t_tri)[same],
                               rtol=RTOL, atol=1e-6)
    # the split form equals nearest_hit in the port, field for field
    whole = ti.nearest_hit(trt, to, td)
    agree = (whole.prim == got.prim) & (whole.is_sphere == got.is_sphere)
    assert agree.float().mean() >= 0.999
    for f in ("t", "coords", "normal", "color", "emit", "kd"):
        assert torch.equal(getattr(whole, f)[agree], getattr(got, f)[agree]), f


@pytest.mark.parametrize("t_min", [0.0, 0.3])
def test_intersect_spheres_matches_jax(t_min):
    jrt, trt, _, rays = _setup("cornell_spheres")
    to, td, jo, jd = _rays(rays["camera"])
    t, i = ti.intersect_spheres(to, td, trt.sph_c, trt.sph_r, trt.sph_valid, t_min)
    wt, wi = ji.intersect_spheres(jo, jd, jrt.sph_c, jrt.sph_r, jrt.sph_valid, t_min)
    assert np.array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=RTOL)
    assert (i >= 0).any() and (t[i < 0] == 1e30).all()
    # no spheres at all: every ray misses
    t0, i0 = ti.intersect_spheres(to, td, trt.sph_c[:0], trt.sph_r[:0],
                                  trt.sph_valid[:0])
    assert (t0 == 1e30).all() and (i0 == -1).all()


def test_intersect_triangles_matches_jax():
    jrt, trt, arrays, rays = _setup("cornell")
    to, td, jo, jd = _rays(rays["camera"])
    t, i, u, v = ti.intersect_triangles(to, td, trt.v0, trt.v1, trt.v2, trt.tri_valid)
    wt, wi, wu, wv = (np.asarray(x) for x in ji.intersect_triangles(
        jo, jd, jrt.v0, jrt.v1, jrt.v2, jrt.tri_valid))
    same = i.numpy() == wi
    assert same.mean() >= WIN_SHARE
    assert mt_knife_edge_rays(arrays["tri_table"], *rays["camera"], i.numpy(),
                              wi)[~same].all()
    hit = same & (wi >= 0)
    for g, w in ((t, wt), (u, wu), (v, wv)):
        np.testing.assert_allclose(g.numpy()[hit], w[hit], rtol=RTOL, atol=1e-6)
    assert (t.numpy()[same & (wi < 0)] == np.float32(1e30)).all()


def test_rt_scene_carries_the_new_fields():
    """`prepare_rt_scene` of the port builds what the JAX package's
    builds, for the fields the tracing layer reads."""
    from software_rasterizer_tpu_torch import models as tmodels
    from software_rasterizer_tpu_torch.scenes import build_cornell_scene

    scene = mirror_glass_cornell(tmodels, build_cornell_scene)
    scene.set_ndc_matrix(W, H)
    got = ti.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    want = _setup("cornell_spheres")[2]
    for f in ("tri_obj", "sph_obj", "emitter_mask", "emitter_order"):
        assert np.array_equal(getattr(got, f).numpy(), want[f]), f
    for f in ("emitter_center", "emitter_radius", "prim_attr", "prim_shadow",
              "prim_cls"):
        g = getattr(got, f).numpy()
        assert g.shape == want[f].shape and g.dtype == np.float32, f
        np.testing.assert_allclose(g, want[f], rtol=1e-5, atol=1e-6, err_msg=f)


# ------------------------------------------------------- the trace tiers


@pytest.mark.parametrize("f_pad,want", [
    (128, "vpu"), (1024, "vpu"), (1025, "mm2c"), (9216, "mm2c"), (16384, "mm2c"),
    (16385, "mm2s"), (147456, "mm2s"), (4_000_000, "mm2s")])
def test_trace_backend_by_triangle_count(f_pad, want, monkeypatch):
    monkeypatch.setenv("SRT_MM_TRACE", "1")      # read by the JAX package only
    assert ti._trace_backend(f_pad) == want
    assert ti._cull_granule(f_pad) == (128 if f_pad <= 16384 else 256)
    assert want in ti.TRACE_BACKENDS


@functools.lru_cache(maxsize=None)
def _stress(levels, w=24):
    """(port scene on the CPU, camera rays, bounce rays) of the tessellated
    Cornell box at `levels`."""
    scene = stress_cornell(tcornell, tsubdivide, levels)
    scene.set_ndc_matrix(w, w)
    rt = ti.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame(), "cpu")
    o, d = (x.contiguous() for x in tcamera_rays(rt.eye.numpy(), scene.fovy, w, w, "cpu"))
    h = ti.nearest_hit(rt, o, d, backend="mm2")
    g = np.random.default_rng(3)
    bd = g.normal(size=(int(h.hit.sum()), 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    bo = (h.coords + 1e-4 * h.normal)[h.hit].contiguous()
    return rt, (o, d), (bo, torch.from_numpy(bd))


def _excused(rt, o, d, ref_idx):
    return torch.from_numpy(slab_knife_edge_rays(
        rt.chunk_lo.numpy(), rt.chunk_hi.numpy(), rt.cull_chunk, o.numpy(),
        d.numpy(), ref_idx.numpy()))


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("levels,default", [(2, "vpu"), (3, "mm2c")])
def test_every_backend_gives_the_same_hit(levels, default, kind):
    rt, cam, bounce = _stress(levels)
    o, d = cam if kind == "camera" else bounce
    assert rt.n_tri == 36 * 4 ** levels
    assert ti._trace_backend(rt.v0.shape[0]) == default
    assert rt.chunk_lo.shape == (-(-rt.v0.shape[0] // 128), 3) and rt.cull_chunk == 128
    ref = ti.nearest_hit(rt, o, d, backend="vpu")
    assert ref.hit.float().mean() > 0.5
    skip = _excused(rt, o, d, torch.where(ref.hit & ~ref.is_sphere, ref.prim, -1))
    for backend in (None, "mm2c", "mm2", "mm2s"):
        got = ti.nearest_hit(rt, o, d, backend=backend)
        assert len(got) == 17
        for f, a, b in zip(got._fields, got, ref):
            same = (a == b) | ((a != a) & (b != b)) if a.is_floating_point() else a == b
            same = same.reshape(same.shape[0], -1).all(dim=1)
            assert bool((same | skip).all()), (backend, f, int((~same).sum()))
        e = ti.nearest_emit_hit(rt, o, d, backend=backend)
        assert torch.equal(e.t, got.t) and torch.equal(e.hit, got.hit)
        lh = ti.classify_hit(rt, o, d, backend=backend)
        assert torch.equal(lh.hit, got.hit)
        assert torch.equal(lh.tri[got.hit], got.prim[got.hit])
    with pytest.raises(ValueError, match="unknown trace backend"):
        ti.nearest_hit(rt, o, d, backend="mm")


def test_stress_scene_chunk_tables_match_jax():
    """`chunk_lo/hi` of the port's `prepare_rt_scene` against the JAX
    package's on the tessellated box (2,304 triangles, 18 chunks), and
    carried over by `rt_scene_from_numpy` unchanged."""
    scene = stress_cornell(jcornell, jsubdivide, 3)
    scene.set_ndc_matrix(24, 24)
    jrt = ji.prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    carried = ti.rt_scene_from_numpy(arrays, "cpu")
    assert np.array_equal(carried.chunk_lo.numpy(), arrays["chunk_lo"])
    assert np.array_equal(carried.chunk_hi.numpy(), arrays["chunk_hi"])
    assert carried.cull_chunk == ji._cull_granule(arrays["v0"].shape[0]) == 128
    rt = _stress(3)[0]
    assert rt.chunk_lo.shape == arrays["chunk_lo"].shape == (18, 3)
    np.testing.assert_allclose(rt.chunk_lo.numpy(), arrays["chunk_lo"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rt.chunk_hi.numpy(), arrays["chunk_hi"],
                               rtol=1e-6, atol=1e-7)
    assert np.array_equal(rt.tri_valid.numpy(), arrays["tri_valid"])


@pytest.mark.parametrize("cull_chunks", [True, False])
def test_intersect_tri_raw_matches_jax(cull_chunks):
    """The plain chunked sweep against the JAX package's, with and without
    the per-chunk box skip, at a chunk of 64 on 2,304 triangles."""
    rt, (o, d), _ = _stress(3)
    hit, idx, t = ti._intersect_tri_raw(o, d, rt.v0, rt.v1, rt.v2, rt.tri_valid,
                                        chunk=64, cull_chunks=cull_chunks)
    j = [jnp.asarray(x.numpy()) for x in (o, d, rt.v0, rt.v1, rt.v2, rt.tri_valid)]
    w_hit, w_idx, w_t = (np.asarray(x) for x in ji._intersect_tri_raw(
        *j, 64, cull_chunks=cull_chunks))
    same = idx.numpy() == w_idx
    # the tessellation's edges lie on a regular grid, and so do the pixel
    # centres: 1-2% of the camera rays meet an edge shared by two triangles
    assert same.mean() >= 0.97
    assert mt_knife_edge_rays(rt.tri_table.numpy(), o.numpy(), d.numpy(),
                              idx.numpy(), w_idx)[~same].all()
    assert np.array_equal(hit.numpy()[same], w_hit[same])
    np.testing.assert_allclose(t.numpy()[same], w_t[same], rtol=RTOL, atol=1e-6)
    # and the port's own kernel #2 (plain), bit for bit
    ref = tk.trace_nearest_vpu_plain(rt.tri_table, rt.n_tri, o, d)
    assert torch.equal(idx, ref[1]) and torch.equal(t, ref[2])
    t4, i4, u4, v4 = ti.intersect_triangles(o, d, rt.v0, rt.v1, rt.v2, rt.tri_valid,
                                            chunk=64, cull_chunks=cull_chunks)
    assert torch.equal(i4, idx) and ((u4 >= 0) & (v4 >= 0))[hit].all()


def test_culled_tiers_and_bvh_match_the_unculled_sweep_at_100k():
    """At 147,456 triangles (the Cornell box tessellated six times, made
    from the meshes in the repository): the culled plain tiers, the plain
    chunked sweep with its box skip, and the per-ray BVH traversal all
    return the unculled sweep's winners on 256 camera rays."""
    rt, (o, d), _ = _stress(6, w=16)
    assert rt.n_tri == 147456 >= 100_000 and bool(rt.tri_valid.all())
    assert ti._trace_backend(rt.v0.shape[0]) == "mm2s" and rt.cull_chunk == 256
    assert rt.chunk_lo.shape == (576, 3)
    a = (rt.tri_table, rt.chunk_lo, rt.chunk_hi, o, d)
    brute = tt.trace_nearest_mm2(*a, chunk=256, cull=False)       # every chunk
    assert 0.5 < brute[0].float().mean() < 1.0
    skip = _excused(rt, o, d, brute[1])
    mask = tt.cull_prepass(rt.chunk_lo, rt.chunk_hi, o, d)
    assert mask.float().mean() < 0.6                              # the cull is real
    for got in (tt.trace_nearest_mm2_stream(*a, chunk=256),
                tt.trace_nearest_mm2(*a, chunk=256),
                tt.trace_nearest_mm2c(*a, chunk=256),
                ti._trace_tris(rt, o, d),
                ti._intersect_tri_raw(o, d, rt.v0, rt.v1, rt.v2, rt.tri_valid,
                                      chunk=512, cull_chunks=True)):
        for x, y in zip(got, brute):
            assert bool(((x == y) | skip).all())
    # the per-ray traversal over a tree of the same triangles
    v = [x.numpy() for x in (rt.v0, rt.v1, rt.v2)]
    lo, hi = tbvh.primitive_bounds(*v)
    tree = tbvh.build_bvh(lo, hi, tbvh.triangle_areas(*v)).to("cpu")
    t, p = tbvh.bvh_nearest_hit(tree, rt.v0, rt.v1, rt.v2, o, d)
    # the traversal meets the triangles in tree order and sums its dot
    # products in another order than the sweep: a ray through an edge
    # shared by two triangles (the tessellation's grid under the pixel
    # grid) may take the other one. Every such ray is proven a tie or a
    # knife edge; the rest is equal
    same = (p == brute[1]).numpy()
    assert same.mean() >= 0.95, int((~same).sum())
    assert mt_knife_edge_rays(rt.tri_table.numpy(), o.numpy(), d.numpy(), p.numpy(),
                              brute[1].numpy())[~same].all()
    assert np.array_equal((p >= 0).numpy()[same], brute[0].numpy()[same])
    np.testing.assert_allclose(t.numpy()[same], brute[2].numpy()[same], rtol=1e-5)
