"""`ops/sampling` of the port against the JAX package's.

The deterministic parts (`hemisphere_pdf`, `fr_diffuse`, `triangle_area`,
`emissive_prim_areas`) are compared value for value at 1e-6 on the same
numpy inputs. The samplers draw from a `torch.Generator`, not from
`jax.random`, so they are held to the distributions the JAX functions
document, by moments over 40,000 draws: unit norm, the hemisphere side,
pdf = cos / 2pi, first and second moments within 4 standard errors, and
area-weighted primitive frequencies within 4 sigma of the binomial.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.ops import sampling as js
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene as jprepare
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu_torch.ops import sampling as ts
from software_rasterizer_tpu_torch.ops.intersect import rt_scene_from_numpy
from torch_scenes import two_emitter_cornell

N = 40000


def _gen(seed=0):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.fixture(scope="module")
def scenes():
    scene = two_emitter_cornell(jmodels, jcornell)
    scene.set_ndc_matrix(16, 16)
    jrt = jprepare(scene.rt_geometry(), scene.rt_frame())
    arrays = {k: np.asarray(v) for k, v in jrt._asdict().items()}
    return jrt, rt_scene_from_numpy(arrays, "cpu")


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_hemisphere_pdf_and_fr_diffuse_match_jax():
    wi, n = _unit(500, 1), _unit(500, 2)
    kd = np.random.default_rng(3).uniform(0, 1, (500, 3)).astype(np.float32)
    got = ts.hemisphere_pdf(torch.from_numpy(wi), torch.from_numpy(n)).numpy()
    want = np.asarray(js.hemisphere_pdf(jnp.asarray(wi), jnp.asarray(n)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert sorted(set(np.round(got.astype(np.float64), 6))) == [0.0, round(0.5 / math.pi, 6)]
    got = ts.fr_diffuse(*(torch.from_numpy(x) for x in (kd, wi, n))).numpy()
    want = np.asarray(js.fr_diffuse(*(jnp.asarray(x) for x in (kd, wi, n))))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_triangle_area_and_emissive_areas_match_jax(scenes):
    jrt, trt = scenes
    got = ts.triangle_area(trt.v0, trt.v1, trt.v2).numpy()
    want = np.asarray(js.triangle_area(jrt.v0, jrt.v1, jrt.v2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    areas, obj = ts.emissive_prim_areas(trt)
    w_areas, w_obj = js.emissive_prim_areas(jrt)
    np.testing.assert_allclose(areas.numpy(), np.asarray(w_areas), rtol=1e-6,
                               atol=1e-6)
    assert np.array_equal(obj.numpy(), np.asarray(w_obj))
    assert (areas > 0).sum() == 3            # two light triangles and the bulb


def test_uniform_hemisphere_moments():
    n = torch.from_numpy(np.tile(_unit(1, 4), (N, 1)))
    wi = ts.sample_uniform_hemisphere(_gen(), n)
    np.testing.assert_allclose(torch.linalg.vector_norm(wi, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    cos = (wi * n).sum(-1).numpy()
    assert (cos >= -1e-6).all()
    # uniform over the hemisphere: cos is uniform on [0, 1]
    se = math.sqrt(1 / 12 / N)
    assert abs(cos.mean() - 0.5) < 4 * se
    assert abs((cos ** 2).mean() - 1 / 3) < 4 * math.sqrt(4 / 45 / N)
    # the JAX sampler has the same first moment
    jw = np.asarray(js.sample_uniform_hemisphere(jax.random.PRNGKey(0),
                                                 jnp.asarray(n.numpy())))
    assert abs((jw * n.numpy()).sum(-1).mean() - cos.mean()) < 6 * se
    assert (ts.hemisphere_pdf(wi, n) > 0).float().mean() > 0.999


def test_unit_sphere_moments():
    v = ts.sample_unit_sphere(_gen(1), (N,)).numpy()
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    se = math.sqrt(1 / 3 / N)
    assert (np.abs(v.mean(0)) < 4 * se).all()
    assert (np.abs((v ** 2).mean(0) - 1 / 3) < 4 * math.sqrt(4 / 45 / N)).all()


def test_pick_emissive_object_frequencies(scenes):
    _, trt = scenes
    c, r, any_e = ts.pick_emissive_object(trt, _gen(2), N)
    assert any_e and trt.n_emitters == 2
    first = (c == trt.emitter_cr[0, 0:3]).all(dim=1)
    second = (c == trt.emitter_cr[1, 0:3]).all(dim=1)
    assert bool((first | second).all())
    assert abs(first.float().mean() - 0.5) < 4 * math.sqrt(0.25 / N)
    assert torch.equal(r[first], trt.emitter_cr[0, 3].expand(int(first.sum())))


def test_sample_light_dir_moments(scenes):
    jrt, trt = scenes
    p = np.tile(np.array([[0.05, -0.1, 0.5]], np.float32), (N, 1))
    l, pdf = ts.sample_light_dir(trt, _gen(3), torch.from_numpy(p))
    np.testing.assert_allclose(torch.linalg.vector_norm(l, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert (pdf >= -1e-6).all() and bool(torch.isfinite(pdf).all())
    # pdf = cos(theta) / 2pi against the direction to the picked centre
    base = [(trt.emitter_cr[k, 0:3] - torch.from_numpy(p[0])) for k in range(2)]
    cos = torch.stack([(l * (b / b.norm())).sum(-1) for b in base], dim=1)
    want = cos / (2 * math.pi)
    assert bool(((pdf[:, None] - want).abs() < 1e-5).any(dim=1).all())
    jl, jpdf = js.sample_light_dir(jrt, jax.random.PRNGKey(1), jnp.asarray(p))
    jl, jpdf = np.asarray(jl), np.asarray(jpdf)
    # the same distribution: means of the direction and of the pdf
    se = l.numpy().std(0) / math.sqrt(N) + jl.std(0) / math.sqrt(N)
    assert (np.abs(l.numpy().mean(0) - jl.mean(0)) < 4 * se).all()
    se_p = (pdf.numpy().std() + jpdf.std()) / math.sqrt(N)
    assert abs(pdf.numpy().mean() - jpdf.mean()) < 4 * se_p


def test_sample_triangle_is_uniform_in_area():
    v = np.array([[0, 0, 0], [2, 0, 0], [0, 1, 0]], np.float32)
    vs = [torch.from_numpy(np.tile(v[k], (N, 1))) for k in range(3)]
    nrm = torch.from_numpy(np.tile(np.array([[0, 0, 1]], np.float32), (N, 1)))
    c, n, pdf = ts.sample_triangle(_gen(4), *vs, nrm, nrm, nrm)
    c = c.numpy()
    assert (c[:, 0] >= 0).all() and (c[:, 1] >= 0).all()
    assert (c[:, 0] / 2 + c[:, 1] <= 1 + 1e-6).all() and (c[:, 2] == 0).all()
    # the centroid of a uniform density is the mean of the vertices
    se = c.std(0) / math.sqrt(N)
    assert (np.abs(c.mean(0) - v.mean(0))[:2] < 4 * se[:2]).all()
    np.testing.assert_allclose(pdf.numpy(), 1.0, rtol=1e-6)      # area 1
    np.testing.assert_allclose(n.numpy(), nrm.numpy(), atol=1e-6)


def test_sample_sphere_surface_parameterization():
    centre = torch.tensor([[1.0, 2.0, 3.0]]).expand(N, 3)
    radius = torch.full((N,), 0.5)
    c, d, pdf = ts.sample_sphere_surface(_gen(5), centre, radius)
    np.testing.assert_allclose(torch.linalg.vector_norm(c - centre, dim=-1).numpy(),
                               0.5, atol=1e-5)
    np.testing.assert_allclose(pdf.numpy(), 1 / (4 * math.pi * 0.25), rtol=1e-6)
    # the reference's quirk: the polar angle is uniform, so E[cos phi] = 0
    # and E[cos^2 phi] = 1/2 (a uniform surface density would give 1/3)
    x = d[:, 0].numpy()
    assert abs(x.mean()) < 4 * math.sqrt(0.5 / N)
    assert abs((x ** 2).mean() - 0.5) < 4 * math.sqrt(0.125 / N)


def test_sample_light_area_frequencies(scenes):
    jrt, trt = scenes
    coords, normal, emit, pdf = ts.sample_light_area(trt, _gen(6), N)
    areas, prim_obj = ts.emissive_prim_areas(trt)
    areas = areas.numpy()
    total = areas.sum()
    f = trt.v0.shape[0]
    # which primitive was drawn: the sphere by its distance to the bulb's
    # centre, the two light triangles by the side of their shared diagonal
    bulb = int(np.flatnonzero(areas[f:] > 0)[0])
    on_bulb = ((coords - trt.sph_c[bulb]).norm(dim=1)
               - trt.sph_r[bulb]).abs() < 1e-4
    share = float(on_bulb.float().mean())
    p_bulb = areas[f + bulb] / total
    assert abs(share - p_bulb) < 4 * math.sqrt(p_bulb * (1 - p_bulb) / N)
    # emission and the reference's pdf = 1 / area of the chosen OBJECT
    bulb_emit = trt.mat_emit[trt.sph_mat[bulb].long()]
    assert torch.equal(emit[on_bulb], bulb_emit.expand(int(on_bulb.sum()), 3))
    np.testing.assert_allclose(pdf[on_bulb].numpy(), 1 / areas[f + bulb], rtol=1e-5)
    tri_area = areas[:f].sum()
    np.testing.assert_allclose(pdf[~on_bulb].numpy(), 1 / tri_area, rtol=1e-5)
    np.testing.assert_allclose(normal.norm(dim=1).numpy(), 1.0, atol=1e-5)
    # the JAX sampler draws the bulb as often
    jc = np.asarray(js.sample_light_area(jrt, jax.random.PRNGKey(2), N)[0])
    j_share = (np.abs(np.linalg.norm(jc - trt.sph_c[bulb].numpy(), axis=1)
                      - float(trt.sph_r[bulb])) < 1e-4).mean()
    assert abs(j_share - share) < 6 * math.sqrt(p_bulb * (1 - p_bulb) / N)
