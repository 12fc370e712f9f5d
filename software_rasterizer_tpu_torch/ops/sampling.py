"""Monte-Carlo sampling primitives (reference: Material.cpp:14-47,
Scene.cpp:398-476, Triangle.cpp:187-213, Sphere.cpp:156-183).

Every sampler draws from an explicit `torch.Generator` (on the device
of the tensors it fills). The draws are not the JAX package's
`jax.random` numbers: these functions match theirs in distribution, not
bit for bit. The deterministic parts (`hemisphere_pdf`, `fr_diffuse`,
`triangle_area`, `emissive_prim_areas`) match value for value.
"""

from __future__ import annotations

import math

import torch

from software_rasterizer_tpu_torch.ops import optics

PI = math.pi
INV_PI = 1.0 / math.pi
UNIFORM_HEMI_PDF = 0.5 / math.pi  # Material.hpp uniform_sampling_on_sphere
EPSILON_AREA = 1e-5  # Material::hasEmission threshold (Material.cpp:65-68)


def _rand(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32)


def sample_uniform_hemisphere(gen: torch.Generator, n: torch.Tensor) -> torch.Tensor:
    """Material::sample for DIFFUSE_AND_GLOSSY (Material.cpp:14-34):
    z = |1-2*x1|, r = sqrt(1-z^2), phi = 2*pi*x2, mapped by toWorld(N).
    n: (...,3) normals; returns wi (...,3)."""
    shape = n.shape[:-1]
    x1 = _rand(gen, shape)
    x2 = _rand(gen, shape)
    z = (1.0 - 2.0 * x1).abs()
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * x2
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return optics.to_world(local, n)


def hemisphere_pdf(wi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Material::pdf (Material.cpp:41-47): 1/2pi if wi.N > 0 else 0."""
    return torch.where((wi * n).sum(dim=-1) > 0, UNIFORM_HEMI_PDF, 0.0)


def fr_diffuse(kd: torch.Tensor, wi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Material::fr_contribution (Material.cpp:53-63): Kd/pi if wi.N>0."""
    return torch.where(((wi * n).sum(dim=-1) > 0)[..., None], kd * INV_PI, 0.0)


def sample_unit_sphere(gen: torch.Generator, shape) -> torch.Tensor:
    """glm::sphericalRand(1.0): uniform direction on the unit sphere."""
    v = torch.randn(tuple(shape) + (3,), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def pick_emissive_object(scene, gen: torch.Generator, n: int):
    """Uniformly pick one emissive object per lane (Scene.cpp:416-418).
    Returns (center (N,3), radius (N,), any_emitter bool)."""
    n_e = scene.n_emitters
    u = _rand(gen, (n,))
    k = torch.clamp(torch.floor(u * float(max(n_e, 1))).long(),
                    max=max(n_e - 1, 0))
    cr = scene.emitter_cr[k]
    return cr[:, 0:3], cr[:, 3], n_e > 0


def sample_light_dir(scene, gen: torch.Generator, p: torch.Tensor):
    """Scene::sampleLight (Scene.cpp:429-476): bounding-sphere direction
    sampling with the hemisphere flip + 1e-6 perturbation.

    p: (N,3) shading points. Returns (light_dir (N,3), pdf (N,)).
    pdf = cos(theta)/(2 pi) with theta against the baseline direction."""
    n = p.shape[0]
    center, radius, any_e = pick_emissive_object(scene, gen, n)
    baseline = optics.normalize(center - p)
    s = sample_unit_sphere(gen, (n,))
    s = torch.where((s * baseline).sum(dim=-1, keepdim=True) < 0, -s, s)
    pert = sample_unit_sphere(gen, (n,)) * 1e-6
    s = optics.normalize(s + pert)
    sample_pos = center + s * radius[:, None]
    light_dir = optics.normalize(sample_pos - p)
    cos_t = (light_dir * baseline).sum(dim=-1)
    pdf = UNIFORM_HEMI_PDF * cos_t
    if not any_e:
        pdf = torch.zeros_like(pdf)
    return light_dir, pdf


def triangle_area(v0, v1, v2) -> torch.Tensor:
    """0.5*|e1 x e2| (Triangle::calcArea, Triangle.cpp:259-266)."""
    return 0.5 * torch.linalg.vector_norm(
        torch.linalg.cross(v1 - v0, v2 - v0, dim=-1), dim=-1)


def sample_triangle(gen: torch.Generator, v0, v1, v2, n0, n1, n2):
    """Triangle::sample (Triangle.cpp:187-213): uniform area sampling via
    the sqrt-u warp u=sqrt(x1), b=(1-u, u(1-x2), u*x2); the normal is the
    barycentric-interpolated vertex normal, normalized. Batched over the
    leading dims of v0..n2 ((...,3) each).

    Returns (coords (...,3), normal (...,3), pdf (...,) = 1/area)."""
    shape = v0.shape[:-1]
    u = torch.sqrt(_rand(gen, shape))
    v = _rand(gen, shape)
    b1 = (1.0 - u)[..., None]
    b2 = (u * (1.0 - v))[..., None]
    b3 = (u * v)[..., None]
    coords = b1 * v0 + b2 * v1 + b3 * v2
    normal = optics.normalize(b1 * n0 + b2 * n1 + b3 * n2)
    pdf = 1.0 / torch.clamp(triangle_area(v0, v1, v2), min=1e-30)
    return coords, normal, pdf


def sample_sphere_surface(gen: torch.Generator, center, radius):
    """Sphere::sample (Sphere.cpp:156-183): the reference's (theta, phi)
    parameterization, theta = 2*pi*x1 (azimuth), phi = pi*x2 (polar),
    dir = (cos phi, sin phi cos theta, sin phi sin theta). Faithfully
    NON-uniform over the surface (density ~ 1/sin(phi), the reference's
    quirk) while the reported pdf is the uniform 1/(4 pi r^2).

    center (...,3), radius (...,). Returns (coords, normal, pdf)."""
    shape = radius.shape
    theta = 2.0 * PI * _rand(gen, shape)
    phi = PI * _rand(gen, shape)
    d = torch.stack([torch.cos(phi), torch.sin(phi) * torch.cos(theta),
                     torch.sin(phi) * torch.sin(theta)], dim=-1)
    coords = center + radius[..., None] * d
    pdf = 1.0 / torch.clamp(4.0 * PI * radius * radius, min=1e-30)
    return coords, d, pdf


def emissive_prim_areas(scene):
    """Per-primitive surface areas masked to emissive primitives
    (triangles then spheres, as prim_attr is packed), and each
    primitive's object id. Areas are taken in the traced (post-MVP)
    space, like the reference's calcArea on updatePosition'd vertices."""
    tri_emis = (torch.linalg.vector_norm(scene.mat_emit[scene.tri_mat.long()],
                                         dim=-1) > EPSILON_AREA) & scene.tri_valid
    sph_emis = (torch.linalg.vector_norm(scene.mat_emit[scene.sph_mat.long()],
                                         dim=-1) > EPSILON_AREA) & scene.sph_valid
    tri_area = triangle_area(scene.v0, scene.v1, scene.v2)
    sph_area = 4.0 * PI * scene.sph_r * scene.sph_r
    return (torch.cat([torch.where(tri_emis, tri_area, 0.0),
                       torch.where(sph_emis, sph_area, 0.0)]),
            torch.cat([scene.tri_obj, scene.sph_obj]))


def sample_light_area(scene, gen: torch.Generator, n: int):
    """Scene::sampleLight (Scene.cpp:620-669): area-weighted emissive
    sampling. The reference picks an emissive OBJECT by cumulative area
    and then a primitive of it by the mesh BVH's cumulative-area descent;
    the composition selects each emissive primitive with probability
    area / total area, which a prefix sum and a sorted search over the
    flat primitive table give directly.

    pdf is FAITHFUL to the reference: 1/area(chosen OBJECT), the
    author-acknowledged un-normalized scheme (Scene.hpp:113 "(wrong)").

    Returns (coords (N,3), normal (N,3), emit (N,3), pdf (N,))."""
    areas, prim_obj = emissive_prim_areas(scene)
    n_obj = scene.emitter_mask.shape[0]
    obj_area = torch.zeros(n_obj, dtype=areas.dtype, device=areas.device)
    obj_area.index_add_(0, prim_obj.long(), areas)
    cum = torch.cumsum(areas, dim=0)
    total = cum[-1]

    tgt = _rand(gen, (n,)) * total
    prim = torch.clamp(torch.searchsorted(cum, tgt, right=True),
                       max=areas.shape[0] - 1)

    f = scene.v0.shape[0]
    is_sph = prim >= f
    tidx = torch.clamp(prim, max=max(f - 1, 0))
    sidx = torch.clamp(prim - f, 0, max(scene.sph_c.shape[0] - 1, 0))

    tc, tn, _ = sample_triangle(
        gen, scene.v0[tidx], scene.v1[tidx], scene.v2[tidx],
        scene.n0[tidx], scene.n1[tidx], scene.n2[tidx])
    sc, sn, _ = sample_sphere_surface(gen, scene.sph_c[sidx], scene.sph_r[sidx])

    coords = torch.where(is_sph[:, None], sc, tc)
    normal = torch.where(is_sph[:, None], sn, tn)
    mat = torch.where(is_sph, scene.sph_mat[sidx], scene.tri_mat[tidx]).long()
    emit = scene.mat_emit[mat]
    obj = prim_obj[prim].long()
    pdf = 1.0 / torch.clamp(obj_area[obj], min=1e-30)
    pdf = torch.where(total > 0, pdf, 0.0)
    return coords, normal, emit, pdf
