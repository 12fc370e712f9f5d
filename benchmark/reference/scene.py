"""Scene inputs to the tables the reference renderers trace against.

`inputs` is the dict `harness.inputs.scene_inputs` makes from a scene:
meshes in name order, each with its object-space vertices, normals, uvs,
colours, faces, model matrix, material, shader and texture, and the
scene's view / projection / screen matrices, eye, background, field of
view, clip planes and lights. Sphere objects are outside this
reference's scope and raise.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

BIG = 1e30
F32_EPS = float(np.finfo(np.float32).eps)


def check_scope(inputs: dict) -> None:
    if inputs["n_spheres"]:
        raise NotImplementedError("the reference renders triangle meshes only")


def hom_transform(mats: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Per-point 4x4 transform with the perspective divide; the 3-term
    dot summed left to right."""
    h = (mats[:, :, 0] * points[:, 0:1] + mats[:, :, 1] * points[:, 1:2]
         + mats[:, :, 2] * points[:, 2:3]) + mats[:, :, 3]
    return h[:, :3] / h[:, 3:4]


def emissive(material: dict) -> bool:
    return float(np.linalg.norm(material["emission"])) > F32_EPS


def trace_space(inputs: dict, dtype=torch.float32, device="cpu") -> SimpleNamespace:
    """The ray tracers' scene: every mesh's vertices through
    projection * view * model with the divide, its normals through the
    inverse transpose of the model's 3x3 (normalized), as (F,12)
    [v0 | e1 | e2 | 0] rows in scene order; per-triangle materials; the
    emitters' bounding spheres (centre and radius of each emissive
    object's box) in object order."""
    check_scope(inputs)
    meshes = inputs["meshes"]

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    proj_view = inputs["projection"] @ inputs["view"]
    mvp = [proj_view @ m["model"] for m in meshes]
    nm3 = [np.linalg.inv(m["model"][:3, :3]).T.astype(np.float32) for m in meshes]
    vmesh = np.concatenate([np.full(m["vertices"].shape[0], i)
                            for i, m in enumerate(meshes)])
    pos = hom_transform(t(np.stack(mvp))[t(vmesh, torch.int64)],
                        t(np.concatenate([m["vertices"] for m in meshes])))
    nm = t(np.stack(nm3))[t(vmesh, torch.int64)]
    nv = t(np.concatenate([m["normals"] for m in meshes]))
    nrm = (nm[:, :, 0] * nv[:, 0:1] + nm[:, :, 1] * nv[:, 1:2]
           + nm[:, :, 2] * nv[:, 2:3])
    nrm = nrm / torch.clamp(torch.sqrt((nrm * nrm).sum(dim=-1, keepdim=True)),
                            min=1e-20)

    offs = np.cumsum([0] + [m["vertices"].shape[0] for m in meshes])
    faces = t(np.concatenate([m["faces"].astype(np.int64) + offs[i]
                              for i, m in enumerate(meshes)]), torch.int64)
    tri_mesh = np.concatenate([np.full(m["faces"].shape[0], i)
                               for i, m in enumerate(meshes)])
    tv, tn = pos[faces], nrm[faces]
    tri = torch.cat([tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0],
                     torch.zeros_like(tv[:, 0])], dim=1)

    def mat(key):
        return t(np.stack([np.asarray(m["material"][key], np.float32)
                           for m in meshes])[tri_mesh])

    emitters = []
    for i, m in enumerate(meshes):
        if emissive(m["material"]):
            sel = tv[torch.as_tensor(tri_mesh == i, device=device)]
            lo = sel.amin(dim=(0, 1))
            hi = sel.amax(dim=(0, 1))
            radius = torch.sqrt(((hi - lo) * (hi - lo)).sum()) * 0.5
            emitters.append(torch.cat([(lo + hi) * 0.5, radius[None]]))
    return SimpleNamespace(
        tri=tri, n0=tn[:, 0], n1=tn[:, 1], n2=tn[:, 2],
        kd=mat("kd"), emit=mat("emission"), ka=mat("ka"), ks=mat("ks"),
        spec=mat("spec"), mtype=t(np.asarray([m["material"]["type"] for m in meshes])
                                  [tri_mesh], torch.int64),
        emitters=(torch.stack(emitters) if emitters
                  else torch.zeros((1, 4), dtype=dtype, device=device)),
        n_emitters=len(emitters),
        textured=any(m["texture"] is not None for m in meshes),
        eye=[float(v) for v in np.asarray(inputs["eye"], np.float32)],
        background=[float(v) for v in np.asarray(inputs["background"], np.float32)],
        dtype=dtype, device=torch.device(device))


def camera_scale(fovy_deg: float) -> float:
    """tan(radians(fovy) / 2), rounded in float32 at every step."""
    half = np.float32(np.float32(fovy_deg) * np.float32(np.pi / 180)) * np.float32(0.5)
    return float(np.tan(half, dtype=np.float32))


def mt_plane(orig, d, rows):
    """(N, C) Moller-Trumbore t (BIG where rejected), u and v of N rays
    against C rows [v0 | e1 | e2 | .], and the stage-1 pass plane
    (|det| >= 1e-6 and u in [0, 1]): the tests whose remaining half a
    brute-force tracer has to compute."""
    ox, oy, oz = orig[:, 0:1], orig[:, 1:2], orig[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (rows[None, :, k] for k in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(det.abs() < 1e-6, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    ok1 = (det.abs() >= 1e-6) & (u >= 0.0) & (u <= 1.0)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ok1 & (v >= 0.0) & (u + v <= 1.0) & (tt >= 1e-6)
    return torch.where(ok, tt, BIG), u, v, ok1


def nearest(tri, orig, d, block: int = 1024, counts: dict = None, need=None):
    """Brute-force nearest triangle of each ray (N,3): every row, in row
    order, a strict `<` so the lowest row wins a tie. Returns (t (N,), BIG
    on a miss; row (N,) int64, -1 on a miss; u; v). `counts` gets, over
    the rays of the (N,) bool `need`, the (ray, row) tests ("tests") and
    those that passed stage 1 ("stage1_passes"), as 0-d tensors."""
    n = orig.shape[0]
    t = torch.full((n,), BIG, dtype=orig.dtype, device=orig.device)
    row = torch.full((n,), -1, dtype=torch.int64, device=orig.device)
    u = torch.zeros((n,), dtype=orig.dtype, device=orig.device)
    v = torch.zeros_like(u)
    never = torch.iinfo(torch.int64).max
    for f0 in range(0, tri.shape[0], block):
        tm, um, vm, ok1 = mt_plane(orig, d, tri[f0:f0 + block])
        ct = tm.amin(dim=1)
        cols = torch.arange(tm.shape[1], device=tm.device)[None]
        col = torch.where(tm == ct[:, None], cols, never).amin(dim=1)
        col = torch.clamp(col, max=tm.shape[1] - 1)
        better = ct < t
        t = torch.where(better, ct, t)
        row = torch.where(better, f0 + col, row)
        u = torch.where(better, um.gather(1, col[:, None])[:, 0], u)
        v = torch.where(better, vm.gather(1, col[:, None])[:, 0], v)
        if counts is not None:
            counts["stage1_passes"] = (counts.get("stage1_passes", 0)
                                       + (ok1 & need[:, None]).sum())
    if counts is not None:
        counts["tests"] = counts.get("tests", 0) + need.sum() * tri.shape[0]
    return t, row, u, v


def norm3(x, y, z, eps=0.0):
    n = torch.sqrt(x * x + y * y + z * z)
    inv = torch.where(n > 0, 1.0 / torch.where(n > 0, n, 1.0), 0.0)
    inv = torch.where(n > eps, inv, 0.0)
    return x * inv, y * inv, z * inv
