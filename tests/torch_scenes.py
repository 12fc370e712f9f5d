"""Scenes the port's parity tests build with either package's models."""


def spheres(models, scene_cls):
    """The emissive-sphere scene of tests/test_path.py plus a diffuse
    sphere, so sphere tables hold an emissive and a diffuse row."""
    sc = scene_cls("spherelight", eye=(0.0, 0.0, -0.9))
    lm = models.Material(type=models.MaterialType.DIFFUSE_AND_GLOSSY,
                         Kd=(1.0, 0.3, 0.2), emission=(30.0, 30.0, 30.0))
    sc.add_graphic_obj(
        models.SphereLight((0.0, 0.0, 50.0), (1.0,) * 3, 20.0, lm), "light")
    sc.add_graphic_obj(models.SphereObject(
        (0.1, -0.1, 0.3), 0.2, models.Material(Kd=(0.5, 0.5, 0.5))), "ball")
    return sc


def mirror_glass_cornell(models, build_cornell):
    """Cornell with the mirror sphere and the glass sphere of
    tests/test_uber.py: both specular branches of the Whitted kernel."""
    scene = build_cornell()
    mirror = models.Material(type=models.MaterialType.REFLECTION, ior=1.85)
    glass = models.Material(type=models.MaterialType.REFLECTION_AND_REFRACTION,
                            ior=1.49)
    scene.add_graphic_obj(
        models.SphereObject((-0.08, -0.08, 0.1), 0.09, mirror), "msphere")
    scene.add_graphic_obj(
        models.SphereObject((0.1, -0.1, 0.05), 0.08, glass), "gsphere")
    return scene


def textured_cornell(build_cornell, shader_type, texture_cls,
                     target_mesh="back"):
    """Cornell with the 2x2 in-memory texture of tests/test_path.py bound
    to `target_mesh`."""
    import numpy as np

    scene = build_cornell()
    tex = texture_cls(np.asarray(
        [[[255, 0, 0], [0, 255, 0]], [[0, 0, 255], [255, 255, 0]]], np.uint8))
    scene.add_shader("t", tex, shader_type.TEXTURE)
    scene.bind_shader_to_mesh(target_mesh, "t")
    return scene


def textured_light_cornell(build_cornell, shader_type, texture_cls):
    """Cornell with the 2x2 texture bound to the LIGHT mesh (the
    construction of tests/test_path.py): an emissive triangle carries a
    texture, so its own pixels show the texel, not Kd."""
    return textured_cornell(build_cornell, shader_type, texture_cls, "light")


def two_emitter_cornell(models, build_cornell):
    """Cornell with a second emitter (a small sphere light) and the mirror
    and glass spheres of `mirror_glass_cornell`, so that child rays pick
    an emitter too."""
    scene = mirror_glass_cornell(models, build_cornell)
    scene.add_graphic_obj(models.SphereLight(
        (-0.12, 0.12, 0.1), (1.0,) * 3, 0.04,
        models.Material(Kd=(1.0, 1.0, 1.0), emission=(6.0, 5.0, 4.0))),
        "bulb")
    return scene


def stress_cornell(build_cornell, subdivide, levels):
    """The Cornell box with every mesh tessellated by `subdivide(data,
    levels)`: 36 x 4^levels triangles on the surfaces of the box (levels=4:
    9,216; levels=6: 147,456), the default framing, the light kept. A
    large scene made from the meshes the repository holds."""
    scene = build_cornell()
    for _, obj in scene.meshes():
        obj.data = subdivide(obj.data, levels)
    return scene


def edge_tie_pixels(arrays, dirs, rel=1e-6):
    """(N,) bool: the camera rays (from arrays["eye"] along `dirs` (N,3))
    that meet the shared edge of two triangles, found in float64: two
    triangles are hit (barycentrics within `rel` of their range) at the
    same t within `rel`. Which of the two wins is decided by the last bit
    of float32 rounding, so two programs that round differently may shade
    such a pixel from different walls."""
    import numpy as np

    n_tri = int(arrays["n_tri"])
    g = np.asarray(arrays["tri_table"], np.float64)[:n_tri]
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    o = np.asarray(arrays["eye"], np.float64)
    d = np.asarray(dirs, np.float64)[:, None, :]            # (N,1,3)
    p = np.cross(d, e2[None])                               # (N,F,3)
    det = (e1[None] * p).sum(-1)
    ok_det = np.abs(det) >= 1e-6
    det = np.where(ok_det, det, 1.0)
    tv = (o - v0)[None]                                     # (1,F,3)
    q = np.cross(tv, e1[None])
    u = (tv * p).sum(-1) / det
    v = (d * q).sum(-1) / det
    t = (e2[None] * q).sum(-1) / det
    hit = (ok_det & (u >= -rel) & (v >= -rel) & (u + v <= 1 + rel)
           & (t > 1e-6))
    t = np.where(hit, t, np.inf)
    t_min = t.min(axis=1, keepdims=True)
    t_min = np.where(np.isfinite(t_min), t_min, 0.0)   # rows with no hit
    near = hit & (np.abs(t - t_min) <= rel * np.abs(t_min))
    return near.sum(axis=1) >= 2


def mt_knife_edge_rays(tri_table, orig, dirs, idx_a, idx_b, tol=1e-5):
    """(N,) bool: where two nearest-triangle searches over the same
    (F,12) `[v0|e1|e2|pad]` table picked different winners `idx_a` /
    `idx_b` (-1: a miss) and float64 shows why: both winners are hit at t
    within `tol` relative (a tie), or one of them sits within `tol` of an
    acceptance threshold of the Moller-Trumbore test (u, v or u + v at 0
    or 1, |det| at 1e-6, or t within 5e-7 of 1e-6: a ray that starts on a
    surface meets it again at a t that is the rounding noise of
    differences of numbers near 1), so the last bit of float32 rounding
    decides whether it is hit at all. A differing ray that is False here
    is a real disagreement."""
    import numpy as np

    g = np.asarray(tri_table, np.float64)
    o = np.asarray(orig, np.float64)
    d = np.asarray(dirs, np.float64)
    ia, ib = np.asarray(idx_a), np.asarray(idx_b)

    def evaluate(idx):
        r = g[np.maximum(idx, 0)]
        v0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
        p = np.cross(d, e2)
        det = (e1 * p).sum(-1)
        inv = 1.0 / np.where(np.abs(det) < 1e-12, 1.0, det)
        tv = o - v0
        u = (tv * p).sum(-1) * inv
        q = np.cross(tv, e1)
        v = (d * q).sum(-1) * inv
        t = (e2 * q).sum(-1) * inv
        near = ((np.abs(u) <= tol) | (np.abs(u - 1) <= tol) | (np.abs(v) <= tol)
                | (np.abs(u + v - 1) <= tol) | (np.abs(t - 1e-6) <= 5e-7)
                | (np.abs(np.abs(det) - 1e-6) <= tol * 1e-6))
        return t, near & (idx >= 0)

    ta, edge_a = evaluate(ia)
    tb, edge_b = evaluate(ib)
    tie = ((ia >= 0) & (ib >= 0)
           & (np.abs(ta - tb) <= tol * np.maximum(np.abs(ta), np.abs(tb))))
    return (ia != ib) & (tie | edge_a | edge_b)


def slab_knife_edge_rays(chunk_lo, chunk_hi, chunk, orig, dirs, idx, tol=1e-5):
    """(N,) bool: the rays whose winning triangle `idx` (-1: a miss) lies
    in a chunk whose box (`chunk_lo/hi` (nc,3), `chunk` rows a chunk) the
    ray meets on a knife edge, found in float64: the exit of one axis'
    slab lies within `tol` (relative to the exit distance, absolute below
    1) of the entry of another axis' slab, or of t = 0. The hit point
    then lies on the box's rim (a triangle edge that is also a face of the
    box), and the last bit of float32 rounding decides whether a chunk
    cull visits the chunk, while an unculled sweep tests the triangle in
    any case. (The two slabs of one axis are left out: a flat box has
    them equal bit for bit, which no rounding flips.)"""
    import numpy as np

    lo = np.asarray(chunk_lo, np.float64)
    hi = np.asarray(chunk_hi, np.float64)
    o = np.asarray(orig, np.float64)
    d = np.asarray(dirs, np.float64)
    idx = np.asarray(idx)
    c = np.maximum(idx, 0) // chunk
    inv = 1.0 / np.where(d == 0.0, 1e-30, d)
    t0, t1 = (lo[c] - o) * inv, (hi[c] - o) * inv
    near = np.concatenate([np.minimum(t0, t1), np.zeros((o.shape[0], 1))], axis=1)
    far = np.maximum(t0, t1)
    gap = np.abs(far[:, :, None] - near[:, None, :])        # (N,3,4)
    gap[:, np.arange(3), np.arange(3)] = np.inf
    scale = np.maximum(np.abs(far.min(axis=1)), 1.0)
    return (idx >= 0) & (gap.min(axis=(1, 2)) <= tol * scale)


RASTER_CORNELL_SCALE = (-0.25, 0.25, 0.25)


def set_raster_cornell_angle(scene, degrees):
    """Turn every mesh of `raster_cornell` about the y axis, keeping its
    mirrored scale."""
    for name, _ in scene.meshes():
        scene.set_model_matrix(name, (0.0, 1.0, 0.0), float(degrees),
                               (0.0, 0.0, 0.0), RASTER_CORNELL_SCALE)


def raster_cornell(models, build_cornell, subdivide, shader_type, texture_cls,
                   levels, variant="three", angle=8.0):
    """The Cornell box as a lit raster scene of real size: every mesh
    tessellated by `subdivide(data, levels)` (levels=4: 36 x 256 = 9,216
    triangles), uvs filled from vertex positions (the inline OBJs carry
    none), two point lights plus the camera light, and a smooth 256x256
    texture made from a NumPy seed.

    variant "three": TEXTURE on the back wall and the floor, NORMAL on the
    short box, PHONG elsewhere (what the shaded tile kernel takes);
    variant "five": also BUMP on the short box, DISPLACEMENT on the tall
    box and NORMAL on the ceiling (deferred shading only).

    The box is mirrored in x and the eye moved in to (0, 0, -0.75): under
    the reference's cull rule (the screen-space face normal dotted with
    the eye) the default framing keeps 9% of the frame, this one most of
    it. It is turned by `angle` degrees about y so that the tessellation's
    edges do not run along pixel rows and columns."""
    import numpy as np

    scene = build_cornell()
    scene.set_view_matrix((0.0, 0.0, -0.75), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    for _, obj in scene.meshes():
        data = subdivide(obj.data, levels)
        v = data.vertices
        span = v.max(0) - v.min(0)
        ax = np.sort(np.argsort(-span)[:2])       # the two widest axes
        uv = (v[:, ax] - v.min(0)[ax]) / np.maximum(span[ax], 1e-6)
        data.uvs = (0.02 + 0.95 * uv).astype(np.float32)
        obj.data = data
    set_raster_cornell_angle(scene, angle)

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    tex = np.zeros((256, 256, 3))
    for c in range(3):
        fx, fy = rng.integers(1, 4, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        tex[..., c] = 0.55 + 0.2 * np.sin(2 * np.pi * fx * xx + ph[0]) \
            + 0.2 * np.cos(2 * np.pi * fy * yy + ph[1])
    tex = texture_cls(np.round(tex * 255.0).astype(np.uint8))

    binds = {"back": shader_type.TEXTURE, "floor": shader_type.TEXTURE,
             "shortbox": shader_type.NORMAL}
    if variant == "five":
        binds.update({"shortbox": shader_type.BUMP,
                      "tallbox": shader_type.DISPLACEMENT,
                      "top": shader_type.NORMAL})
    elif variant != "three":
        raise ValueError(f"unknown variant {variant!r}")
    for mesh, st in binds.items():
        scene.add_shader(f"{mesh}_shader",
                         None if st == shader_type.NORMAL else tex, st)
        scene.bind_shader_to_mesh(mesh, f"{mesh}_shader")
    scene.add_light("Light1", models.PointLight((0.9, 0.9, -0.9), (100.0,) * 3))
    scene.add_light("Light2", models.PointLight((0.0, 0.8, 0.9), (50.0,) * 3))
    scene.camera_light(True)
    return scene


def raster_knife_edge_pixels(geo, idx_a, idx_b, row0=0, tol=1e-5):
    """(H,W) bool: where two rasterizations of the same (F,12) coefficient
    table `geo` picked different winners `idx_a` / `idx_b` (-1: none) and
    float64 shows why: a barycentric of one of the two winners lies within
    `tol` of 0 or 1 at the pixel (coverage decided by the last bit), or
    both cover it at depths within `tol` relative (the z test decided by
    the last bit). A differing pixel that is False here is a real
    disagreement."""
    import numpy as np

    g = np.asarray(geo, np.float64)
    ia, ib = np.asarray(idx_a), np.asarray(idx_b)
    h, w = ia.shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y = y + row0

    def evaluate(idx):
        r = g[np.maximum(idx, 0)]
        alpha = x * r[..., 0] + y * r[..., 1] + r[..., 2]
        beta = x * r[..., 3] + y * r[..., 4] + r[..., 5]
        bary = np.stack([alpha, beta, 1.0 - alpha - beta], -1)
        edge = ((np.abs(bary) <= tol) | (np.abs(bary - 1.0) <= tol)).any(-1)
        z = x * r[..., 6] + y * r[..., 7] + r[..., 8]
        return edge & (idx >= 0), z

    edge_a, za = evaluate(ia)
    edge_b, zb = evaluate(ib)
    z_tie = ((ia >= 0) & (ib >= 0)
             & (np.abs(za - zb) <= tol * np.maximum(np.abs(za), np.abs(zb))))
    return (ia != ib) & (edge_a | edge_b | z_tie)
