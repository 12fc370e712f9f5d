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
