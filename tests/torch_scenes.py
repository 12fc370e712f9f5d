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
