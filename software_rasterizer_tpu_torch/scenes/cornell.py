"""Cornell Box benchmark scene (reference: README.md:478-560 walkthrough,
assets examples/models/cornellbox/cornellbox_parts/*.obj).

The geometry is embedded as OBJ source (8 meshes, 36 triangles — wall
quads at +-1, the emitter quad at y=0.9964, and the two rotated boxes)
so the benchmark and tests run without the reference checkout mounted.
Materials and transforms follow the README setup: every part scaled by
0.25, camera at (0,0,-0.9) looking at the origin, and the reference's
BGR-channel material quirk (red stores Kd=(0,0,1), green Kd=(0,1,0)
because the framebuffer is OpenCV BGR).
"""

from __future__ import annotations

from software_rasterizer_tpu_torch.models.material import Material, MaterialType
from software_rasterizer_tpu_torch.models.objects import MeshObject
from software_rasterizer_tpu_torch.models.scene import Scene
from software_rasterizer_tpu_torch.utils.obj_loader import load_obj_source

_FLOOR = """o floor
v 1.000000 -1.000000 -1.000000
v 0.999999 -1.000000 1.000001
v -1.000000 -1.000000 1.000000
v -1.000000 -1.000000 -1.000000
vn 0.000000 1.000000 -0.000000
f 1//1 3//1 2//1
f 1//1 4//1 3//1
"""

_BACK = """o back
v 1.000000 -1.000000 1.000000
v -1.000000 -1.000000 1.000000
v 1.000000 1.000000 1.000000
v -1.000000 1.000000 1.000000
vn 0.000000 0.000000 -1.000000
f 1//1 4//1 3//1
f 1//1 2//1 4//1
"""

_TOP = """o top
v 1.000000 1.000000 -1.000000
v 1.000000 1.000000 1.000000
v -1.000000 1.000000 1.000000
v -1.000000 1.000000 -1.000000
vn -0.000000 -1.000000 0.000000
f 1//1 2//1 3//1
f 1//1 3//1 4//1
"""

_LEFT = """o cbox_red
v -1.000000 -1.000000 -1.000000
v -1.000000 -1.000000 1.000000
v -1.000000 1.000000 -1.000000
v -1.000000 1.000000 1.000000
vn 1.000000 0.000000 0.000000
f 3//1 2//1 1//1
f 3//1 4//1 2//1
"""

_RIGHT = """o cbox_green
v 1.000000 -1.000000 -1.000000
v 1.000000 -1.000000 1.000000
v 1.000000 1.000000 1.000000
v 1.000000 1.000000 -1.000000
vn -1.000000 0.000000 0.000000
f 3//1 1//1 2//1
f 3//1 4//1 1//1
"""

_LIGHT = """o Light
v 0.233813 0.996355 -0.188126
v 0.233813 0.996355 0.187411
v -0.233813 0.996355 0.187411
v -0.233813 0.996355 -0.188126
vn -0.000000 -1.000000 0.000000
f 1//1 2//1 3//1
f 1//1 3//1 4//1
"""

_SMALL = """o small_box
v 0.815001 -0.982489 -0.487212
v 0.794894 -0.381617 -0.498350
v 0.605235 -0.377544 0.063750
v 0.625342 -0.978417 0.074888
v 0.256523 -1.004704 -0.677447
v 0.236416 -0.403832 -0.688585
v 0.046756 -0.399760 -0.126486
v 0.066864 -1.000632 -0.115348
vn 0.3213 -0.0068 -0.9470
vn -0.0334 0.9993 -0.0185
vn -0.3213 0.0068 0.9470
vn 0.0334 -0.9993 0.0185
vn 0.9464 0.0376 0.3207
vn -0.9465 -0.0376 -0.3206
vn 0.3212 -0.0068 -0.9470
vn -0.3212 0.0068 0.9470
vn -0.9464 -0.0376 -0.3207
f 6//1 1//1 5//1
f 7//2 2//2 6//2
f 8//3 3//3 7//3
f 5//4 4//4 8//4
f 2//5 4//5 1//5
f 7//6 5//6 8//6
f 6//7 2//7 1//7
f 7//2 3//2 2//2
f 8//8 4//8 3//8
f 5//4 1//4 4//4
f 2//5 3//5 4//5
f 7//9 6//9 5//9
"""

_LARGE = """o large_box
v 0.146809 -1.000000 0.510920
v 0.146809 0.202624 0.510920
v -0.404440 0.202624 0.722414
v -0.404439 -1.000000 0.722414
v -0.063888 -1.000000 -0.043630
v -0.063888 0.202624 -0.043630
v -0.615137 0.202624 0.167864
v -0.615137 -1.000000 0.167864
vn 0.9343 -0.0000 -0.3566
vn -0.0000 1.0000 -0.0000
vn -0.9343 -0.0000 0.3566
vn -0.0000 -1.0000 -0.0000
vn 0.3568 -0.0000 0.9342
vn -0.3568 -0.0000 -0.9342
f 6//1 1//1 5//1
f 7//2 2//2 6//2
f 8//3 3//3 7//3
f 5//4 4//4 8//4
f 2//5 4//5 1//5
f 7//6 5//6 8//6
f 6//1 2//1 1//1
f 7//2 3//2 2//2
f 8//3 4//3 3//3
f 5//4 1//4 4//4
f 2//5 3//5 4//5
f 7//6 6//6 5//6
"""

_PARTS = {
    "floor": _FLOOR,
    "back": _BACK,
    "top": _TOP,
    "left": _LEFT,
    "right": _RIGHT,
    "light": _LIGHT,
    "shortbox": _SMALL,
    "tallbox": _LARGE,
}


def build_cornell_scene(scale: float = 0.25, degree: float = 0.0) -> Scene:
    """The README path-tracing scene: Cornell box, camera (0,0,-0.9),
    black background, all parts uniformly scaled (README.md:478-556)."""
    scene = Scene(
        "CornellBox",
        eye=(0.0, 0.0, -0.9),
        center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        background=(0.0, 0.0, 0.0),
    )
    # The reference authors colors in OpenCV BGR (red->Kd=(0,0,1),
    # emission=(31.08,38.57,47.88) = warm-red in BGR). This framework is
    # RGB end-to-end (utils/texture.py), so the literals are reversed
    # here; the rendered image matches the reference goldens channel-for-
    # channel after its BGR display conversion.
    red = Material(type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(1.0, 0.0, 0.0))
    green = Material(type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(0.0, 1.0, 0.0))
    light = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY,
        Kd=(1.0, 1.0, 1.0),
        emission=(47.8848, 38.5664, 31.0808),
    )
    mats = {"left": red, "right": green, "light": light}
    white_parts = ("floor", "back", "top", "shortbox", "tallbox")

    for name, src in _PARTS.items():
        # Each white part gets its own Material instance, mirroring the
        # reference's per-mesh shared_ptr<Material> copies.
        mat = mats.get(name) or Material(
            type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(0.68, 0.71, 0.725)
        )
        assert name in mats or name in white_parts
        obj = MeshObject(load_obj_source(src, name=name), material=mat)
        scene.add_graphic_obj(obj, name)
        scene.set_model_matrix(
            name, (0.0, 1.0, 0.0), degree, (0.0, 0.0, 0.0), (scale,) * 3
        )
    return scene
