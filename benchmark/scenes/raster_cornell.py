"""The Cornell box as a lit raster scene of real size: every mesh
midpoint-subdivided `levels` times (levels 4: 9,216 triangles), uvs
filled from vertex positions (the inline meshes carry none), two point
lights plus the camera light, and a smooth 256x256 texture made from
NumPy seed 11.

Variant "three": TEXTURE on the back wall and the floor, NORMAL on the
short box, PHONG elsewhere; variant "five" also BUMP on the short box,
DISPLACEMENT on the tall box and NORMAL on the ceiling.

The box is mirrored in x and the eye moved in to (0, 0, -0.75): under the
reference's cull rule (the screen-space face normal dotted with the eye)
the default framing keeps 9% of the frame, this one most of it. `turn`
sets its angle about y; it starts at `angle` degrees so that the
tessellation's edges do not run along pixel rows and columns."""

import numpy as np

from software_rasterizer_tpu_torch.models.lights import PointLight
from software_rasterizer_tpu_torch.ops.shading import ShaderType
from software_rasterizer_tpu_torch.scenes.cornell import build_cornell_scene
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from software_rasterizer_tpu_torch.utils.texture import Texture

SCALE = (-0.25, 0.25, 0.25)


def turn(scene, degrees: float) -> None:
    """Turn every mesh about the y axis to `degrees`, keeping the
    mirrored scale."""
    for name, _ in scene.meshes():
        scene.set_model_matrix(name, (0.0, 1.0, 0.0), float(degrees),
                               (0.0, 0.0, 0.0), SCALE)


def build(levels: int, variant: str = "three", angle: float = 8.0):
    scene = build_cornell_scene()
    scene.set_view_matrix((0.0, 0.0, -0.75), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    for _, obj in scene.meshes():
        data = subdivide_mesh(obj.data, levels)
        v = data.vertices
        span = v.max(0) - v.min(0)
        ax = np.sort(np.argsort(-span)[:2])       # the two widest axes
        uv = (v[:, ax] - v.min(0)[ax]) / np.maximum(span[ax], 1e-6)
        data.uvs = (0.02 + 0.95 * uv).astype(np.float32)
        obj.data = data
    turn(scene, angle)

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    tex = np.zeros((256, 256, 3))
    for c in range(3):
        fx, fy = rng.integers(1, 4, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        tex[..., c] = 0.55 + 0.2 * np.sin(2 * np.pi * fx * xx + ph[0]) \
            + 0.2 * np.cos(2 * np.pi * fy * yy + ph[1])
    tex = Texture(np.round(tex * 255.0).astype(np.uint8))

    binds = {"back": ShaderType.TEXTURE, "floor": ShaderType.TEXTURE,
             "shortbox": ShaderType.NORMAL}
    if variant == "five":
        binds.update({"shortbox": ShaderType.BUMP,
                      "tallbox": ShaderType.DISPLACEMENT,
                      "top": ShaderType.NORMAL})
    elif variant != "three":
        raise ValueError(f"unknown variant {variant!r}")
    for mesh, st in binds.items():
        scene.add_shader(f"{mesh}_shader", None if st == ShaderType.NORMAL else tex, st)
        scene.bind_shader_to_mesh(mesh, f"{mesh}_shader")
    scene.add_light("Light1", PointLight((0.9, 0.9, -0.9), (100.0,) * 3))
    scene.add_light("Light2", PointLight((0.0, 0.8, 0.9), (50.0,) * 3))
    scene.camera_light(True)
    return scene
