"""The Cornell box with every mesh midpoint-subdivided `levels` times
(1:4 a level): 36 x 4^levels triangles on the surfaces of the box, the
default framing, the light kept. A scene of real size from the meshes the
repository holds."""

from software_rasterizer_tpu_torch.scenes.cornell import build_cornell_scene
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh


def build(levels: int):
    scene = build_cornell_scene()
    for _, obj in scene.meshes():
        obj.data = subdivide_mesh(obj.data, levels)
    return scene
