"""SoftRasterizer's Cornell box as its README walkthrough builds it: 36
triangles in eight meshes and the ceiling light, camera at (0, 0, -0.9),
black background, every part scaled by 0.25 (README.md:478-556)."""

from software_rasterizer_tpu_torch.scenes.cornell import build_cornell_scene


def build():
    return build_cornell_scene()
