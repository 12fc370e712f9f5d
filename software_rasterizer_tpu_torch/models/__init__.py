"""Scene data model: materials, lights, geometry objects, Scene assembly
(host NumPy; the integrators in ops/ consume the flattened arrays)."""

from software_rasterizer_tpu_torch.models.material import Material, MaterialType  # noqa: F401
from software_rasterizer_tpu_torch.models.lights import AreaLight, PointLight  # noqa: F401
from software_rasterizer_tpu_torch.models.objects import (  # noqa: F401
    CubeObject,
    MeshObject,
    SphereLight,
    SphereObject,
)
from software_rasterizer_tpu_torch.models.scene import Scene  # noqa: F401
