"""Fragment shaders (reference: include/shader/Shader.hpp, src/Shader.cpp).

Only the shader-type enum is ported so far: `Scene.raster_geometry`
records it per mesh. The shaders themselves come with the raster slice.
"""

from __future__ import annotations

import enum


class ShaderType(enum.IntEnum):
    """SHADERS_TYPE (Shader.hpp:32-38)."""

    NORMAL = 0
    TEXTURE = 1
    PHONG = 2
    DISPLACEMENT = 3
    BUMP = 4
