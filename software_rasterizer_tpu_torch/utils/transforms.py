"""Camera and model matrices (host-side, NumPy, float32).

Reproduces the reference's glm-based pipeline (conventions + quirks):

  * view = glm::lookAtLH                      (reference Scene.cpp:270)
  * projection = glm::perspectiveLH_NO        (Scene.cpp:293) — NOTE the
    reference passes fovy in DEGREES to a function expecting RADIANS; we
    reproduce that faithfully (the caller passes the raw value through).
  * NDC-to-screen with x-scale including the aspect ratio (Scene.cpp:329)
  * model = T * R * S                         (Object.cpp:23-31,
    ObjLoader.cpp:32-40)
  * raster z remap: z' = z*(far-near)/2 + (far+near)/2  (Scene.cpp:279-280,
    Scene.cpp:938)

Matrices are row-major NumPy (4,4) float32 applied as ``M @ [x,y,z,1]^T``
(glm is column-major; glm's m[c][r] is our M[r,c]).
"""

from __future__ import annotations

import numpy as np

Vec3 = np.ndarray


def _v3(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float32)
    if a.shape != (3,):
        raise ValueError(f"expected vec3, got shape {a.shape}")
    return a


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at_lh(eye, center, up) -> np.ndarray:
    """Left-handed look-at view matrix (glm::lookAtLH semantics)."""
    eye, center, up = _v3(eye), _v3(center), _v3(up)
    f = normalize(center - eye)          # forward (+z in view space)
    s = normalize(np.cross(up, f))       # right
    u = np.cross(f, s)                   # true up
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = -np.dot(f, eye)
    return m


def perspective_lh_no(fovy, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """Left-handed perspective, NO depth range [-1,1] (glm::perspectiveLH_NO).

    ``fovy`` is used as-is (radians per glm). The reference passes 45.0
    unconverted (Scene.cpp:293 via main.cpp:157), so callers emulating the
    reference should do the same.
    """
    tan_half = np.tan(np.float32(fovy) / 2.0, dtype=np.float32)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = (z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = 1.0
    return m


def ndc_to_screen(width: int, height: int) -> np.ndarray:
    """Viewport matrix (Scene.cpp:314-335).

    Quirk preserved: the x scale additionally multiplies the aspect ratio
    (``width/2 * aspect``, Scene.cpp:329) and y is NOT flipped despite the
    comment in the reference.
    """
    if height == 0:
        raise ValueError("Height cannot be zero!")
    aspect = width / float(height)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = width / 2.0 * aspect
    m[1, 1] = height / 2.0
    m[0, 3] = width / 2.0
    m[1, 3] = height / 2.0
    return m


def rotate_axis_angle(axis, angle_rad: float) -> np.ndarray:
    """Rotation about an arbitrary axis (glm::rotate semantics, normalizes)."""
    a = normalize(_v3(axis))
    c = np.float32(np.cos(angle_rad))
    s = np.float32(np.sin(angle_rad))
    t = 1.0 - c
    x, y, z = a
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ],
        dtype=np.float32,
    )
    return m


def model_trs(axis, angle_deg: float, translation, scale) -> np.ndarray:
    """Model matrix = T * R * S (Object.cpp:23-31; angle in degrees)."""
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = _v3(translation)
    r = rotate_axis_angle(axis, np.radians(np.float32(angle_deg)))
    s = np.diag(np.append(_v3(scale), np.float32(1.0))).astype(np.float32)
    return t @ r @ s


def transform_points_h(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 to (N,3) points with perspective divide (Tools::to_vec3)."""
    pts = np.asarray(pts, dtype=np.float32)
    h = pts @ m[:3, :3].T + m[:3, 3]
    w = pts @ m[3, :3].T + m[3, 3]
    return h / w[..., None]


def normal_matrix_mat4(model: np.ndarray) -> np.ndarray:
    """transpose(inverse(M4)) — the RASTER normal transform (Scene.cpp:923).

    The reference then applies it to vec4(n, 1.0) and perspective-divides
    (Scene.cpp:939); use ``transform_points_h`` to match that quirk.
    """
    return np.linalg.inv(model).T.astype(np.float32)


def normal_matrix_mat3(model: np.ndarray) -> np.ndarray:
    """transpose(inverse(mat3(M))) — the RAY-TRACE normal transform
    (Triangle.cpp:221)."""
    return np.linalg.inv(model[:3, :3]).T.astype(np.float32)


def transform_normals_raster(model: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Raster-path normal transform, including the divide-by-w quirk and no
    re-normalization (Scene.cpp:939-947)."""
    return transform_points_h(normal_matrix_mat4(model), normals)


def transform_normals_rt(model: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Ray-trace-path normal transform: mat3 inverse-transpose, normalized
    (Triangle.cpp:228-230)."""
    n = np.asarray(normals, np.float32) @ normal_matrix_mat3(model).T
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.where(ln > 0, ln, 1.0)


def decompose_max_scale(model: np.ndarray) -> float:
    """max scale component of a TRS matrix — the reference scales sphere
    radii by max(scale.xyz) after glm::decompose (Sphere.cpp:30-41).
    For a T*R*S matrix the scale components are the column norms."""
    cols = model[:3, :3]
    s = np.linalg.norm(cols, axis=0)
    return float(np.max(s))


def z_remap_params(z_near: float, z_far: float):
    """scale=(far-near)/2, offset=(far+near)/2 (Scene.cpp:279-280)."""
    return (
        np.float32((z_far - z_near) / 2.0),
        np.float32((z_far + z_near) / 2.0),
    )


def raster_vertex_transform(
    positions: np.ndarray,
    normals: np.ndarray,
    model: np.ndarray,
    view: np.ndarray,
    projection: np.ndarray,
    ndc: np.ndarray,
    z_near: float,
    z_far: float,
):
    """The reference's raster vertex stage (Scene::loadTriangleStream,
    Scene.cpp:903-964): NDC*P*V*M positions with z remap, inverse-transpose
    normals with the vec4/w quirk."""
    ndc_mvp = ndc @ projection @ view @ model
    pos = transform_points_h(ndc_mvp, positions)
    scale, offset = z_remap_params(z_near, z_far)
    pos[:, 2] = pos[:, 2] * scale + offset
    nrm = transform_normals_raster(model, normals)
    return pos, nrm


def rt_vertex_transform(
    positions: np.ndarray,
    normals: np.ndarray,
    model: np.ndarray,
    view: np.ndarray,
    projection: np.ndarray,
):
    """The reference's ray-trace vertex stage (Triangle::updatePosition,
    Triangle.cpp:215-231): P*V*M positions (no NDC/z-remap), mat3
    inverse-transpose normalized normals."""
    mvp = projection @ view @ model
    pos = transform_points_h(mvp, positions)
    nrm = transform_normals_rt(model, normals)
    return pos, nrm
