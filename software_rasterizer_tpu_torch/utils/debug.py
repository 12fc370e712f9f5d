"""Debug facilities (SURVEY.md 5.2), the port of the JAX package's
utils/debug.py.

The reference's only guards are gcc Debug flags (-ftrapv -fbounds-check,
CMakeLists.txt:44-50) — and it ships a real data race (the shared
unlocked mt19937, Tools.cpp:295-300) those flags never catch. Here:

  * `debug_mode()` — the counterpart of `jax_debug_nans`, which raises
    when a NaN reaches the output of a jitted computation. The port's
    boundaries of that kind are the kernel wrappers (`path_camera_render`,
    `fused_bounce_group`, `whitted_uber_trace`, `raster_tiles_fused` /
    `_shaded`, `nearest_hit`'s trace tier) and the integrator and
    pipeline entry points (`path_trace`, `path_render_accumulate`, the
    three pipelines' `draw()`): inside the block each passes its floating
    outputs through `nan_check`, which raises `FloatingPointError` naming
    the stage. NaN only, as `jax_debug_nans`: the slab tests carry ±inf
    inverse directions and the raster z-buffer inf by design. No hook
    sits on intermediate operations (a dispatch mode over every op would
    catch the slab tests' NaNs that a later select masks);
  * `validate_rt_scene` / `validate_raster_geometry` — host-side
    structural checks (finite geometry, index ranges, mask consistency)
    run before or after uploading a scene, catching loader/assembly bugs
    with actionable messages instead of silent black frames.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

# set inside `debug_mode(nans=True)`; read by `nan_check`
_NANS = False


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Check for NaN inside the block: the kernel wrappers, integrators
    and pipelines raise FloatingPointError on the first NaN in their
    output instead of handing it on into the frame."""
    global _NANS
    old = _NANS
    _NANS = bool(nans)
    try:
        yield
    finally:
        _NANS = old


def _floating(out):
    """The floating tensors in `out` (a tensor, or a tuple, list or dict
    of them and of other values, nested)."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _floating(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _floating(x)


def nan_check(stage: str, out):
    """Return `out`. Inside `debug_mode(nans=True)`, first raise
    FloatingPointError naming `stage` if a floating tensor in `out` holds
    a NaN (this waits for the device). Outside it, nothing is read or
    launched."""
    if _NANS:
        for t in _floating(out):
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {stage} ({int(torch.isnan(t).sum())} of "
                    f"{t.numel()} values of a {tuple(t.shape)} tensor)")
    return out


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _finite(name: str, a, errors: List[str]):
    arr = _np(a)
    if arr.dtype.kind == "f" and not np.isfinite(arr).all():
        errors.append(f"{name}: {np.size(arr) - np.isfinite(arr).sum()} non-finite values")


def validate_rt_scene(rt) -> List[str]:
    """Structural checks on an RTScene (`ops/intersect.py`, its fields
    tensors); returns a list of problems."""
    errors: List[str] = []
    f = _np(rt.v0).shape[0]
    for name in ("v0", "v1", "v2", "n0", "n1", "n2", "sph_c", "mat_kd", "mat_emit"):
        _finite(name, getattr(rt, name), errors)
    for name in ("tri_mat", "tri_obj"):
        idx = _np(getattr(rt, name))
        if idx.shape[0] != f:
            errors.append(f"{name}: length {idx.shape[0]} != F={f}")
        if (idx < 0).any():
            errors.append(f"{name}: negative indices")
    n_mat = _np(rt.mat_kd).shape[0]
    if (_np(rt.tri_mat) >= n_mat).any():
        errors.append(f"tri_mat: index >= material count {n_mat}")
    valid = _np(rt.tri_valid)
    if valid.dtype != np.bool_:
        errors.append("tri_valid: not boolean")
    if _np(rt.n_emitters) == 0 and _np(rt.emitter_mask).any():
        errors.append("emitter_mask/n_emitters inconsistent")
    return errors


def validate_raster_geometry(geom) -> List[str]:
    """Structural checks on a RasterGeometry bundle (`models/scene.py`,
    its fields arrays or tensors)."""
    errors: List[str] = []
    v = _np(geom.positions).shape[0]
    for name in ("positions", "normals", "uvs", "colors", "textures"):
        _finite(name, getattr(geom, name), errors)
    faces = _np(geom.faces)
    if (faces < 0).any() or (faces >= v).any():
        errors.append(f"faces: vertex indices outside [0, {v})")
    n_mesh = _np(geom.shader_type).shape[0]
    if (_np(geom.face_mesh) >= n_mesh).any():
        errors.append(f"face_mesh: mesh id >= {n_mesh}")
    n_tex = _np(geom.textures).shape[0]
    if (_np(geom.tex_id) >= n_tex).any():
        errors.append(f"tex_id: texture id >= {n_tex}")
    return errors
