"""The port's native host library (`utils/native.py` over
csrc/srt_native.cpp) against its Python paths and against the JAX
package's native library (`software_rasterizer_tpu/utils/native.py` over
native/srt_native.cpp), and the OBJ loader's in-repository cases of
tests/test_obj_loader.py re-pointed at the port.

Tolerances: 0 everywhere but one. The native and Python BVH builds sum
the cumulative `area` in float32 and float64, so there `area` agrees to
rtol 1e-6 (as tests/test_native.py); against the JAX package's default
(native) build, built from the same source with the same flags, every
field is equal, `area` included.
"""

import math

import numpy as np
import pytest

from software_rasterizer_tpu.ops import bvh as jbvh
from software_rasterizer_tpu.scenes import cornell as jcornell
from software_rasterizer_tpu.utils import native as jnative
from software_rasterizer_tpu_torch.ops import bvh as tb
from software_rasterizer_tpu_torch.scenes import build_cornell_scene
from software_rasterizer_tpu_torch.scenes import cornell as tcornell
from software_rasterizer_tpu_torch.scenes.stress import subdivide_mesh
from software_rasterizer_tpu_torch.utils import native
from software_rasterizer_tpu_torch.utils.obj_loader import load_obj, load_obj_source
from software_rasterizer_tpu_torch.utils.texture import Texture
from torch_scenes import stress_cornell

AREA_RTOL = 1e-6  # tests/test_native.py


def _tris(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 1, 3))
    return (base + rng.normal(0, 0.4, (n, 3, 3))).astype(np.float32)


def _inputs(tris):
    lo, hi = tb.primitive_bounds(tris[:, 0], tris[:, 1], tris[:, 2])
    return lo, hi, tb.triangle_areas(tris[:, 0], tris[:, 1], tris[:, 2])


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 1000])
def test_native_bvh_matches_python(n):
    lo, hi, areas = _inputs(_tris(n))
    nat = tb.build_bvh(lo, hi, areas, use_native=True)
    py = tb.build_bvh(lo, hi, areas, use_native=False)
    for field in ("left", "right", "prim", "bb_min", "bb_max"):
        np.testing.assert_array_equal(getattr(nat, field), getattr(py, field))
    np.testing.assert_array_equal(tb.leaf_order(nat), tb.leaf_order(py))
    np.testing.assert_allclose(nat.area, py.area, rtol=AREA_RTOL)


def test_native_bvh_equals_the_jax_default_build():
    """On the 9,216-triangle box in its scene order (what
    `Scene.rt_geometry` builds over): the port's default (native) build
    equals the JAX package's default build in every field."""
    assert jnative.available(), "the JAX package's native library did not build"
    scene = stress_cornell(build_cornell_scene, subdivide_mesh, 4)
    g = scene.rt_geometry(bvh_order=False)
    tv = g.positions[g.faces[g.face_valid]]
    assert tv.shape == (9216, 3, 3)
    lo, hi, areas = _inputs(tv)
    mine = tb.build_bvh(lo, hi, areas)
    ref = jbvh.build_bvh(lo, hi, areas)
    for field in ref._fields:
        a, b = getattr(mine, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    # and the Python builds of the two packages, each against the other
    mine_py = tb.build_bvh(lo, hi, areas, use_native=False)
    ref_py = jbvh.build_bvh(lo, hi, areas, use_native=False)
    for field in ref._fields:
        assert np.array_equal(getattr(mine_py, field), getattr(ref_py, field)), field
    assert (mine.area != mine_py.area).any()  # summation order: the docstring's caveat
    np.testing.assert_allclose(mine.area, mine_py.area, rtol=AREA_RTOL)


@pytest.mark.parametrize("name", ["_FLOOR", "_SMALL", "_LARGE"])
def test_parse_obj_native_matches_jax(name):
    src = getattr(tcornell, name)
    assert src == getattr(jcornell, name)
    mine, ref = native.parse_obj_native(src), jnative.parse_obj_native(src)
    assert ref is not None
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_source_is_the_jax_packages():
    """csrc/srt_native.cpp is a byte-identical copy of native/srt_native.cpp."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    assert native.SOURCE.read_bytes() == (root / "native" / "srt_native.cpp").read_bytes()


@pytest.mark.parametrize("call", ["build_bvh", "load_obj_source", "load"])
def test_a_failed_build_raises(tmp_path, monkeypatch, call):
    """use_native=True has no quiet fallback: a build with a compiler that
    is not there raises with the command."""
    missing = str(tmp_path / "no-such-g++")
    if call == "load":
        with pytest.raises(RuntimeError, match="no-such-g"):
            native.load(cxx=missing)
        return
    real = native.load
    monkeypatch.setattr(native, "load", lambda path=None, cxx=missing: real(path, cxx))
    with pytest.raises(RuntimeError, match="no-such-g"):
        if call == "build_bvh":
            tb.build_bvh(*_inputs(_tris(4)), use_native=True)
        else:
            load_obj_source(tcornell._FLOOR, use_native=True)
    assert not native.library_file(missing).exists()


# ------------------------------------------- tests/test_obj_loader.py cases


def test_mtl_last_material_quirk(tmp_path):
    mtl = tmp_path / "two.mtl"
    mtl.write_text("newmtl first\nKd 1 0 0\nnewmtl second\nKd 0 1 0\nNs 42\n")
    obj = tmp_path / "two.obj"
    obj.write_text("mtllib two.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    mesh = load_obj(str(obj))
    # reference keeps only the LAST material in the file (ObjLoader.cpp:47-73)
    assert mesh.material.name == "second"
    assert mesh.material.Kd == (0.0, 1.0, 0.0)
    assert mesh.material.Ns == 42.0


def test_dedup_and_fan_triangulation(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    mesh = load_obj(str(obj))
    assert mesh.faces.shape[0] == 2           # fan: (0,1,2),(0,2,3)
    assert mesh.vertices.shape[0] == 4        # dedup across the two tris
    np.testing.assert_array_equal(mesh.faces, [[0, 1, 2], [0, 2, 3]])


def test_missing_normal_synthesis_overwrite_order(tmp_path):
    # Two faces sharing an edge with opposite winding: shared vertices must
    # carry the SECOND face's normal (reference overwrite quirk).
    obj = tmp_path / "shared.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 2 1 4\n")
    mesh = load_obj(str(obj))
    a, b, c = mesh.vertices[mesh.faces[1]]
    n2 = np.cross(b - a, c - a)
    n2 = n2 / np.linalg.norm(n2)
    # shared vertex index of original v1 ('1 2 3' corner 0 == '2 1 4' corner 1)
    got = mesh.normals[mesh.faces[1][1]]
    assert np.dot(got, n2) > 0.9  # points with face 2, not face 1


def test_texture_fetch_quirks():
    data = np.zeros((4, 8, 3), np.uint8)
    data[0, 0] = (255, 0, 0)
    data[3, 7] = (0, 255, 0)
    tex = Texture(data)
    assert np.allclose(tex.fetch(np.array([0.0, 0.0])), [1, 0, 0])
    assert np.allclose(tex.fetch(np.array([0.999, 0.999])), [0, 1, 0])
    # uv exactly 1.0 -> BLACK (reference out-of-range quirk)
    assert np.allclose(tex.fetch(np.array([1.0, 0.5])), [0, 0, 0])
    assert np.allclose(tex.fetch(np.array([-0.5, 0.0])), [1, 0, 0])
    uvs = np.random.RandomState(0).rand(16, 2).astype(np.float32)
    assert tex.fetch(uvs).shape == (16, 3)


def _textured_grid(n=6):
    """An OBJ with v, vt, vn, v//vn, v/vt and negative indices, quads."""
    lines = []
    for i in range(n):
        for j in range(n):
            lines.append(f"v {i / 3:.6f} {math.sin(i + j) / 7:.6f} {j / 5:.6f}")
            lines.append(f"vt {i / (n - 1):.6f} {j / (n - 1):.6f}")
    lines.append("vn 0 1 0\nvn 0.6 0.8 0")
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = (i * n + j + 1, (i + 1) * n + j + 1, (i + 1) * n + j + 2,
                          i * n + j + 2)
            if (i + j) % 3 == 0:
                lines.append(f"f {a}/{a}/1 {b}/{b}/2 {c}/{c}/1 {d}/{d}/2")
            elif (i + j) % 3 == 1:
                lines.append(f"f {a}//2 {b}//1 {c}//2")
            else:
                lines.append(f"f {a - n * n - 1}/{a} {c}/{c} {d}/{d}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("src", ["cornell", "grid"])
def test_native_scan_matches_python_scan(src):
    """The native OBJ scan gives the same mesh as the Python scan (the JAX
    test reads the reference's absent assets; these sources are in the
    repository)."""
    texts = list(tcornell._PARTS.values()) if src == "cornell" else [_textured_grid()]
    for text in texts:
        a = load_obj_source(text, use_native=True)
        b = load_obj_source(text, use_native=False)
        for field in ("vertices", "normals", "uvs", "faces", "bbox_min", "bbox_max"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.shape == y.shape and np.array_equal(x, y), field


def test_native_scan_huge_face_capped_consistently():
    """A face with >64 vertices: the counts pass and the fill pass agree,
    and the fan covers the first 64 vertices only (as the Python scan)."""
    nv = 100
    lines = [f"v {math.cos(2 * math.pi * i / nv):.6f} {math.sin(2 * math.pi * i / nv):.6f} 0"
             for i in range(nv)]
    lines.append("f " + " ".join(str(i + 1) for i in range(nv)))
    text = "\n".join(lines)
    pos, nrm, uv, corners = native.parse_obj_native(text)
    assert pos.shape == (nv, 3)
    assert corners.shape == (3 * (64 - 2), 3)
    assert corners[:, 0].min() >= 0 and corners[:, 0].max() < 64
    np.testing.assert_array_equal(load_obj_source(text).faces,
                                  load_obj_source(text, use_native=False).faces)
