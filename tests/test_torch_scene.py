"""The port's host scene layer against the JAX package's.

Both packages build the same scenes from the same in-repo sources; the
flattened tables are host NumPy on both sides and must be EQUAL array by
array (same dtypes, same values, same BVH leaf order). The transforms
are checked on random matrices from a numpy seed, also for equality."""

import numpy as np
import pytest

from software_rasterizer_tpu import models as jmodels
from software_rasterizer_tpu.models.scene import Scene as JScene
from software_rasterizer_tpu.ops import bvh as jbvh
from software_rasterizer_tpu.scenes import build_cornell_scene as jcornell
from software_rasterizer_tpu.utils import transforms as jtf
from software_rasterizer_tpu_torch import models as tmodels
from software_rasterizer_tpu_torch.models.scene import Scene as TScene
from software_rasterizer_tpu_torch.ops import bvh as tbvh
from software_rasterizer_tpu_torch.scenes import build_cornell_scene as tcornell
from software_rasterizer_tpu_torch.utils import transforms as ttf
from torch_scenes import spheres

SCENES = {
    "cornell": (jcornell, tcornell),
    "spheres": (lambda: spheres(jmodels, JScene),
                lambda: spheres(tmodels, TScene)),
}


def _assert_equal_tables(a, b):
    assert type(a).__name__ == type(b).__name__
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if field == "materials":
            for f in ("type", "ka", "kd", "ks", "spec_exp", "ior", "emission"):
                xa, ya = getattr(x, f), getattr(y, f)
                assert xa.dtype == ya.dtype and np.array_equal(xa, ya), f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, field
        assert x.shape == y.shape, field
        assert np.array_equal(x, y), field


@pytest.mark.parametrize("method", ["rt_geometry", "rt_frame",
                                    "raster_geometry", "raster_frame"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_tables_equal(scene, method):
    jbuild, tbuild = SCENES[scene]
    js, ts = jbuild(), tbuild()
    js.set_ndc_matrix(32, 24)
    ts.set_ndc_matrix(32, 24)
    _assert_equal_tables(getattr(js, method)(), getattr(ts, method)())


def test_bvh_build_and_leaf_order_equal():
    rng = np.random.default_rng(7)
    v = rng.standard_normal((200, 3, 3)).astype(np.float32)
    lo, hi = tbvh.primitive_bounds(v[:, 0], v[:, 1], v[:, 2])
    jlo, jhi = jbvh.primitive_bounds(v[:, 0], v[:, 1], v[:, 2])
    area = tbvh.triangle_areas(v[:, 0], v[:, 1], v[:, 2])
    assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
    assert np.array_equal(area, jbvh.triangle_areas(v[:, 0], v[:, 1], v[:, 2]))
    # the Python builds of the two packages, bit for bit
    tb = tbvh.build_bvh(lo, hi, area, use_native=False)
    jb = jbvh.build_bvh(jlo, jhi, area, use_native=False)
    for field in jb._fields:
        assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
    # the default (native) builds of the two packages, bit for bit; they
    # give the Python builds' tree, and only their cumulative areas are
    # summed in float32
    tn = tbvh.build_bvh(lo, hi, area)
    jn = jbvh.build_bvh(jlo, jhi, area)
    for field in jn._fields:
        assert np.array_equal(getattr(tn, field), getattr(jn, field)), field
    for field in ("bb_min", "bb_max", "left", "right", "prim"):
        assert np.array_equal(getattr(tb, field), getattr(jn, field)), field
    np.testing.assert_allclose(tb.area, jn.area, rtol=1e-5)
    assert np.array_equal(tbvh.leaf_order(tb), jbvh.leaf_order(jn))


def _random_case(seed):
    rng = np.random.default_rng(seed)
    eye = rng.standard_normal(3).astype(np.float32)
    center = eye + rng.standard_normal(3).astype(np.float32)
    up = rng.standard_normal(3).astype(np.float32)
    model = jtf.model_trs(rng.standard_normal(3), float(rng.uniform(-180, 180)),
                          rng.standard_normal(3), rng.uniform(0.2, 2.0, 3))
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    return eye, center, up, model, pts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_equal(seed):
    eye, center, up, model, pts = _random_case(seed)
    pairs = [
        (lambda tf: tf.look_at_lh(eye, center, up)),
        (lambda tf: tf.perspective_lh_no(45.0, 1.5, 0.1, 100.0)),
        (lambda tf: tf.ndc_to_screen(64, 48)),
        (lambda tf: tf.model_trs((0.3, 1.0, -0.2), 37.0, (1, 2, 3), (2, 1, 0.5))),
        (lambda tf: tf.transform_points_h(model, pts)),
        (lambda tf: tf.normal_matrix_mat4(model)),
        (lambda tf: tf.normal_matrix_mat3(model)),
        (lambda tf: tf.transform_normals_rt(model, pts)),
        (lambda tf: tf.transform_normals_raster(model, pts)),
        (lambda tf: np.float32(tf.decompose_max_scale(model))),
        (lambda tf: np.asarray(tf.z_remap_params(0.1, 100.0))),
    ]
    for fn in pairs:
        assert np.array_equal(fn(jtf), fn(ttf))
