"""BVH acceleration (reference: include/bvh/BVHAcceleration.hpp,
src/BVHAcceleration.cpp).

Reference algorithm: recursive binary build, median split along the
longest centroid-extent axis, 1-primitive leaves with a 2-primitive
special case (BVHAcceleration.cpp:142-198); nodes carry cumulative
surface area for area-weighted light sampling (:200-232); traversal
prunes by slab AABB test and takes the nearer of both children
(:103-140).

The host half of the JAX package's ops/bvh.py: `build_bvh` (NumPy) is
the reference's exact build flattened to arrays, and `leaf_order`
extracts the DFS primitive order that `Scene.rt_geometry` uses to
permute faces. The device half (slab test, per-ray traversal) is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class FlatBVH(NamedTuple):
    """Flattened binary BVH (node 0 = root)."""

    bb_min: np.ndarray   # (M,3) f32
    bb_max: np.ndarray   # (M,3)
    left: np.ndarray     # (M,) i32 child index, -1 at leaves
    right: np.ndarray    # (M,) i32
    prim: np.ndarray     # (M,) i32 primitive index, -1 at internal nodes
    area: np.ndarray     # (M,) f32 cumulative primitive surface area


def primitive_bounds(v0, v1, v2) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle AABBs (Bounds3 union of the three vertices)."""
    bb_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    bb_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    return bb_min, bb_max


def triangle_areas(v0, v1, v2) -> np.ndarray:
    """0.5*|e1 x e2| (Triangle.cpp:259-266)."""
    return 0.5 * np.linalg.norm(
        np.cross(v1 - v0, v2 - v0), axis=-1
    ).astype(np.float32)


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray,
              areas: np.ndarray) -> FlatBVH:
    """Median-split build over primitive AABBs (BVHAcceleration.cpp:142-198:
    split axis = longest centroid extent, sort + halve, leaf = 1 prim,
    2-prim special case). Bit-identical to the JAX package's builder,
    native or Python."""
    n = bb_min.shape[0]
    if n == 0:
        z = np.zeros((1, 3), np.float32)
        return FlatBVH(z, z, np.full(1, -1, np.int32), np.full(1, -1, np.int32),
                       np.full(1, -1, np.int32), np.zeros(1, np.float32))
    centroids = (bb_min + bb_max) * 0.5

    nodes_min, nodes_max, left, right, prim, area = [], [], [], [], [], []

    def new_node():
        nodes_min.append(None); nodes_max.append(None)
        left.append(-1); right.append(-1); prim.append(-1); area.append(0.0)
        return len(left) - 1

    def build(idxs: np.ndarray) -> int:
        ni = new_node()
        if len(idxs) == 1:
            p = int(idxs[0])
            nodes_min[ni], nodes_max[ni] = bb_min[p], bb_max[p]
            prim[ni] = p
            area[ni] = float(areas[p])
            return ni
        if len(idxs) == 2:
            l = build(idxs[:1]); r = build(idxs[1:])
        else:
            c = centroids[idxs]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            order = idxs[np.argsort(c[:, axis], kind="stable")]
            mid = len(order) // 2
            l = build(order[:mid]); r = build(order[mid:])
        left[ni], right[ni] = l, r
        nodes_min[ni] = np.minimum(nodes_min[l], nodes_min[r])
        nodes_max[ni] = np.maximum(nodes_max[l], nodes_max[r])
        area[ni] = area[l] + area[r]
        return ni

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 100))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old)

    return FlatBVH(
        np.asarray(nodes_min, np.float32),
        np.asarray(nodes_max, np.float32),
        np.asarray(left, np.int32),
        np.asarray(right, np.int32),
        np.asarray(prim, np.int32),
        np.asarray(area, np.float32),
    )


def leaf_order(bvh: FlatBVH) -> np.ndarray:
    """DFS left-to-right primitive order — the spatial-coherence
    permutation used to reorder triangles before chunking."""
    out, stack = [], [0]
    while stack:
        ni = stack.pop()
        if bvh.prim[ni] >= 0:
            out.append(bvh.prim[ni])
        else:
            stack.append(int(bvh.right[ni]))
            stack.append(int(bvh.left[ni]))
    return np.asarray(out, np.int64)
