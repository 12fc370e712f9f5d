"""BVH acceleration (reference: include/bvh/BVHAcceleration.hpp,
src/BVHAcceleration.cpp).

Reference algorithm: recursive binary build, median split along the
longest centroid-extent axis, 1-primitive leaves with a 2-primitive
special case (BVHAcceleration.cpp:142-198); nodes carry cumulative
surface area for area-weighted light sampling (:200-232); traversal
prunes by slab AABB test and takes the nearer of both children
(:103-140).

Host half: `build_bvh` (C++ by default, or NumPy) is the reference's
exact build flattened to arrays, `leaf_order` extracts the DFS
primitive order that `Scene.rt_geometry` uses to permute faces, and
`chunk_bounds` boxes runs of leaf-ordered triangles. Device half, plain
functions on tensors: `slab_test` (the conservative ray-box test behind
every chunk cull), and the per-ray traversals `bvh_nearest_leaf`,
`bvh_nearest_hit` and `bvh_sample_area` over a `FlatBVH.to(device)`. The JAX package writes
the traversals as a `while_loop` a ray under `vmap`; here all rays step
together over an (N, max_depth) stack until none is live, each ray
following exactly its own walk.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class FlatBVH(NamedTuple):
    """Flattened binary BVH (node 0 = root): NumPy arrays from
    `build_bvh`, tensors after `to(device)`."""

    bb_min: np.ndarray   # (M,3) f32
    bb_max: np.ndarray   # (M,3)
    left: np.ndarray     # (M,) i32 child index, -1 at leaves
    right: np.ndarray    # (M,) i32
    prim: np.ndarray     # (M,) i32 primitive index, -1 at internal nodes
    area: np.ndarray     # (M,) f32 cumulative primitive surface area

    def to(self, device) -> "FlatBVH":
        """The same tree as tensors on `device` (indices int64)."""
        f32, i64 = torch.float32, torch.int64
        return FlatBVH(*(
            torch.as_tensor(np.asarray(a), dtype=dt, device=device)
            for a, dt in zip(self, (f32, f32, i64, i64, i64, f32))))


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


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, areas: np.ndarray,
              use_native: bool = True) -> FlatBVH:
    """Median-split build over primitive AABBs (BVHAcceleration.cpp:142-198:
    split axis = longest centroid extent, sort + halve, leaf = 1 prim,
    2-prim special case). `use_native` takes the C++ builder
    (`utils/native.py`, built at first use; a failed build raises), else
    the Python one. What holds against the JAX package's builder:
      * the native build is bit-identical to the JAX default (native)
        build, `area` included;
      * the Python build is bit-identical to the JAX Python build
        (`use_native=False`);
      * between the native and Python builds, node order, leaf order and
        boxes are equal, and `area` agrees to rtol 1e-6: the native build
        sums it in float32, the Python build in float64."""
    if use_native and bb_min.shape[0] > 0:
        from software_rasterizer_tpu_torch.utils.native import build_bvh_native

        return FlatBVH(*build_bvh_native(bb_min, bb_max, areas))
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


def chunk_bounds(v0, v1, v2, valid, chunk: int):
    """Per-chunk AABBs over (leaf-ordered) triangles (NumPy). Arrays (F,3)
    with F a multiple of `chunk`; invalid (padding) triangles are
    excluded. Returns (nc,3) mins and maxs (+inf/-inf for empty chunks).
    `ops/trace_tiers.chunk_bounds` is the tensor form the trace tiers
    use (1e30 in place of inf, any F)."""
    f = v0.shape[0]
    nc = f // chunk
    m3 = valid[:, None]
    lo = np.where(m3, np.minimum(np.minimum(v0, v1), v2), np.inf)
    hi = np.where(m3, np.maximum(np.maximum(v0, v1), v2), -np.inf)
    return (
        lo.reshape(nc, chunk, 3).min(1).astype(np.float32),
        hi.reshape(nc, chunk, 3).max(1).astype(np.float32),
    )


# ------------------------------------------------------- the device half


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(d == 0.0, 1e-30, d)


def _slab(orig, inv, bb_min, bb_max):
    """(tmin, tmax) of rays against boxes of the same leading shape: the
    x, y, z slabs folded in that order, a NaN handed on."""
    t0 = (bb_min - orig) * inv
    t1 = (bb_max - orig) * inv
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(near[..., 0], near[..., 1]), near[..., 2])
    tmax = torch.minimum(torch.minimum(far[..., 0], far[..., 1]), far[..., 2])
    return tmin, tmax


def slab_test(orig, d, bb_min, bb_max) -> torch.Tensor:
    """Vectorized Bounds3::intersect slab test (Bounds3.cpp:31-80):
    conservative ray-AABB overlap for rays (N,3) x boxes (B,3). Returns
    (N,B) bool (t_exit >= max(t_enter, 0)). A zero direction component
    counts as 1e-30; a NaN ray enters no box."""
    tmin, tmax = _slab(orig[:, None], _inv_dir(d)[:, None], bb_min[None],
                       bb_max[None])
    return tmax >= torch.clamp(tmin, min=0.0)


def _node_entry(bvh: FlatBVH, ni, o, inv, miss: float):
    """Entry distance max(t_enter, 0) of rays o (K,3) into their nodes ni
    (K,), `miss` where the slab test fails."""
    tmin, tmax = _slab(o, inv, bvh.bb_min[ni], bvh.bb_max[ni])
    entry = torch.clamp(tmin, min=0.0)
    return torch.where(tmax >= entry, entry, miss)


def _traverse(bvh: FlatBVH, orig, d, max_depth: int, leaf_t, miss: float):
    """The stack walk `bvh_nearest_leaf` and `bvh_nearest_hit` share.
    Every live ray pops a node; it is visited if its entry distance lies
    below the ray's best t; a visited leaf offers `leaf_t(rays, prims,
    entry)` and wins under a strict `<`; a visited internal node pushes
    right then left, so left is popped first. Returns (best_t, best_p)."""
    n, dev = orig.shape[0], orig.device
    inv = _inv_dir(d)
    best_t = torch.full((n,), miss, dtype=torch.float32, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stack = torch.full((n, max_depth), -1, dtype=torch.int64, device=dev)
    stack[:, 0] = 0
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    while True:
        r = torch.nonzero(sp > 0).flatten()
        if r.numel() == 0:
            return best_t, best_p
        top = sp[r] - 1
        ni = stack[r, top]
        entry = _node_entry(bvh, ni, orig[r], inv[r], miss)
        visit = (entry < best_t[r]) & (entry < miss)
        leaf = bvh.prim[ni] >= 0
        lv = visit & leaf
        if bool(lv.any()):
            rl, pl = r[lv], bvh.prim[ni[lv]]
            t = leaf_t(rl, pl, entry[lv])
            better = t < best_t[rl]
            best_t[rl] = torch.where(better, t, best_t[rl])
            best_p[rl] = torch.where(better, pl, best_p[rl])
        push = visit & ~leaf
        if bool((push & (top + 2 > max_depth)).any()):
            raise ValueError(f"the traversal stack overflows max_depth={max_depth}")
        rp, tp = r[push], top[push]
        stack[rp, tp] = bvh.right[ni[push]]
        stack[rp, tp + 1] = bvh.left[ni[push]]
        sp[r] = torch.where(push, top + 2, top)


def bvh_nearest_leaf(bvh: FlatBVH, orig, d, max_depth: int = 64) -> torch.Tensor:
    """Per ray, the primitive of the leaf whose box the ray enters first
    (lowest slab-entry distance; the walk prunes by the best so far).
    `bvh` from `FlatBVH.to(device)`. Returns (N,) int64, -1 if the root is
    missed. A parity probe: tracing uses the chunked tiers."""
    _, p = _traverse(bvh, orig, d, max_depth,
                     lambda rays, prims, entry: entry, float("inf"))
    return p


def bvh_nearest_hit(bvh: FlatBVH, v0, v1, v2, orig, d, max_depth: int = 64):
    """True per-ray nearest-hit traversal (BVHAcceleration::intersection,
    BVHAcceleration.cpp:103-140): at every visited leaf the primitive is
    intersected (Moller-Trumbore, |det| >= 1e-6, t >= 1e-6) and the best
    hit kept; subtrees are pruned by the slab test and by the running
    best t. v0/v1/v2 (F,3) in the tree's primitive order. Returns (t (N,)
    float32, prim (N,) int64); 1e30 / -1 on a miss."""
    big = 1e30

    def leaf_t(rays, prims, _entry):
        o, dd = orig[rays], d[rays]
        a = v0[prims]
        e1, e2 = v1[prims] - a, v2[prims] - a
        pv = torch.linalg.cross(dd, e2)
        det = (e1 * pv).sum(dim=1)
        invd = 1.0 / torch.where(det.abs() < 1e-6, 1.0, det)
        tv = o - a
        uu = (tv * pv).sum(dim=1) * invd
        qv = torch.linalg.cross(tv, e1)
        vv = (dd * qv).sum(dim=1) * invd
        tt = (e2 * qv).sum(dim=1) * invd
        ok = ((det.abs() >= 1e-6) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
              & (uu + vv <= 1.0) & (tt >= 1e-6))
        return torch.where(ok, tt, big)

    t, p = _traverse(bvh, orig, d, max_depth, leaf_t, big)
    return t, torch.where(t < big, p, -1)


def bvh_sample_area(bvh: FlatBVH, u: torch.Tensor):
    """BVHAcceleration::sample cumulative-area descend
    (BVHAcceleration.cpp:200-232): target = u * root.area; an internal
    node goes left when target < left.area, else subtracts left.area and
    goes right, so each leaf is drawn with probability leaf_area /
    root_area. u: (N,) uniforms in [0,1). Returns (prim (N,) int64, pdf
    (N,) float32 = 1 / root_area, the reference's composed value)."""
    ni = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
    tgt = u * bvh.area[0]
    while True:
        r = torch.nonzero(bvh.prim[ni] < 0).flatten()
        if r.numel() == 0:
            break
        l, rt = bvh.left[ni[r]], bvh.right[ni[r]]
        la = bvh.area[l]
        go_left = tgt[r] < la
        ni[r] = torch.where(go_left, l, rt)
        tgt[r] = torch.where(go_left, tgt[r], tgt[r] - la)
    root = bvh.area[0]
    pdf = torch.where(root > 0, 1.0 / torch.clamp(root, min=1e-30),
                      torch.zeros_like(root))
    return bvh.prim[ni], pdf.expand(u.shape[0]).clone()
