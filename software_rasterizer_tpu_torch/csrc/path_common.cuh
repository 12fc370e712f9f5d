// What the path-tracing kernels share (path_camera.cu, path_bounce.cu):
// constants, the 3-vector, _norm3, Tools::toWorld, Moller-Trumbore, the
// sphere quadratic and the dual trace of a shadow ray and a bounce ray:
// `dual_trace_block`, the block sweeping the triangle table staged in
// shared memory with one attribute read a ray after the sweep, or
// `dual_trace_culled`, each ray culling by the box tables of the table on
// its own and the warp testing each (ray, leaf) pair together. Every
// expression is written in the order of the plain PyTorch versions; build
// with -fmad=false and without fast math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

constexpr float kInv2Pi = 0.15915494309189535f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kEps = 1e-5f;
constexpr float kBig = 1e30f;

struct V3 {
  float x, y, z;
};

// _norm3: zero vector when |v| <= eps (or |v| == 0).
__device__ __forceinline__ V3 norm3(float x, float y, float z, float eps) {
  float n = sqrtf(x * x + y * y + z * z);
  float inv = n > 0.0f ? 1.0f / n : 0.0f;
  inv = n > eps ? inv : 0.0f;
  return {x * inv, y * inv, z * inv};
}

// _to_world (Tools::toWorld, Tools.cpp:315-327).
__device__ __forceinline__ V3 to_world(float lx, float ly, float lz, V3 n) {
  bool use_x = fabsf(n.x) > fabsf(n.y);
  float inv_a = 1.0f / sqrtf(fmaxf(n.x * n.x + n.z * n.z, 1e-30f));
  float inv_b = 1.0f / sqrtf(fmaxf(n.y * n.y + n.z * n.z, 1e-30f));
  float cx = use_x ? n.z * inv_a : 0.0f;
  float cy = use_x ? 0.0f : n.z * inv_b;
  float cz = use_x ? -n.x * inv_a : -n.y * inv_b;
  float bx = cy * n.z - cz * n.y;
  float by = cz * n.x - cx * n.z;
  float bz = cx * n.y - cy * n.x;
  return {lx * bx + ly * cx + lz * n.x, lx * by + ly * cy + lz * n.y,
          lx * bz + ly * cz + lz * n.z};
}

struct Hit {
  float t;
  V3 nrm, kd, emit;
  bool is_sphere;
};

// Moller-Trumbore's end for the ray direction d against one row, from the
// row's tv = o - v0 and the dot products dq = d . q and e2q = e2 . q of
// q = tv x e1; the reference thresholds; kBig on a miss.
__device__ __forceinline__ float mt_tail(V3 d, V3 tv, float dq, float e2q, V3 e1,
                                         V3 e2, float* u_out, float* v_out) {
  float px = d.y * e2.z - d.z * e2.y;
  float py = d.z * e2.x - d.x * e2.z;
  float pz = d.x * e2.y - d.y * e2.x;
  float det = e1.x * px + e1.y * py + e1.z * pz;
  float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
  float u = (tv.x * px + tv.y * py + tv.z * pz) * inv;
  float v = dq * inv;
  float t = e2q * inv;
  bool ok = fabsf(det) >= 1e-6f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
            u + v <= 1.0f && t >= 1e-6f;
  *u_out = u;
  *v_out = v;
  return ok ? t : kBig;
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Moller-Trumbore with the reference thresholds; kBig on a miss: mt_tail's
// expressions in the order of one ray (the culled walks test one ray a
// row; taking d . q and e2 . q first there costs their kernels registers).
__device__ __forceinline__ float mt(V3 d, V3 tv, V3 q, V3 e1, V3 e2,
                                    float* u_out, float* v_out) {
  float px = d.y * e2.z - d.z * e2.y;
  float py = d.z * e2.x - d.x * e2.z;
  float pz = d.x * e2.y - d.y * e2.x;
  float det = e1.x * px + e1.y * py + e1.z * pz;
  float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
  float u = (tv.x * px + tv.y * py + tv.z * pz) * inv;
  float v = (d.x * q.x + d.y * q.y + d.z * q.z) * inv;
  float t = (e2.x * q.x + e2.y * q.y + e2.z * q.z) * inv;
  bool ok = fabsf(det) >= 1e-6f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
            u + v <= 1.0f && t >= 1e-6f;
  *u_out = u;
  *v_out = v;
  return ok ? t : kBig;
}

// Sphere quadratic (the JAX kernel's hit_sph); kBig on a miss.
__device__ __forceinline__ float hit_sphere(V3 d, V3 l, float c0,
                                            bool valid) {
  float a = d.x * d.x + d.y * d.y + d.z * d.z;
  float b = 2.0f * (d.x * l.x + d.y * l.y + d.z * l.z);
  float disc = b * b - 4.0f * a * c0;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  q = q == 0.0f ? 1e-30f : q;
  float x0 = q / a;
  float x1 = c0 / q;
  bool both = x0 > 0.0f && x1 > 0.0f;
  float t = both ? fminf(x0, x1) : (x0 > 0.0f ? x0 : x1);
  bool ok = disc >= 0.0f && t > 0.0f && valid;
  return ok ? t : kBig;
}

// Attribute interpolation of row `at` at (u, v): the hit normal.
__device__ __forceinline__ V3 interp_nrm(const float* at, float u, float v) {
  const float w = 1.0f - u - v;
  return {w * at[0] + u * at[3] + v * at[6], w * at[1] + u * at[4] + v * at[7],
          w * at[2] + u * at[5] + v * at[8]};
}

// t (kBig on a miss) and (u, v) of ray (o, d) against the [v0|e1|e2|pad]
// row `g`.
__device__ __forceinline__ float tri_t(const float* g, V3 o, V3 d, float* u,
                                       float* v) {
  const V3 e1 = {g[3], g[4], g[5]};
  const V3 e2 = {g[6], g[7], g[8]};
  const V3 tv = {o.x - g[0], o.y - g[1], o.z - g[2]};
  const V3 q = {tv.y * e1.z - tv.z * e1.y, tv.z * e1.x - tv.x * e1.z,
                tv.x * e1.y - tv.y * e1.x};
  return mt(d, tv, q, e1, e2, u, v);
}

// Row f's attributes into h, hit at tm and (u, v): the shadow ray keeps
// the normal and emission, the bounce ray (kBounce) also Kd and the
// sphere flag.
template <bool kBounce>
__device__ __forceinline__ void take_row(const float* __restrict__ attr, int f,
                                         float tm, float u, float v, Hit* h) {
  const float* at = attr + 16 * f;
  h->t = tm;
  h->nrm = interp_nrm(at, u, v);
  if (kBounce) {
    h->kd = {at[9], at[10], at[11]};
    h->is_sphere = false;
  }
  h->emit = {at[12], at[13], at[14]};
}

// The sphere loop after the triangles (_sph_dual_merge): strict `<`, so
// a triangle beats a sphere on a tie.
__device__ __forceinline__ void merge_spheres(const float* __restrict__ sph,
                                              int n_sph, V3 o, V3 la, V3 lb,
                                              Hit* A, Hit* B) {
  for (int s = 0; s < n_sph; ++s) {
    const float* r = sph + 12 * s;
    V3 c = {r[0], r[1], r[2]};
    float rr = r[3];
    V3 l = {o.x - c.x, o.y - c.y, o.z - c.z};
    float c0 = l.x * l.x + l.y * l.y + l.z * l.z - rr * rr;
    bool valid = r[7] > 0.0f;
    float inv_r = 1.0f / fmaxf(rr, 1e-20f);
    float ts = hit_sphere(la, l, c0, valid);
    if (ts < A->t) {
      A->t = ts;
      A->nrm = {(o.x + la.x * ts - c.x) * inv_r,
                (o.y + la.y * ts - c.y) * inv_r,
                (o.z + la.z * ts - c.z) * inv_r};
      A->emit = {r[4], r[5], r[6]};
    }
    ts = hit_sphere(lb, l, c0, valid);
    if (ts < B->t) {
      B->t = ts;
      B->nrm = {(o.x + lb.x * ts - c.x) * inv_r,
                (o.y + lb.y * ts - c.y) * inv_r,
                (o.z + lb.z * ts - c.z) * inv_r};
      B->kd = {r[8], r[9], r[10]};
      B->emit = {r[4], r[5], r[6]};
      B->is_sphere = true;
    }
  }
}

__device__ __forceinline__ void no_hit(Hit* A, Hit* B) {
  *A = {kBig, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, false};
  *B = *A;
}

// ---- the full sweep: the block stages the table, each thread sweeps it
//
// Rows of the [v0|e1|e2|pad] table go to shared memory as 3 float4 (48
// bytes) a row, kStageRows at a time, copied with cp.async by every thread
// of the block; every thread then reads the same row at once (a broadcast,
// no bank conflict). A table of at most kStageRows rows (the Cornell box:
// 36) is staged once, when the kernel starts, and never again; a larger one
// is staged slice by slice inside each sweep, which then needs the whole
// block at every slice's two barriers. A tuning value that changes no
// result.
constexpr int kStageRows = 256;

// Bytes of dynamic shared memory the staged sweep of n_tri rows needs.
inline int stage_bytes(int n_tri) {
  const int rows = n_tri < 0 ? 0 : (n_tri < kStageRows ? n_tri : kStageRows);
  return rows * 3 * (int)sizeof(float4);
}

// Copy rows [f0, f0 + cnt) of the (16-byte aligned) table into `dst` with
// the whole block; returns when this thread's copies have landed (the
// caller's __syncthreads() then makes all of them visible).
__device__ __forceinline__ void block_stage_rows(float4* __restrict__ dst,
                                                 const float* __restrict__ tri,
                                                 int f0, int cnt) {
  const float4* src = reinterpret_cast<const float4*>(tri + (size_t)f0 * 12);
  for (int k = threadIdx.x; k < cnt * 3; k += blockDim.x)
    __pipeline_memcpy_async(dst + k, src + k, sizeof(float4));
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// A table small enough to stay staged for the whole launch: the kernel
// stages it once, before its loop, with block_stage_rows, and the sweep
// has no barrier, so its callers need not keep the block together.
__device__ __forceinline__ bool stage_resident(int n_tri) {
  return n_tri <= kStageRows;
}

// A ray's nearest row so far: t (kBig on a miss), row (-1) and the
// winner's (u, v).
struct RowBest {
  float t;
  int row;
  float u, v;
};

// Fold the staged rows [0, cnt) (table rows f0 + i) into the nearest rows
// of the shadow ray (o, la) and the bounce ray (o, lb). Both rays leave
// from o, so tv = o - v0, q = tv x e1 and e2 . q are computed once a row;
// each ray keeps (t, row, u, v) under a strict `<` over ascending rows, so
// the lowest row wins a tie, as in _dual_trace. Two rows an iteration: 4
// did not take less time on an H100, 1 took more.
__device__ __forceinline__ void sweep_rows(const float4* __restrict__ rows,
                                           int f0, int cnt, V3 o, V3 la, V3 lb,
                                           RowBest& a, RowBest& b) {
#pragma unroll 2
  for (int i = 0; i < cnt; ++i) {
    const float4 r0 = rows[3 * i], r1 = rows[3 * i + 1], r2 = rows[3 * i + 2];
    const V3 e1 = {r0.w, r1.x, r1.y};
    const V3 e2 = {r1.z, r1.w, r2.x};
    const V3 tv = {o.x - r0.x, o.y - r0.y, o.z - r0.z};
    const V3 q = {tv.y * e1.z - tv.z * e1.y, tv.z * e1.x - tv.x * e1.z,
                  tv.x * e1.y - tv.y * e1.x};
    // q's three uses at once, so that it is never recomputed
    const float e2q = dot3(e2, q), aq = dot3(la, q), bq = dot3(lb, q);
    float u, v;
    float tm = mt_tail(la, tv, aq, e2q, e1, e2, &u, &v);
    if (tm < a.t) a = {tm, f0 + i, u, v};
    tm = mt_tail(lb, tv, bq, e2q, e1, e2, &u, &v);
    if (tm < b.t) b = {tm, f0 + i, u, v};
  }
}

// _dual_trace: nearest hits of the shadow ray A (o, la) and the bounce
// ray B (o, lb) over every triangle of the table staged in `stage`, then
// spheres. The winner's attributes are read once after the sweep, with
// take_row's expressions: what the last improvement of a per-row fold
// would have read. The whole block calls it together (the sliced sweep
// has barriers); an inactive thread (not `active`) helps stage, tests
// nothing and gets misses.
__device__ __forceinline__ void dual_trace_block(
    const float* __restrict__ tri, const float* __restrict__ attr,
    const float* __restrict__ sph, int n_tri, int n_sph, float4* stage, V3 o,
    V3 la, V3 lb, bool active, Hit* A, Hit* B, srt::Tally& tl) {
  RowBest a = {kBig, -1, 0.0f, 0.0f}, b = a;
  if (stage_resident(n_tri)) {
    if (active) sweep_rows(stage, 0, n_tri, o, la, lb, a, b);
  } else {
    for (int f0 = 0; f0 < n_tri; f0 += kStageRows) {
      const int cnt = min(kStageRows, n_tri - f0);
      __syncthreads();  // every thread is done with the previous slice
      block_stage_rows(stage, tri, f0, cnt);
      __syncthreads();
      if (active) sweep_rows(stage, f0, cnt, o, la, lb, a, b);
    }
  }
  no_hit(A, B);
  if (!active) return;
  tl.rows += 2 * (uint32_t)n_tri;
  if (a.row >= 0) take_row<false>(attr, a.row, a.t, a.u, a.v, A);
  if (b.row >= 0) take_row<true>(attr, b.row, b.t, b.u, b.v, B);
  merge_spheres(sph, n_sph, o, la, lb, A, B);
}

using srt::CullTables;

// dual_trace_block with each ray culling for itself (the mm=True tier of the
// JAX kernel, ops/pallas_path.py:354-365: the shadow rays converge on the
// light while the bounce rays scatter, so one cull for both would keep
// the union): the shadow rays of the warp walk together over the leaves
// their boxes enter (trace_common.cuh warp_walk_chunks), then its bounce
// rays, each row tested with the full sweep's expressions; a winner's
// (u, v) are recomputed from its row with the same expression and its
// attributes read once, as dual_trace_block reads them. Equal to
// dual_trace_block lane for lane. The two walks are one loop, so the
// kernel holds one copy of the walk's code: with two inlined copies the
// camera kernel's frame took 1.6x the time on an H100. The whole warp
// calls it; an inactive thread (not `active`) tests nothing and gets
// misses from the triangles.
__device__ __forceinline__ void dual_trace_culled(
    const float* __restrict__ tri, const float* __restrict__ attr,
    const float* __restrict__ sph, int n_tri, int n_sph, const CullTables& ct,
    V3 o, V3 la, V3 lb, bool active, srt::WarpStage& stage, Hit* A, Hit* B,
    srt::Tally& tl, srt::WalkSlots& slots) {
  no_hit(A, B);
  srt::RowHit ha = {kBig, -1}, hb = ha;
#pragma unroll 1
  for (int w = 0; w < 2; ++w) {
    const V3 d = w == 0 ? la : lb;
    const srt::RowHit h = srt::warp_walk_chunks(
        srt::Ray{o.x, o.y, o.z, d.x, d.y, d.z}, active, ct, tri, n_tri, stage,
        [](const float* g, const srt::Ray& rl) {
          float u, v;
          return tri_t(g, V3{rl.ox, rl.oy, rl.oz}, V3{rl.dx, rl.dy, rl.dz}, &u, &v);
        },
        tl, slots);
    if (w == 0)
      ha = h;
    else
      hb = h;
  }
  float u, v;
  if (ha.row >= 0) {
    tri_t(tri + 12 * ha.row, o, la, &u, &v);
    take_row<false>(attr, ha.row, ha.t, u, v, A);
  }
  if (hb.row >= 0) {
    tri_t(tri + 12 * hb.row, o, lb, &u, &v);
    take_row<true>(attr, hb.row, hb.t, u, v, B);
  }
  merge_spheres(sph, n_sph, o, la, lb, A, B);
}

// The loop count of the full sweeps' SIMT efficiency: the iterations
// (lane-iterations, lane-bounces) in which this thread's lane was active,
// and, on lane 0 of each warp, 32 for every iteration in which any lane of
// the warp was: the lane-slots the warp issued. Every thread of the warp
// calls step() together. Tally entries 3 and 4.
struct LoopTally {
  unsigned long long active = 0, slots = 0;
  __device__ __forceinline__ void step(bool act) {
    active += act ? 1u : 0u;
    const bool any = __any_sync(srt::kFullMask, act);
    if ((threadIdx.x & 31) == 0 && any) slots += 32u;
  }
  __device__ __forceinline__ void flush(unsigned long long* total,
                                        int n_tally) const {
    if (total == nullptr || n_tally < 5) return;
    if (active != 0) atomicAdd(total + 3, active);
    if (slots != 0) atomicAdd(total + 4, slots);
  }
};

__device__ __forceinline__ float len3(V3 v) {
  return sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
}

}  // namespace
