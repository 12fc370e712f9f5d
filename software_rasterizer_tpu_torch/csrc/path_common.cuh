// What the path-tracing kernels share (path_camera.cu, path_bounce.cu):
// constants, the 3-vector, _norm3, Tools::toWorld, Moller-Trumbore, the
// sphere quadratic and the dual trace of a shadow ray and a bounce ray:
// `dual_trace` through one loop over the primitive tables, or
// `dual_trace_culled`, each ray culling by the chunk boxes of the table on
// its own and the warp testing each (ray, chunk) pair together. Every
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

// Moller-Trumbore with the reference thresholds; kBig on a miss.
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

// Fold triangle f's hit of ray (o, d) into h. A strict `<`: over
// ascending f the lowest index wins a tie.
template <bool kBounce>
__device__ __forceinline__ void tri_step(const float* __restrict__ tri,
                                         const float* __restrict__ attr, int f,
                                         V3 o, V3 d, Hit* h) {
  float u, v;
  const float tm = tri_t(tri + 12 * f, o, d, &u, &v);
  if (tm < h->t) take_row<kBounce>(attr, f, tm, u, v, h);
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

// _dual_trace: nearest hits of the shadow ray A (o, la) and the bounce
// ray B (o, lb) in one pass over every triangle, then spheres.
__device__ __forceinline__ void dual_trace(
    const float* __restrict__ tri, const float* __restrict__ attr,
    const float* __restrict__ sph, int n_tri, int n_sph, V3 o, V3 la, V3 lb,
    Hit* A, Hit* B, srt::Tally& tl) {
  no_hit(A, B);
  tl.rows += 2 * (uint32_t)n_tri;
  for (int f = 0; f < n_tri; ++f) {
    tri_step<false>(tri, attr, f, o, la, A);
    tri_step<true>(tri, attr, f, o, lb, B);
  }
  merge_spheres(sph, n_sph, o, la, lb, A, B);
}

using srt::CullTables;

// Nearest triangle of one ray over the chunks whose boxes it enters, for
// the whole warp at once (trace_common.cuh warp_walk_chunks), each row
// tested with dual_trace's expressions; the winner's (u, v) are
// recomputed from its row with the same expression and its attributes
// read once, as tri_step's last improvement reads them.
template <bool kBounce>
__device__ __forceinline__ void warp_walk_ray(
    const float* __restrict__ tri, const float* __restrict__ attr, int n_tri,
    const CullTables& ct, V3 o, V3 d, bool active, srt::WarpStage& stage,
    Hit* h, srt::Tally& tl, unsigned long long& slots) {
  const srt::Ray r = {o.x, o.y, o.z, d.x, d.y, d.z};
  const srt::RowHit best = srt::warp_walk_chunks(
      r, active, ct, tri, n_tri, stage,
      [](const float* g, const srt::Ray& rl) {
        float u, v;
        return tri_t(g, V3{rl.ox, rl.oy, rl.oz}, V3{rl.dx, rl.dy, rl.dz}, &u, &v);
      },
      tl, slots);
  if (best.row >= 0) {
    float u, v;
    tri_t(tri + 12 * best.row, o, d, &u, &v);
    take_row<kBounce>(attr, best.row, best.t, u, v, h);
  }
}

// dual_trace with each ray culling for itself (the mm=True tier of the
// JAX kernel, ops/pallas_path.py:354-365: the shadow rays converge on the
// light while the bounce rays scatter, so one cull for both would keep
// the union): the shadow rays of the warp walk together, then its bounce
// rays. Equal to dual_trace lane for lane. The whole warp calls it; an
// inactive thread (not `active`) tests nothing and gets misses from the
// triangles.
__device__ __forceinline__ void dual_trace_culled(
    const float* __restrict__ tri, const float* __restrict__ attr,
    const float* __restrict__ sph, int n_tri, int n_sph, const CullTables& ct,
    V3 o, V3 la, V3 lb, bool active, srt::WarpStage& stage, Hit* A, Hit* B,
    srt::Tally& tl, unsigned long long& slots) {
  no_hit(A, B);
  warp_walk_ray<false>(tri, attr, n_tri, ct, o, la, active, stage, A, tl, slots);
  warp_walk_ray<true>(tri, attr, n_tri, ct, o, lb, active, stage, B, tl, slots);
  merge_spheres(sph, n_sph, o, la, lb, A, B);
}

__device__ __forceinline__ float len3(V3 v) {
  return sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
}

}  // namespace
