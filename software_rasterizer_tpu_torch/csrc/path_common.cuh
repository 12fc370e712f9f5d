// What the path-tracing kernels share (path_camera.cu, path_bounce.cu):
// constants, the 3-vector, _norm3, Tools::toWorld, Moller-Trumbore, the
// sphere quadratic and the dual trace of a shadow ray and a bounce ray
// through one loop over the primitive tables. Every expression is written
// in the order of the plain PyTorch versions; build with -fmad=false and
// without fast math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// _dual_trace: nearest hits of the shadow ray A (o, la) and the bounce
// ray B (o, lb) in one pass over triangles, then spheres. A strict `<`
// keeps the lowest index on a tie, and triangles ahead of spheres.
__device__ __forceinline__ void dual_trace(
    const float* __restrict__ tri, const float* __restrict__ attr,
    const float* __restrict__ sph, int n_tri, int n_sph, V3 o, V3 la, V3 lb,
    Hit* A, Hit* B) {
  *A = {kBig, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, false};
  *B = *A;
  for (int f = 0; f < n_tri; ++f) {
    const float* g = tri + 12 * f;
    const float* at = attr + 16 * f;
    V3 e1 = {g[3], g[4], g[5]};
    V3 e2 = {g[6], g[7], g[8]};
    V3 tv = {o.x - g[0], o.y - g[1], o.z - g[2]};
    V3 q = {tv.y * e1.z - tv.z * e1.y, tv.z * e1.x - tv.x * e1.z,
            tv.x * e1.y - tv.y * e1.x};
    float u, v;
    float tm = mt(la, tv, q, e1, e2, &u, &v);
    if (tm < A->t) {
      float w = 1.0f - u - v;
      A->t = tm;
      A->nrm = {w * at[0] + u * at[3] + v * at[6],
                w * at[1] + u * at[4] + v * at[7],
                w * at[2] + u * at[5] + v * at[8]};
      A->emit = {at[12], at[13], at[14]};
    }
    tm = mt(lb, tv, q, e1, e2, &u, &v);
    if (tm < B->t) {
      float w = 1.0f - u - v;
      B->t = tm;
      B->nrm = {w * at[0] + u * at[3] + v * at[6],
                w * at[1] + u * at[4] + v * at[7],
                w * at[2] + u * at[5] + v * at[8]};
      B->kd = {at[9], at[10], at[11]};
      B->emit = {at[12], at[13], at[14]};
      B->is_sphere = false;
    }
  }
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

__device__ __forceinline__ float len3(V3 v) {
  return sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
}

}  // namespace
