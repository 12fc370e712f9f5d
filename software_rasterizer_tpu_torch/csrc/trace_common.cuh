// What the nearest-hit kernels share: the Moller-Trumbore test of one ray
// against one [v0|e1|e2|pad] table row, and the ray-box slab test.
//
// Both are the expressions of the plain PyTorch versions in their order.
// Built with -fmad=false and without fast math, every multiply and add
// rounds on its own, so a kernel and its plain version agree bit for bit,
// and every kernel that sweeps the same rows picks the same winner.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

constexpr float kBig = 1e30f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// t of the hit of `r` with the row `g`, or kBig. Rejects |det| < 1e-6, u
// or v outside [0,1], u + v > 1 and t < 1e-6; a zero row has det = 0; a
// NaN makes every comparison false, so a NaN ray misses.
__device__ __forceinline__ float mt_test(const Ray& r, const float* __restrict__ g) {
  const float v0x = g[0], v0y = g[1], v0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  // p = d x e2
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  // q = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool ok = fabsf(det) >= 1e-6f && u >= 0.0f && u <= 1.0f &&
                  v >= 0.0f && u + v <= 1.0f && t >= 1e-6f;
  return ok ? t : kBig;
}

// min and max that hand a NaN on, as torch.minimum / torch.maximum do
// (fminf / fmaxf drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// 1 / d with a zero component replaced by 1e-30, per axis
struct InvDir {
  float x, y, z;
};
__device__ __forceinline__ InvDir inv_dir(const Ray& r) {
  InvDir i;
  i.x = 1.0f / (r.dx == 0.0f ? 1e-30f : r.dx);
  i.y = 1.0f / (r.dy == 0.0f ? 1e-30f : r.dy);
  i.z = 1.0f / (r.dz == 0.0f ? 1e-30f : r.dz);
  return i;
}

// The conservative slab test: does the ray meet the box [lo, hi] at some
// t >= 0 (t_exit >= max(t_enter, 0)). lo and hi point at 3 floats each.
__device__ __forceinline__ bool slab_enter(const Ray& r, const InvDir& i,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi) {
  float t0 = (lo[0] - r.ox) * i.x;
  float t1 = (hi[0] - r.ox) * i.x;
  float tmin = nan_min(t0, t1);
  float tmax = nan_max(t0, t1);
  t0 = (lo[1] - r.oy) * i.y;
  t1 = (hi[1] - r.oy) * i.y;
  tmin = nan_max(tmin, nan_min(t0, t1));
  tmax = nan_min(tmax, nan_max(t0, t1));
  t0 = (lo[2] - r.oz) * i.z;
  t1 = (hi[2] - r.oz) * i.z;
  tmin = nan_max(tmin, nan_min(t0, t1));
  tmax = nan_min(tmax, nan_max(t0, t1));
  return tmax >= nan_max(tmin, 0.0f);
}

}  // namespace srt
