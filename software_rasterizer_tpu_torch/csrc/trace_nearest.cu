// Nearest-triangle trace kernel for Hopper (sm_90a).
//
// Replaces ops/pallas_trace.py::_vpu_trace_kernel (behind
// trace_nearest_vpu) of the JAX package: for every ray, exact
// Moller-Trumbore against every row of the [v0|e1|e2|pad] table, the
// nearest accepted t and its triangle index. Rejects |det| < 1e-6, u or v
// outside [0,1], u + v > 1 and t < 1e-6; a strict `<` keeps the lowest
// index on a tie; invalid rows are zero, so det = 0 rejects them; a miss
// gives t = 1e30 and index -1.
//
// Bound: FP32 ALU work, ~58 operations a ray and triangle; a ray is 24
// bytes in and 9 out. Design: one thread per ray, 128 threads a block.
// The ray lives in registers; every thread of a warp reads the same
// table row, so the loads broadcast, and a block first stages the table
// in dynamic shared memory when it fits 48 KB (1024 triangles of 48
// bytes; Cornell's 36 take 1.7 KB, so occupancy is not touched). No
// (rows,128) tiling and no padding of N: the last block masks its tail.
//
// The expressions are those of the plain PyTorch version, in its order;
// built with -fmad=false and without fast math, every multiply and add
// rounds on its own, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kThreads = 128;
// triangles staged in shared memory (48 KB holds 1024 rows of 12
// floats); larger tables are read through the cache
constexpr int kSharedTris = 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
trace_nearest_kernel(const float* __restrict__ tri, int n_tri,
                     const float* __restrict__ orig,
                     const float* __restrict__ dir, int n,
                     uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                     float* __restrict__ t_out) {
  extern __shared__ float s_tri[];
  const float* table = tri;
  if (kShared) {
    for (int i = threadIdx.x; i < n_tri * 12; i += kThreads) s_tri[i] = tri[i];
    __syncthreads();
    table = s_tri;
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
  const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  float best_t = kBig;
  int best_f = -1;
  for (int f = 0; f < n_tri; ++f) {
    const float* g = table + 12 * f;
    const float v0x = g[0], v0y = g[1], v0z = g[2];
    const float e1x = g[3], e1y = g[4], e1z = g[5];
    const float e2x = g[6], e2y = g[7], e2z = g[8];
    // p = d x e2
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
    const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv;
    // q = tvec x e1
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    const bool ok = fabsf(det) >= 1e-6f && u >= 0.0f && u <= 1.0f &&
                    v >= 0.0f && u + v <= 1.0f && t >= 1e-6f;
    const float tm = ok ? t : kBig;
    if (tm < best_t) {  // strict <: the lowest index wins a tie
      best_t = tm;
      best_f = f;
    }
  }
  const bool h = best_t < kBig;
  hit[r] = h ? 1 : 0;
  idx[r] = h ? (int64_t)best_f : (int64_t)-1;
  t_out[r] = best_t;
}

}  // namespace

extern "C" int srt_trace_nearest(const float* tri, int n_tri,
                                 const float* orig, const float* dir, int n,
                                 uint8_t* hit, int64_t* idx, float* t,
                                 void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tri <= kSharedTris) {
    const size_t bytes = (size_t)n_tri * 12 * sizeof(float);
    trace_nearest_kernel<true><<<blocks, kThreads, bytes, s>>>(
        tri, n_tri, orig, dir, n, hit, idx, t);
  } else {
    trace_nearest_kernel<false><<<blocks, kThreads, 0, s>>>(
        tri, n_tri, orig, dir, n, hit, idx, t);
  }
  return (int)cudaGetLastError();
}
