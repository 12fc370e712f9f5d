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
// The test of one ray against one row is trace_common.cuh's mt_test: the
// expressions of the plain PyTorch version, in its order; built with
// -fmad=false and without fast math, every multiply and add rounds on
// its own, so the two agree bit for bit.

#include "trace_common.cuh"

namespace {

using srt::kBig;
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
  const srt::Ray ray = {orig[3 * r], orig[3 * r + 1], orig[3 * r + 2],
                        dir[3 * r],  dir[3 * r + 1],  dir[3 * r + 2]};
  float best_t = kBig;
  int best_f = -1;
  for (int f = 0; f < n_tri; ++f) {
    const float tm = srt::mt_test(ray, table + 12 * f);
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
