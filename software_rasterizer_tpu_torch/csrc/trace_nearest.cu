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
// Bound: FP32 ALU work, ~58 operations a ray and triangle (28 of them in
// stage 1 below, the rest only where stage 1 passes); a ray is 24 bytes in
// and 13 out. Built without FMAs (-fmad=false), the one-stage test was ~80
// issue slots a ray and row, so the kernel sits at its issue floor.
// Design: 128 threads a block, each holding kRays rays in registers (ray
// tid + j * 128 of its block, so a ray slot's warp holds 32 consecutive
// rays, which see the same rows pass and fail together). A row is read
// once into registers as three float4 for every slot; every thread of a
// warp reads the same row, so the loads broadcast. A block first stages
// the table in dynamic shared memory when it fits 48 KB (1024 triangles of
// 48 bytes; Cornell's 36 take 1.7 KB), else reads it through the cache.
// Each (ray, row) pair is tested in two stages with one warp vote between
// them (trace_common.cuh mt_stage1 / mt_stage2, the proof beside them):
// most pairs fail on |det| or u, and a warp whose lanes all fail skips the
// rest of the test. Rays past N are absent rays with d = 0 (every det is
// 0, so they pass no stage 1 and hit nothing) and take part in every vote.
//
// Built with -fmad=false and without fast math, every multiply and add
// rounds on its own, so the kernel and its plain PyTorch version agree bit
// for bit.

#include "trace_common.cuh"

namespace {

using srt::kBig;
using srt::kFullMask;
constexpr int kThreads = 128;
// triangles staged in shared memory (48 KB holds 1024 rows of 12
// floats); larger tables are read through the cache
constexpr int kSharedTris = 1024;
// ray slots a thread (ops/trace_kernel.NEAREST_RAYS); a tuning value that
// changes no result
constexpr int kRays = 2;

template <bool kShared, bool kCount>
__global__ void __launch_bounds__(kThreads)
trace_nearest_kernel(const float* __restrict__ tri, int n_tri,
                     const float* __restrict__ orig,
                     const float* __restrict__ dir, int n,
                     uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                     float* __restrict__ t_out, unsigned long long* __restrict__ tally) {
  extern __shared__ float4 s_tri[];
  const float4* table = reinterpret_cast<const float4*>(tri);
  if (kShared) {
    for (int i = threadIdx.x; i < n_tri * 3; i += kThreads) s_tri[i] = table[i];
    __syncthreads();
    table = s_tri;
  }
  const int base = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  srt::Ray ray[kRays];
  bool active[kRays];
  float best_t[kRays];
  int best_f[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int r = base + j * kThreads;
    active[j] = r < n;
    // an absent ray has d = 0: every det is 0, it hits nothing
    const size_t s = active[j] ? (size_t)3 * r : 0;
    ray[j].ox = active[j] ? orig[s] : 0.0f;
    ray[j].oy = active[j] ? orig[s + 1] : 0.0f;
    ray[j].oz = active[j] ? orig[s + 2] : 0.0f;
    ray[j].dx = active[j] ? dir[s] : 0.0f;
    ray[j].dy = active[j] ? dir[s + 1] : 0.0f;
    ray[j].dz = active[j] ? dir[s + 2] : 0.0f;
    best_t[j] = kBig;
    best_f[j] = -1;
  }
  srt::VoteTally tl;
  for (int f = 0; f < n_tri; ++f) {
    // the row in registers once for every slot: three 16-byte loads
    const float4 ra = table[3 * f], rb = table[3 * f + 1], rc = table[3 * f + 2];
    const float g[12] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w,
                         rc.x, rc.y, rc.z, rc.w};
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      const srt::Stage1 st = srt::mt_stage1(ray[j], g);
      const bool any = __any_sync(kFullMask, st.pass);
      if (kCount) tl.step(any, active[j], st.pass);
      if (any) {
        const float tm = srt::mt_stage2(ray[j], g, st);
        if (tm < best_t[j]) {  // strict <: the lowest index wins a tie
          best_t[j] = tm;
          best_f[j] = f;
        }
      }
    }
  }
  if (kCount) tl.flush(tally);
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    if (!active[j]) continue;
    const int r = base + j * kThreads;
    const bool h = best_t[j] < kBig;
    hit[r] = h ? 1 : 0;
    idx[r] = h ? (int64_t)best_f[j] : (int64_t)-1;
    t_out[r] = best_t[j];
  }
}

template <bool kCount>
int launch(const float* tri, int n_tri, const float* orig, const float* dir, int n,
           uint8_t* hit, int64_t* idx, float* t, unsigned long long* tally,
           cudaStream_t s) {
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  if (n_tri <= kSharedTris) {
    const size_t bytes = (size_t)n_tri * 12 * sizeof(float);
    trace_nearest_kernel<true, kCount><<<blocks, kThreads, bytes, s>>>(
        tri, n_tri, orig, dir, n, hit, idx, t, tally);
  } else {
    trace_nearest_kernel<false, kCount><<<blocks, kThreads, 0, s>>>(
        tri, n_tri, orig, dir, n, hit, idx, t, tally);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Ray slots a thread: the warps' layout, which the plain model of the
// tally needs (ops/trace_tiers.nearest_tally_plain).
extern "C" int srt_trace_nearest_rays() { return kRays; }

// `tri` 16-byte aligned; adds the kernel's work to `tally`
// (srt::kTallyEntries unsigned 64-bit totals) unless it is null. Returns
// cudaGetLastError() of the launch.
extern "C" int srt_trace_nearest(const float* tri, int n_tri,
                                 const float* orig, const float* dir, int n,
                                 uint8_t* hit, int64_t* idx, float* t,
                                 unsigned long long* tally, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return tally != nullptr ? launch<true>(tri, n_tri, orig, dir, n, hit, idx, t, tally, s)
                          : launch<false>(tri, n_tri, orig, dir, n, hit, idx, t, tally, s);
}
