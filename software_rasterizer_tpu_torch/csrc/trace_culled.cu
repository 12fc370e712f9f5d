// Chunk-culled nearest-triangle kernels for Hopper (sm_90a): the
// large-scene tiers behind nearest_hit.
//
// Four kernels, replacing four Pallas kernels of the JAX package's
// ops/pallas_trace.py:
//   cull_prepass_kernel         _cull_prepass_kernel  (a (nb, nc) mask)
//   trace_listed_kernel         _trace_kernel2        (lists, resident table)
//   trace_listed_stream_kernel  _trace_kernel3        (lists, table streamed)
//   trace_fused_cull_kernel     _trace_kernel2c       (two-level cull fused in)
//
// The triangles are the [v0|e1|e2|pad] rows of kernel trace_nearest.cu, in
// BVH leaf order, cut into chunks of `chunk` rows with one box a chunk.
// The rays are cut into blocks of `block` consecutive rays. A ray block
// visits a chunk iff at least one of its rays passes the slab test of the
// chunk's box; the test is conservative, so the nearest hit over the
// visited chunks is the nearest hit over the table. Per ray: the smallest
// accepted t, the lowest row index among equal t (chunks and rows are
// walked in ascending order under a strict <), t = 1e30 and index -1 on a
// miss. The Pallas kernels' bilinear matmul form, coefficient layouts and
// mask bit plane are TPU form, not semantics: every (ray, row) test here
// is trace_common.cuh's mt_test, so all tiers equal the unculled sweep
// bit for bit.
//
// Bound: FP32 ALU work, ~58 operations a (ray, row) test and ~21 a slab
// test; the bytes (24 in and 13 out a ray, 48 a row) are far below it.
// Design: one CUDA block a ray block. A thread owns up to kMaxRays rays
// of its block (ray tid + j * blockDim.x), held in registers with their
// running best. A visited chunk is staged in shared memory once for the
// whole block; every thread then reads the same row, so the loads
// broadcast and a row is reused for all of a thread's rays. Votes are
// __syncthreads_or; a thread with no ray (the tail of the last block)
// stays in every barrier and never votes.

#include <cuda_pipeline.h>

#include "trace_common.cuh"

namespace {

using srt::InvDir;
using srt::kBig;
using srt::Ray;

constexpr int kMaxChunk = 256;   // rows of a chunk staged in shared memory
constexpr int kMaxThreads = 256;
constexpr int kMaxRays = 8;      // rays a thread, so block <= 2048
constexpr int kSuper = 8;        // chunks a super-chunk (MM2C_SUPER)
constexpr int kMaskTile = 1024;  // chunk flags of the prepass in shared memory

// A thread's rays and their running best.
template <int R>
struct Lanes {
  Ray ray[R];
  InvDir inv[R];
  bool active[R];
  float best_t[R];
  int best_f[R];

  __device__ __forceinline__ void load(const float* __restrict__ orig,
                                       const float* __restrict__ dir, int n,
                                       int block) {
    const int base = blockIdx.x * block;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int local = threadIdx.x + j * blockDim.x;
      const int r = base + local;
      active[j] = local < block && r < n;
      // an absent ray has d = 0: every det is 0, it hits nothing
      const size_t s = active[j] ? (size_t)3 * r : 0;
      ray[j].ox = active[j] ? orig[s] : 0.0f;
      ray[j].oy = active[j] ? orig[s + 1] : 0.0f;
      ray[j].oz = active[j] ? orig[s + 2] : 0.0f;
      ray[j].dx = active[j] ? dir[s] : 0.0f;
      ray[j].dy = active[j] ? dir[s + 1] : 0.0f;
      ray[j].dz = active[j] ? dir[s + 2] : 0.0f;
      inv[j] = srt::inv_dir(ray[j]);
      best_t[j] = kBig;
      best_f[j] = -1;
    }
  }

  // does any ray of this thread enter the box
  __device__ __forceinline__ bool enters(const float* __restrict__ lo,
                                         const float* __restrict__ hi) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j)
      any = any || (active[j] && srt::slab_enter(ray[j], inv[j], lo, hi));
    return any;
  }

  // sweep `rows` staged rows whose first global index is `first`
  __device__ __forceinline__ void sweep(const float* __restrict__ s_rows,
                                        int rows, int first) {
    for (int f = 0; f < rows; ++f) {
      const float* g = s_rows + 12 * f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float tm = srt::mt_test(ray[j], g);
        if (tm < best_t[j]) {  // strict <: the lowest index wins a tie
          best_t[j] = tm;
          best_f[j] = first + f;
        }
      }
    }
  }

  __device__ __forceinline__ void store(int n, int block,
                                        uint8_t* __restrict__ hit,
                                        int64_t* __restrict__ idx,
                                        float* __restrict__ t_out) const {
    const int base = blockIdx.x * block;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!active[j]) continue;
      const int r = base + threadIdx.x + j * blockDim.x;
      const bool h = best_t[j] < kBig;
      hit[r] = h ? 1 : 0;
      idx[r] = h ? (int64_t)best_f[j] : (int64_t)-1;
      t_out[r] = best_t[j];
    }
  }
};

// rows of chunk c that lie inside the table
__device__ __forceinline__ int chunk_rows(int c, int chunk, int n_rows) {
  const int left = n_rows - c * chunk;
  return left < chunk ? (left < 0 ? 0 : left) : chunk;
}

// copy chunk c's rows into shared memory (every thread of the block)
__device__ __forceinline__ void stage(float* __restrict__ s_rows,
                                      const float* __restrict__ tri, int c,
                                      int chunk, int rows) {
  const float4* src = reinterpret_cast<const float4*>(tri + (size_t)c * chunk * 12);
  float4* dst = reinterpret_cast<float4*>(s_rows);
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x) dst[i] = src[i];
}

// ---- the (nb, nc) mask: any ray of block b enters chunk c's box
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
cull_prepass_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                    int nc, const float* __restrict__ orig,
                    const float* __restrict__ dir, int n, int block,
                    uint8_t* __restrict__ mask) {
  __shared__ uint8_t s_flag[kMaskTile];
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  uint8_t* row = mask + (size_t)blockIdx.x * nc;
  for (int c0 = 0; c0 < nc; c0 += kMaskTile) {
    const int tile = min(kMaskTile, nc - c0);
    for (int i = threadIdx.x; i < tile; i += blockDim.x) s_flag[i] = 0;
    __syncthreads();
    for (int i = 0; i < tile; ++i) {
      const int c = c0 + i;
      const bool e = lanes.enters(lo + 3 * c, hi + 3 * c);
      // one writer a warp; every writer stores the same 1
      if (__any_sync(0xffffffffu, e) && (threadIdx.x & 31) == 0) s_flag[i] = 1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) row[c0 + i] = s_flag[i];
    __syncthreads();
  }
}

// ---- the listed chunks of each block, the table read chunk by chunk
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
trace_listed_kernel(const float* __restrict__ tri, int n_rows, int chunk,
                    const int* __restrict__ counts,
                    const int* __restrict__ lists, long long list_stride,
                    const float* __restrict__ orig,
                    const float* __restrict__ dir, int n, int block,
                    uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                    float* __restrict__ t_out) {
  __shared__ __align__(16) float s_rows[kMaxChunk * 12];
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  const int cnt = counts[blockIdx.x];
  const int* list = lists + (size_t)blockIdx.x * list_stride;
  for (int i = 0; i < cnt; ++i) {
    const int c = list[i];
    const int rows = chunk_rows(c, chunk, n_rows);
    __syncthreads();  // the last sweep has left the buffer
    stage(s_rows, tri, c, chunk, rows);
    __syncthreads();
    lanes.sweep(s_rows, rows, c * chunk);
  }
  lanes.store(n, block, hit, idx, t_out);
}

// ---- the same, the next listed chunk fetched with cp.async into the other
// half of a double buffer while the current one is swept
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
trace_listed_stream_kernel(const float* __restrict__ tri, int n_rows, int chunk,
                           const int* __restrict__ counts,
                           const int* __restrict__ lists, long long list_stride,
                           const float* __restrict__ orig,
                           const float* __restrict__ dir, int n, int block,
                           uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                           float* __restrict__ t_out) {
  __shared__ __align__(16) float s_rows[2][kMaxChunk * 12];
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  const int cnt = counts[blockIdx.x];
  const int* list = lists + (size_t)blockIdx.x * list_stride;

  auto fetch = [&](int i) {
    const int c = list[i];
    const int rows = chunk_rows(c, chunk, n_rows);
    const float4* src = reinterpret_cast<const float4*>(tri + (size_t)c * chunk * 12);
    float4* dst = reinterpret_cast<float4*>(s_rows[i & 1]);
    for (int k = threadIdx.x; k < rows * 3; k += blockDim.x)
      __pipeline_memcpy_async(dst + k, src + k, sizeof(float4));
    __pipeline_commit();
  };

  if (cnt > 0) fetch(0);
  for (int i = 0; i < cnt; ++i) {
    const bool more = i + 1 < cnt;
    if (more) fetch(i + 1);
    if (more) {
      __pipeline_wait_prior(1);  // chunk i has landed, i + 1 may be in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int c = list[i];
    lanes.sweep(s_rows[i & 1], chunk_rows(c, chunk, n_rows), c * chunk);
    __syncthreads();  // the buffer is free for chunk i + 2
  }
  lanes.store(n, block, hit, idx, t_out);
}

// ---- no mask and no lists: a vote on each super-chunk's box, then on each
// of its chunks' boxes, then the sweep
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
trace_fused_cull_kernel(const float* __restrict__ tri, int n_rows, int chunk,
                        const float* __restrict__ lo, const float* __restrict__ hi,
                        int nc, const float* __restrict__ lo2,
                        const float* __restrict__ hi2, int nsc,
                        const float* __restrict__ orig,
                        const float* __restrict__ dir, int n, int block,
                        uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                        float* __restrict__ t_out) {
  __shared__ __align__(16) float s_rows[kMaxChunk * 12];
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  for (int sc = 0; sc < nsc; ++sc) {
    if (!__syncthreads_or(lanes.enters(lo2 + 3 * sc, hi2 + 3 * sc))) continue;
    const int end = min((sc + 1) * kSuper, nc);
    for (int c = sc * kSuper; c < end; ++c) {
      // the vote is a barrier: the last sweep has left the buffer
      if (!__syncthreads_or(lanes.enters(lo + 3 * c, hi + 3 * c))) continue;
      const int rows = chunk_rows(c, chunk, n_rows);
      stage(s_rows, tri, c, chunk, rows);
      __syncthreads();
      lanes.sweep(s_rows, rows, c * chunk);
    }
  }
  lanes.store(n, block, hit, idx, t_out);
}

// threads of a CUDA block and rays a thread for a ray block of `block`
// rays; false if the block is not a multiple of 32 in 32..2048
bool launch_shape(int block, int* threads, int* rays) {
  if (block < 32 || block % 32 != 0 || block > kMaxThreads * kMaxRays) return false;
  *threads = block < kMaxThreads ? block : kMaxThreads;
  const int r = (block + *threads - 1) / *threads;
  *rays = r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : 8;
  return true;
}

}  // namespace

// Every entry returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a shape the kernels do not take.

#define SRT_DISPATCH_RAYS(rays, KERNEL, ...)                              \
  switch (rays) {                                                         \
    case 1: KERNEL<1><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;     \
    case 2: KERNEL<2><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;     \
    case 4: KERNEL<4><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;     \
    default: KERNEL<8><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;    \
  }

extern "C" int srt_cull_prepass(const float* lo, const float* hi, int nc,
                                const float* orig, const float* dir, int n,
                                int block, uint8_t* mask, void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays) || nc < 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || nc == 0) return 0;
  const int blocks = (n + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  SRT_DISPATCH_RAYS(rays, cull_prepass_kernel, lo, hi, nc, orig, dir, n, block, mask)
  return (int)cudaGetLastError();
}

extern "C" int srt_trace_listed(const float* tri, int n_rows, int chunk,
                                const int* counts, const int* lists,
                                long long list_stride, const float* orig,
                                const float* dir, int n, int block, int stream_rows,
                                uint8_t* hit, int64_t* idx, float* t, void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays) || chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  if (stream_rows) {
    SRT_DISPATCH_RAYS(rays, trace_listed_stream_kernel, tri, n_rows, chunk, counts,
                      lists, list_stride, orig, dir, n, block, hit, idx, t)
  } else {
    SRT_DISPATCH_RAYS(rays, trace_listed_kernel, tri, n_rows, chunk, counts, lists,
                      list_stride, orig, dir, n, block, hit, idx, t)
  }
  return (int)cudaGetLastError();
}

extern "C" int srt_trace_fused_cull(const float* tri, int n_rows, int chunk,
                                    const float* lo, const float* hi, int nc,
                                    const float* lo2, const float* hi2, int nsc,
                                    const float* orig, const float* dir, int n,
                                    int block, uint8_t* hit, int64_t* idx, float* t,
                                    void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays) || chunk < 1 || chunk > kMaxChunk ||
      nsc != (nc + kSuper - 1) / kSuper)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  SRT_DISPATCH_RAYS(rays, trace_fused_cull_kernel, tri, n_rows, chunk, lo, hi, nc,
                    lo2, hi2, nsc, orig, dir, n, block, hit, idx, t)
  return (int)cudaGetLastError();
}
