// Chunked nearest-triangle kernels for Hopper (sm_90a): the large-scene
// tiers behind nearest_hit.
//
// Five kernels, replacing five Pallas kernels of the JAX package's
// ops/pallas_trace.py:
//   cull_prepass_kernel         _cull_prepass_kernel  (a (nb, nc) mask)
//   trace_listed_kernel         _trace_kernel2        (lists, resident table)
//   trace_listed_stream_kernel  _trace_kernel3        (lists, table streamed)
//   trace_fused_cull_kernel     _trace_kernel2c       (two-level cull fused in)
//   trace_unculled_kernel       _trace_kernel         (every chunk, no boxes)
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
// is trace_common.cuh's mt_test or its two-stage form below, so all tiers
// equal the unculled sweep bit for bit.
//
// Bound: FP32 ALU work, ~58 operations a (ray, row) test and ~21 a slab
// test; the bytes (24 in and 13 out a ray, 48 a row) are far below it.
// Built without FMAs (-fmad=false), a test is ~80 issue slots, so the
// kernels sit near their issue floor, not their memory.
// Design: one CUDA block a ray block. A thread owns up to kMaxRays rays
// of its block (ray tid + j * blockDim.x), held in registers with their
// running best. In #4, #5 and #7 a visited chunk is staged in shared
// memory once for the whole block; every thread then reads the same row,
// so the loads broadcast and a row is reused for all of a thread's rays.
// Votes are __syncthreads_or; a thread with no ray (the tail of the last
// block) stays in every barrier and never votes.
//
// #6 and #8 test in two stages with a warp vote (Lanes::sweep_voted): most
// (ray, row) pairs fail on |det| or u, and when every lane of a warp fails
// there, the warp skips the rest of the test. #6 also votes per warp on
// each listed chunk's box, and each of its warps walks its block's list
// on its own, staging its rows in a double buffer of its own.

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
constexpr unsigned kFull = 0xffffffffu;
// Rows of a slice staged at a time: by each warp of #6 into its own double
// buffer (2 x kSliceListed x 48 bytes a warp), by the block of #8 into one
// shared double buffer (2 x kSliceMM x 48 bytes). Tuning values that change
// no result. On an H100, 1M camera rays: #6 at 147,456 triangles took about
// the same at 32 and 64 rows and 19% more at 128 (18 warps an SM, not 36);
// #8 at 9,216 the same at 128, 256 and 512.
constexpr int kSliceListed = 64;
constexpr int kSliceMM = 256;

// ---- the two-stage Moller-Trumbore test of #6 and #8
//
// Stage 1 computes p, det, inv, tvec and u with mt_test's expressions in
// mt_test's order (trace_common.cuh), and its predicate `pass` is the
// first three terms of mt_test's `ok`: |det| >= 1e-6, u >= 0, u <= 1. The
// warp votes on `pass`; stage 2 (q, v, t and the rest of `ok`) runs only
// if some lane passed. Why the result is mt_test's bit for bit:
//   * `ok` is a conjunction that starts with `pass`, so a lane that fails
//     `pass` gets kBig from mt_test whatever v and t are, and kBig never
//     replaces a running best under the strict < (best_t <= kBig). Such a
//     lane leaves its best alone here too: in a warp that skips stage 2,
//     and in one that runs it, where `ok` is `pass && ...` again;
//   * a lane that passes runs stage 2 on stage 1's own det, inv, tvec and
//     u, so every value it computes is mt_test's: the same expressions in
//     the same order, each multiply and add rounded on its own
//     (-fmad=false), the IEEE 1.0f / det before u as in mt_test;
//   * NaN: a NaN in u or det makes `pass` false (every comparison with a
//     NaN is false), as it makes `ok` false; a zero row has det = 0, an
//     absent ray (d = 0) too; det at exactly +-1e-6 passes in both, as
//     fabsf(det) >= 1e-6f is the same comparison.
// So the winners equal mt_test's sweep, the plain versions and kernel #2.
struct Stage1 {
  float px, py, pz, inv, tx, ty, tz, u;
  bool pass;
};

__device__ __forceinline__ Stage1 mt_stage1(const Ray& r, const float* __restrict__ g) {
  const float v0x = g[0], v0y = g[1], v0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  Stage1 s;
  s.px = r.dy * e2z - r.dz * e2y;
  s.py = r.dz * e2x - r.dx * e2z;
  s.pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * s.px + e1y * s.py + e1z * s.pz;
  s.inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
  s.tx = r.ox - v0x;
  s.ty = r.oy - v0y;
  s.tz = r.oz - v0z;
  s.u = (s.tx * s.px + s.ty * s.py + s.tz * s.pz) * s.inv;
  s.pass = fabsf(det) >= 1e-6f && s.u >= 0.0f && s.u <= 1.0f;
  return s;
}

// t of the hit, or kBig: the rest of mt_test after stage 1
__device__ __forceinline__ float mt_stage2(const Ray& r, const float* __restrict__ g,
                                           const Stage1& s) {
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  // q = tvec x e1
  const float qx = s.ty * e1z - s.tz * e1y;
  const float qy = s.tz * e1x - s.tx * e1z;
  const float qz = s.tx * e1y - s.ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * s.inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * s.inv;
  const bool ok = s.pass && v >= 0.0f && s.u + v <= 1.0f && t >= 1e-6f;
  return ok ? t : kBig;
}

// The work #6 and #8 count when the caller passes a tally (kTallyEntries
// unsigned 64-bit totals, ops/trace_tiers.TALLY_NAMES): warp-steps (one
// warp, one row, one ray slot j), the warp-steps whose vote passed (stage 2
// ran), the active rays' (ray, row) tests, those of them in voted steps
// (full tests), the active rays' slab tests (#6), the (warp, listed
// chunk) pairs of #6 with those the warp skipped (no active ray of it
// enters the box), and the tests whose own stage 1 passed. A thread counts
// its own; the warp sums them at the end.
constexpr int kTallyEntries = 8;
struct VoteTally {
  uint32_t steps = 0, voted = 0, tests = 0, full = 0, slabs = 0, pairs = 0, skipped = 0,
           passes = 0;
  __device__ __forceinline__ void flush(unsigned long long* total) const {
    // warp-uniform counts are the same in every lane: lane 0 adds its own
    const uint32_t tests_w = __reduce_add_sync(kFull, tests);
    const uint32_t full_w = __reduce_add_sync(kFull, full);
    const uint32_t slabs_w = __reduce_add_sync(kFull, slabs);
    const uint32_t passes_w = __reduce_add_sync(kFull, passes);
    if ((threadIdx.x & 31) != 0) return;
    const uint32_t v[kTallyEntries] = {steps,   voted, tests_w, full_w,
                                       slabs_w, pairs, skipped, passes_w};
#pragma unroll
    for (int k = 0; k < kTallyEntries; ++k)
      if (v[k]) atomicAdd(total + k, (unsigned long long)v[k]);
  }
};

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

  // `rows` staged rows whose first global index is `first`, each tested
  // in two stages with a warp vote for each ray slot j (the whole warp
  // calls this together). With kCount, `tl` gets the steps and tests.
  template <bool kCount>
  __device__ __forceinline__ void sweep_voted(const float* __restrict__ s_rows,
                                              int rows, int first, VoteTally& tl) {
    for (int f = 0; f < rows; ++f) {
      // the row in registers once for every slot: three 16-byte loads
      const float4* r4 = reinterpret_cast<const float4*>(s_rows) + 3 * f;
      const float4 ra = r4[0], rb = r4[1], rc = r4[2];
      const float g[12] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w,
                           rc.x, rc.y, rc.z, rc.w};
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const Stage1 st = mt_stage1(ray[j], g);
        const bool any = __any_sync(kFull, st.pass);
        if (kCount) {
          tl.steps += 1;
          tl.voted += any;
          tl.tests += active[j];
          tl.full += any && active[j];
          tl.passes += st.pass && active[j];
        }
        if (any) {
          const float tm = mt_stage2(ray[j], g, st);
          if (tm < best_t[j]) {  // strict <: the lowest index wins a tie
            best_t[j] = tm;
            best_f[j] = first + f;
          }
        }
      }
    }
  }

  // does any active ray of this thread enter the box; every active ray
  // makes its slab test (counted in `tl`)
  template <bool kCount>
  __device__ __forceinline__ bool enters_each(const float* __restrict__ lo,
                                              const float* __restrict__ hi,
                                              VoteTally& tl) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!active[j]) continue;
      if (kCount) tl.slabs += 1;
      any = srt::slab_enter(ray[j], inv[j], lo, hi) || any;
    }
    return any;
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

// ---- the listed chunks of each block, each warp on its own: a vote of
// the warp's rays on each listed chunk's box, and the rows of the chunks
// it enters streamed slice by slice with cp.async into the warp's own
// double buffer, the next slice in flight while the current one is swept.
//
// The prepass (#5) lists a chunk for a ray block when some ray of the block
// enters its box; a warp none of whose rays enters it cannot hit a row of
// it (the slab test is conservative, and it is the prepass's own test), so
// skipping it changes no winner. A warp keeps its chunks in list order and
// its rows ascending, so the strict < still keeps the lowest row on a tie.
// No block barrier: a warp that skips a chunk goes straight on to the next.

// A warp's staging area: two slices of kSliceListed 48-byte rows.
struct ListedStage {
  float4 rows[2][kSliceListed * 3];
};

// rows [f0, f0 + cnt) of the table, staged by one warp
struct RowSlice {
  int f0, cnt;
};

// the warp's position in its block's list: entry i, rows [f, f_end) of
// its chunk not yet staged
struct ListCursor {
  int i, f, f_end;
};

template <int R, bool kCount>
__device__ __forceinline__ bool listed_next(Lanes<R>& lanes, const int* __restrict__ list,
                                            int cnt, const float* __restrict__ lo,
                                            const float* __restrict__ hi, int chunk,
                                            int n_rows, ListCursor& cur, RowSlice& item,
                                            VoteTally& tl) {
  while (true) {
    if (cur.f < cur.f_end) {
      item.f0 = cur.f;
      item.cnt = min(kSliceListed, cur.f_end - cur.f);
      cur.f += kSliceListed;
      return true;
    }
    if (++cur.i >= cnt) return false;
    const int c = list[cur.i];
    const bool e = lanes.template enters_each<kCount>(lo + 3 * c, hi + 3 * c, tl);
    const bool any = __any_sync(kFull, e);
    if (kCount) {
      tl.pairs += 1;
      tl.skipped += !any;
    }
    if (!any) continue;
    cur.f = c * chunk;
    cur.f_end = min((c + 1) * chunk, n_rows);
  }
}

__device__ __forceinline__ void listed_stage(float4* __restrict__ dst,
                                             const float* __restrict__ tri,
                                             const RowSlice& item, int lane) {
  const float4* src = reinterpret_cast<const float4*>(tri + (size_t)item.f0 * 12);
  for (int k = lane; k < item.cnt * 3; k += 32)
    __pipeline_memcpy_async(dst + k, src + k, sizeof(float4));
}

template <int R, bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
trace_listed_stream_kernel(const float* __restrict__ tri, int n_rows, int chunk,
                           const float* __restrict__ lo, const float* __restrict__ hi,
                           const int* __restrict__ counts,
                           const int* __restrict__ lists, long long list_stride,
                           const float* __restrict__ orig,
                           const float* __restrict__ dir, int n, int block,
                           uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                           float* __restrict__ t_out,
                           unsigned long long* __restrict__ tally) {
  extern __shared__ float4 s_listed[];
  ListedStage& stage = reinterpret_cast<ListedStage*>(s_listed)[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  VoteTally tl;
  const int cnt = counts[blockIdx.x];
  const int* list = lists + (size_t)blockIdx.x * list_stride;
  ListCursor cur = {-1, 0, 0};
  RowSlice item, next;
  bool have = listed_next<R, kCount>(lanes, list, cnt, lo, hi, chunk, n_rows, cur, item, tl);
  if (have) listed_stage(stage.rows[0], tri, item, lane);
  __pipeline_commit();
  for (int k = 0; have; ++k) {
    const bool more =
        listed_next<R, kCount>(lanes, list, cnt, lo, hi, chunk, n_rows, cur, next, tl);
    if (more) listed_stage(stage.rows[(k + 1) & 1], tri, next, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // item's rows have landed; next's may fly
    __syncwarp();
    lanes.template sweep_voted<kCount>(reinterpret_cast<const float*>(stage.rows[k & 1]),
                                       item.cnt, item.f0, tl);
    __syncwarp();  // every thread has left this buffer before it is refilled
    item = next;
    have = more;
  }
  if (kCount) tl.flush(tally);
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

// ---- no boxes and no lists: every row of the table swept by every ray of
// the block (the JAX kernel's (ray block, chunk) grid, its chunk axis a
// loop), in slices of kSliceMM rows double-buffered with cp.async, each
// row tested in two stages with a warp vote. Only rows beyond n_tri
// differ from kernel trace_nearest.cu's sweep, and those are zero rows
// that det = 0 rejects, so the two agree bit for bit. The slices are the
// kernel's own staging unit: like the JAX kernel's `chunk`, they change
// the order of no row.
template <int R, bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
trace_unculled_kernel(const float* __restrict__ tri, int n_rows,
                      const float* __restrict__ orig,
                      const float* __restrict__ dir, int n, int block,
                      uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                      float* __restrict__ t_out, unsigned long long* __restrict__ tally) {
  __shared__ __align__(16) float s_rows[2][kSliceMM * 12];
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  VoteTally tl;
  const int ns = (n_rows + kSliceMM - 1) / kSliceMM;
  auto fetch = [&](int i) {
    const int rows = chunk_rows(i, kSliceMM, n_rows);
    const float4* src = reinterpret_cast<const float4*>(tri + (size_t)i * kSliceMM * 12);
    float4* dst = reinterpret_cast<float4*>(s_rows[i & 1]);
    for (int k = threadIdx.x; k < rows * 3; k += blockDim.x)
      __pipeline_memcpy_async(dst + k, src + k, sizeof(float4));
    __pipeline_commit();
  };
  if (ns > 0) fetch(0);
  for (int i = 0; i < ns; ++i) {
    if (i + 1 < ns) {
      fetch(i + 1);
      __pipeline_wait_prior(1);  // slice i has landed, i + 1 may be in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    lanes.template sweep_voted<kCount>(s_rows[i & 1], chunk_rows(i, kSliceMM, n_rows),
                                       i * kSliceMM, tl);
    __syncthreads();  // the buffer is free for slice i + 2
  }
  if (kCount) tl.flush(tally);
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

namespace {

template <int R, bool kCount>
int launch_listed_stream(int blocks, int threads, cudaStream_t s, const float* tri,
                         int n_rows, int chunk, const float* lo, const float* hi,
                         const int* counts, const int* lists, long long list_stride,
                         const float* orig, const float* dir, int n, int block,
                         uint8_t* hit, int64_t* idx, float* t,
                         unsigned long long* tally) {
  const int smem = (threads / 32) * (int)sizeof(ListedStage);
  auto kernel = trace_listed_stream_kernel<R, kCount>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, s>>>(tri, n_rows, chunk, lo, hi, counts, lists,
                                       list_stride, orig, dir, n, block, hit, idx, t,
                                       tally);
  return (int)cudaGetLastError();
}

template <bool kCount>
int launch_listed_stream_rays(int rays, int blocks, int threads, cudaStream_t s,
                              const float* tri, int n_rows, int chunk, const float* lo,
                              const float* hi, const int* counts, const int* lists,
                              long long list_stride, const float* orig, const float* dir,
                              int n, int block, uint8_t* hit, int64_t* idx, float* t,
                              unsigned long long* tally) {
  switch (rays) {
    case 1: return launch_listed_stream<1, kCount>(blocks, threads, s, tri, n_rows, chunk,
                                                   lo, hi, counts, lists, list_stride, orig,
                                                   dir, n, block, hit, idx, t, tally);
    case 2: return launch_listed_stream<2, kCount>(blocks, threads, s, tri, n_rows, chunk,
                                                   lo, hi, counts, lists, list_stride, orig,
                                                   dir, n, block, hit, idx, t, tally);
    case 4: return launch_listed_stream<4, kCount>(blocks, threads, s, tri, n_rows, chunk,
                                                   lo, hi, counts, lists, list_stride, orig,
                                                   dir, n, block, hit, idx, t, tally);
    default: return launch_listed_stream<8, kCount>(blocks, threads, s, tri, n_rows, chunk,
                                                    lo, hi, counts, lists, list_stride, orig,
                                                    dir, n, block, hit, idx, t, tally);
  }
}

}  // namespace

// The number of entries of the tally of #6 and #8 (an (entries,) uint64
// buffer, or null for no count).
extern "C" int srt_trace_tally_entries() { return kTallyEntries; }

// stream_rows 0: #7, trace_listed_kernel (lo, hi and tally unread);
// stream_rows 1: #6, trace_listed_stream_kernel, which votes per warp on
// the boxes lo / hi (nc = ceil(n_rows / chunk) rows each) and adds its
// counts to `tally` unless it is null
extern "C" int srt_trace_listed(const float* tri, int n_rows, int chunk,
                                const float* lo, const float* hi,
                                const int* counts, const int* lists,
                                long long list_stride, const float* orig,
                                const float* dir, int n, int block, int stream_rows,
                                uint8_t* hit, int64_t* idx, float* t,
                                unsigned long long* tally, void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays) || chunk < 1 || chunk > kMaxChunk ||
      (stream_rows && (lo == nullptr || hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  if (stream_rows) {
    if (tally != nullptr)
      return launch_listed_stream_rays<true>(rays, blocks, threads, s, tri, n_rows, chunk,
                                             lo, hi, counts, lists, list_stride, orig, dir,
                                             n, block, hit, idx, t, tally);
    return launch_listed_stream_rays<false>(rays, blocks, threads, s, tri, n_rows, chunk,
                                            lo, hi, counts, lists, list_stride, orig, dir, n,
                                            block, hit, idx, t, tally);
  }
  SRT_DISPATCH_RAYS(rays, trace_listed_kernel, tri, n_rows, chunk, counts, lists,
                    list_stride, orig, dir, n, block, hit, idx, t)
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

#define SRT_DISPATCH_RAYS_COUNT(rays, COUNT, KERNEL, ...)                         \
  switch (rays) {                                                                 \
    case 1: KERNEL<1, COUNT><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;      \
    case 2: KERNEL<2, COUNT><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;      \
    case 4: KERNEL<4, COUNT><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;      \
    default: KERNEL<8, COUNT><<<blocks, threads, 0, s>>>(__VA_ARGS__); break;     \
  }

// `tally` as in srt_trace_listed.
extern "C" int srt_trace_unculled(const float* tri, int n_rows, const float* orig,
                                  const float* dir, int n, int block, uint8_t* hit,
                                  int64_t* idx, float* t, unsigned long long* tally,
                                  void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
  if (tally != nullptr) {
    SRT_DISPATCH_RAYS_COUNT(rays, true, trace_unculled_kernel, tri, n_rows, orig, dir, n,
                            block, hit, idx, t, tally)
  } else {
    SRT_DISPATCH_RAYS_COUNT(rays, false, trace_unculled_kernel, tri, n_rows, orig, dir, n,
                            block, hit, idx, t, tally)
  }
  return (int)cudaGetLastError();
}
