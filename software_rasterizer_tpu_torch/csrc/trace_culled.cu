// Chunked nearest-triangle kernels for Hopper (sm_90a): the large-scene
// tiers behind nearest_hit.
//
// Five kernels, replacing five Pallas kernels of the JAX package's
// ops/pallas_trace.py:
//   cull_prepass_kernel         _cull_prepass_kernel  (a (nb, nc) mask)
//   trace_listed_all_kernel     _trace_kernel2        (lists, every listed chunk)
//   trace_listed_stream_kernel  _trace_kernel3        (lists, a warp's box vote)
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
// is the two-stage form of trace_common.cuh's mt_test (mt_stage1 /
// mt_stage2, the proof beside them), so all tiers equal the unculled sweep
// bit for bit.
//
// Bound: FP32 ALU work, ~58 operations a (ray, row) test and ~21 a slab
// test; the bytes (24 in and 13 out a ray, 48 a row) are far below it.
// Built without FMAs (-fmad=false), a test is ~80 issue slots, so the
// kernels sit near their issue floor, not their memory.
// Design: one CUDA block a ray block (#5: 256 / block of them). A thread
// owns up to kMaxRays rays of its block (ray tid + j * blockDim.x), held in
// registers with their running best; a thread with no ray (the tail of the
// last block) holds an absent ray with d = 0 and takes part in every vote.
//
// #4, #6, #7 and #8 test in two stages with a warp vote
// (Lanes::sweep_voted): most (ray, row) pairs fail on |det| or u, and when
// every lane of a warp fails there, the warp skips the rest of the test.
// In #4, #6 and #7 each warp walks on its own (stream_rows), staging the
// rows of the chunks it sweeps in a double buffer of its own: #7 every
// chunk of its block's list, #6 those of them whose boxes some ray of the
// warp enters, #4 the chunks of the super-chunks it enters that some ray
// of it enters. #5 votes per warp on the super-chunk boxes first and skips
// a super's chunk boxes only where that is proven exact (the proof is
// beside it).

#include <cuda_pipeline.h>

#include "trace_common.cuh"

namespace {

using srt::InvDir;
using srt::kBig;
using srt::kTallyEntries;
using srt::Ray;
using srt::VoteTally;

constexpr int kMaxChunk = 256;   // rows of a chunk (ops/trace_tiers.MAX_CHUNK)
constexpr int kMaxThreads = 256;
constexpr int kMaxRays = 8;      // rays a thread, so block <= 2048
constexpr int kSuper = 8;        // chunks a super-chunk (MM2C_SUPER)
constexpr unsigned kFull = 0xffffffffu;
// Rows of a slice staged at a time: by each warp of #4 and #6 into its own
// double buffer (2 x kSliceListed x 48 bytes a warp), by the block of #8 into one
// shared double buffer (2 x kSliceMM x 48 bytes). Tuning values that change
// no result. On an H100, 1M camera rays: #6 at 147,456 triangles took about
// the same at 32 and 64 rows and 19% more at 128 (18 warps an SM, not 36);
// #8 at 9,216 the same at 128, 256 and 512.
constexpr int kSliceListed = 64;
constexpr int kSliceMM = 256;

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
        const srt::Stage1 st = srt::mt_stage1(ray[j], g);
        const bool any = __any_sync(kFull, st.pass);
        if (kCount) tl.step(any, active[j], st.pass);
        if (any) {
          const float tm = srt::mt_stage2(ray[j], g, st);
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

// ---- #5, the (nb, nc) mask: any ray of block b enters chunk c's box.
//
// A two-level warp vote. Each warp votes on each super-chunk's box (kSuper
// chunks, ops/trace_tiers.super_bounds, passed in as lo2 / hi2) with
// __any_sync over its active rays' slab_enter; a warp that enters no
// super box skips the super's chunks, one that enters it votes on each
// chunk box as the flat loop did, and a ray block's bit is the OR of its
// warps' chunk votes. The skip is taken only where it is proven exact, and
// the kernel checks the conditions itself (it assumes nothing of lo2 /
// hi2):
//   (a) every active ray of the warp has |o| <= 1e30 on every axis (not
//       NaN) and a finite inv_dir on every axis (rules out the denormal,
//       NaN and infinite components that make inv non-finite): checked
//       once a ray at load, the warp's __all_sync of it once;
//   (b) every child box of the super is well formed and inside it, with
//       the super's own box finite: lo <= hi, |lo|, |hi| <= 1e30,
//       |lo2|, |hi2| <= 1e30, lo2 <= lo and hi <= hi2 on every axis (rules
//       out the inverted box (1e30, -1e30) of an empty chunk, whose super
//       spans only its siblings): checked once a super in each CUDA block.
// A super whose children break (b), and every super of a warp with a ray
// that breaks (a), go child by child, as the flat loop.
//
// Proof that a skipped child's bit is 0, i.e. that a ray entering a child
// enters its super. Take one ray under (a) and one child under (b).
//   * Every operand is finite: |lo - o| <= 2e30 and |lo2 - o| <= 2e30 are
//     finite, and a finite value times the finite inv is finite or +-inf
//     (overflow), never NaN (no 0 * inf, no inf - inf). So nan_min /
//     nan_max act as min / max, up to the sign of a zero, which no
//     comparison sees.
//   * Round-to-nearest subtraction of o and multiplication by one number
//     are monotone (x <= y gives fl(x - o) <= fl(y - o), and fl(x * inv)
//     <= fl(y * inv) for inv > 0, >= for inv < 0; overflow rounds to +-inf
//     in order). On one axis with inv > 0: near = t0 = fl(fl(lo - o) *
//     inv) and far = t1, since lo <= hi; lo2 <= lo gives near_p <= near_c
//     and hi <= hi2 gives far_c <= far_p. With inv < 0, near = t1 and far
//     = t0 and the same two inequalities follow from hi <= hi2 and
//     lo2 <= lo; with inv = 0 (d = +-inf) every t is a zero. So on each
//     axis the child's slab interval lies inside the parent's.
//   * tmin is the max of the axes' near values and tmax the min of their
//     far values, both monotone: tmin_p <= tmin_c and tmax_c <= tmax_p.
//   * A ray that enters the child has tmax_c >= max(tmin_c, 0), so
//     tmax_p >= tmax_c >= max(tmin_c, 0) >= max(tmin_p, 0): it enters the
//     parent. Hence a warp none of whose active rays enters the super has
//     no active ray that enters any of its children: the flat loop's votes
//     on them are 0, and the OR over the block's warps is unchanged.
// (Absent rays vote in neither form.) So the mask equals the flat loop's,
// cull_prepass_plain's and the JAX kernel's bit for bit.
//
// Bound: ~21 FP32 operations a slab test (the tally counts them), the
// boxes, rays and mask bytes far below. Design: a CUDA block holds
// kMaxThreads / block ray blocks (one when block > kMaxThreads), so the
// boxes of a tile of up to kCullTile chunks are staged in shared memory
// once for several ray blocks, as two float4 a box (two 16-byte loads a
// test); the block's flags land in shared memory and go out as whole mask
// rows.
constexpr int kCullTile = 1024;  // chunks staged at a time (a multiple of kSuper)

// The work #5 counts when the caller passes a tally (kCullTallyEntries
// unsigned 64-bit totals, ops/trace_tiers.CULL_TALLY_NAMES): the active
// rays' slab tests on super boxes and on chunk boxes, the (warp, super)
// pairs, those whose vote no ray passed (skipped), those taken child by
// child because (a) or (b) failed, and the warp votes on chunk boxes.
constexpr int kCullTallyEntries = 6;
struct CullTally {
  uint32_t super_tests = 0, chunk_tests = 0, supers = 0, skipped = 0, unproven = 0,
           chunk_votes = 0;
  __device__ __forceinline__ void flush(unsigned long long* total) const {
    const uint32_t super_w = __reduce_add_sync(kFull, super_tests);
    const uint32_t chunk_w = __reduce_add_sync(kFull, chunk_tests);
    if ((threadIdx.x & 31) != 0) return;
    const uint32_t v[kCullTallyEntries] = {super_w, chunk_w, supers, skipped, unproven,
                                           chunk_votes};
#pragma unroll
    for (int k = 0; k < kCullTallyEntries; ++k)
      if (v[k]) atomicAdd(total + k, (unsigned long long)v[k]);
  }
};

// condition (a) for one ray
__device__ __forceinline__ bool ray_proven(const Ray& r, const InvDir& i) {
  return fabsf(r.ox) <= kBig && fabsf(r.oy) <= kBig && fabsf(r.oz) <= kBig &&
         isfinite(i.x) && isfinite(i.y) && isfinite(i.z);
}

// is box b (two float4: lo.xyz, hi.xyz) well formed and inside box p
__device__ __forceinline__ bool box_inside(float4 blo, float4 bhi, float4 plo, float4 phi) {
  const float l[3] = {blo.x, blo.y, blo.z}, h[3] = {bhi.x, bhi.y, bhi.z};
  const float pl[3] = {plo.x, plo.y, plo.z}, ph[3] = {phi.x, phi.y, phi.z};
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    ok = ok && l[k] <= h[k] && fabsf(l[k]) <= kBig && fabsf(h[k]) <= kBig &&
         fabsf(pl[k]) <= kBig && fabsf(ph[k]) <= kBig && pl[k] <= l[k] && h[k] <= ph[k];
  return ok;
}

__device__ __forceinline__ bool slab_box(const Ray& r, const InvDir& i, float4 lo, float4 hi) {
  return srt::slab_enter(r, i, lo.x, lo.y, lo.z, hi.x, hi.y, hi.z);
}

// Shared memory of a block of `per_cta` ray blocks and a tile of `tile`
// chunks: the chunk boxes and super boxes (two float4 each), a flag a
// super for (b), a flag a (ray block, chunk).
int cull_smem_bytes(int tile, int per_cta) {
  return 32 * tile + 32 * (tile / kSuper) + tile / kSuper + per_cta * tile;
}

template <int R, bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
cull_prepass_kernel(const float* __restrict__ lo, const float* __restrict__ hi, int nc,
                    const float* __restrict__ lo2, const float* __restrict__ hi2,
                    const float* __restrict__ orig, const float* __restrict__ dir, int n,
                    int block, int per_cta, int tile, uint8_t* __restrict__ mask,
                    unsigned long long* __restrict__ tally) {
  extern __shared__ float4 s_cull[];
  float4* s_box = s_cull;                     // 2 a chunk
  float4* s_sup = s_box + 2 * tile;           // 2 a super
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_sup + 2 * (tile / kSuper));
  uint8_t* s_flag = s_ok + tile / kSuper;     // per_cta x tile
  const int tpb = blockDim.x / per_cta;       // threads a ray block, a multiple of 32
  const int g = threadIdx.x / tpb;
  const int local = threadIdx.x - g * tpb;
  const int lane = threadIdx.x & 31;
  const int nb = (n + block - 1) / block;
  const int b = blockIdx.x * per_cta + g;
  const bool live = b < nb;                   // the same in every lane of a warp
  Ray ray[R];
  InvDir inv[R];
  bool active[R];
  bool proven = true;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int lj = local + j * tpb;
    const int r = b * block + lj;
    active[j] = live && lj < block && r < n;
    const size_t s = active[j] ? (size_t)3 * r : 0;
    ray[j].ox = active[j] ? orig[s] : 0.0f;
    ray[j].oy = active[j] ? orig[s + 1] : 0.0f;
    ray[j].oz = active[j] ? orig[s + 2] : 0.0f;
    ray[j].dx = active[j] ? dir[s] : 0.0f;
    ray[j].dy = active[j] ? dir[s + 1] : 0.0f;
    ray[j].dz = active[j] ? dir[s + 2] : 0.0f;
    inv[j] = srt::inv_dir(ray[j]);
    proven = proven && (!active[j] || ray_proven(ray[j], inv[j]));
  }
  const bool warp_proven = __all_sync(kFull, proven);  // (a) for the whole warp
  CullTally tl;
  for (int c0 = 0; c0 < nc; c0 += tile) {
    const int cnt = min(tile, nc - c0);
    const int ns = (cnt + kSuper - 1) / kSuper;
    const int sc0 = c0 / kSuper;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const size_t c = (size_t)3 * (c0 + i);
      s_box[2 * i] = make_float4(lo[c], lo[c + 1], lo[c + 2], 0.0f);
      s_box[2 * i + 1] = make_float4(hi[c], hi[c + 1], hi[c + 2], 0.0f);
    }
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      const size_t c = (size_t)3 * (sc0 + i);
      s_sup[2 * i] = make_float4(lo2[c], lo2[c + 1], lo2[c + 2], 0.0f);
      s_sup[2 * i + 1] = make_float4(hi2[c], hi2[c + 1], hi2[c + 2], 0.0f);
    }
    for (int i = threadIdx.x; i < per_cta * tile; i += blockDim.x) s_flag[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {  // (b), once a super
      bool ok = true;
      for (int k = i * kSuper; k < min((i + 1) * kSuper, cnt); ++k)
        ok = ok && box_inside(s_box[2 * k], s_box[2 * k + 1], s_sup[2 * i], s_sup[2 * i + 1]);
      s_ok[i] = ok;
    }
    __syncthreads();
    if (live) {
      uint8_t* flag = s_flag + g * tile;
      for (int sc = 0; sc < ns; ++sc) {
        bool go = true;
        if (kCount) tl.supers += 1;
        if (warp_proven && s_ok[sc]) {
          const float4 a = s_sup[2 * sc], z = s_sup[2 * sc + 1];
          bool e = false;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            if (!active[j]) continue;
            if (kCount) tl.super_tests += 1;
            e = slab_box(ray[j], inv[j], a, z) || e;
          }
          go = __any_sync(kFull, e);
          if (kCount) tl.skipped += !go;
        } else if (kCount) {
          tl.unproven += 1;
        }
        if (!go) continue;
        const int i1 = min((sc + 1) * kSuper, cnt);
#pragma unroll 1
        for (int i = sc * kSuper; i < i1; ++i) {
          const float4 a = s_box[2 * i], z = s_box[2 * i + 1];
          bool e = false;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            if (!active[j]) continue;
            if (kCount) tl.chunk_tests += 1;
            e = slab_box(ray[j], inv[j], a, z) || e;
          }
          if (kCount) tl.chunk_votes += 1;
          // one writer a warp; every writer stores the same 1
          if (__any_sync(kFull, e) && lane == 0) flag[i] = 1;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < per_cta * cnt; i += blockDim.x) {
      const int gg = i / cnt, k = i - gg * cnt;
      const int bb = blockIdx.x * per_cta + gg;
      if (bb < nb) mask[(size_t)bb * nc + c0 + k] = s_flag[gg * tile + k];
    }
    __syncthreads();
  }
  if (kCount && live) tl.flush(tally);
}

// ---- the streamed sweep of #6 and #4: each warp on its own, a cursor
// handing it the next slice of rows it must test, the rows streamed slice
// by slice with cp.async into the warp's own double buffer, the next slice
// in flight while the current one is swept with the two-stage test.
// No block barrier: a warp that skips a chunk goes straight on to the next.
//
// #6's cursor walks the block's list from the prepass (#5), which lists a
// chunk for a ray block when some ray of the block enters its box, and
// votes per warp on each listed chunk's box. #4's cursor makes the
// two-level vote itself: a warp vote on each super-chunk's box, then on each
// chunk box of a super it enters. Either way a warp skips only chunks none
// of its rays enters; such a ray cannot hit a row of the chunk (the slab
// test is conservative, and it is the prepass's own test), so the skip
// changes no winner of that ray. Chunks and their rows go out in ascending
// order, so the strict < still keeps the lowest row on a tie. An empty
// chunk's rows are zero rows that det = 0 rejects.
//
// Against the block vote of the plain versions (trace_listed_plain,
// trace_nearest_mm2c_plain) and the JAX kernels, a warp tests a subset of
// its block's rows, and that subset holds every chunk its rays enter. A
// ray's result can differ only where its own slab test on the chunk (or
// super) of its winning row fails while a block-mate's passes: a knife
// edge of the slab test, which tests/torch_scenes.slab_knife_edge_rays
// proves ray by ray.

// A warp's staging area: two slices of kSliceListed 48-byte rows.
struct ListedStage {
  float4 rows[2][kSliceListed * 3];
};

// rows [f0, f0 + cnt) of the table, staged by one warp
struct RowSlice {
  int f0, cnt;
};

// #6 and #7: the warp's position in its block's list: entry i, rows
// [f, f_end) of its chunk not yet staged. With kVote (#6) the warp votes on
// each listed chunk's box and skips a chunk none of its rays enters;
// without (#7) it sweeps every listed chunk, as _trace_kernel2 sweeps the
// block's, and the boxes are not read.
template <bool kVote>
struct ListCursor {
  const int* __restrict__ list;
  int cnt;
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  int chunk, n_rows;
  int i, f, f_end;

  template <int R, bool kCount>
  __device__ __forceinline__ bool next(Lanes<R>& lanes, RowSlice& item, VoteTally& tl) {
    while (true) {
      if (f < f_end) {
        item.f0 = f;
        item.cnt = min(kSliceListed, f_end - f);
        f += kSliceListed;
        return true;
      }
      if (++i >= cnt) return false;
      const int c = list[i];
      if (kVote) {
        const bool e = lanes.template enters_each<kCount>(lo + 3 * c, hi + 3 * c, tl);
        const bool any = __any_sync(kFull, e);
        if (kCount) {
          tl.pairs += 1;
          tl.skipped += !any;
        }
        if (!any) continue;
      }
      f = c * chunk;
      f_end = min((c + 1) * chunk, n_rows);
    }
  }
};

// #4: the warp's position in the two-level vote: super box sc, the chunks
// of it the warp entered and has not yet swept (`todo`, bit j = chunk
// sc * kSuper + j), rows [f, f_end) of the current chunk not yet staged
struct SuperCursor {
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  int nc;
  const float* __restrict__ lo2;
  const float* __restrict__ hi2;
  int nsc, chunk, n_rows;
  int sc;
  unsigned todo;
  int f, f_end;

  template <int R, bool kCount>
  __device__ __forceinline__ bool next(Lanes<R>& lanes, RowSlice& item, VoteTally& tl) {
    while (true) {
      if (f < f_end) {
        item.f0 = f;
        item.cnt = min(kSliceListed, f_end - f);
        f += kSliceListed;
        return true;
      }
      if (todo != 0) {
        const int c = sc * kSuper + __ffs(todo) - 1;
        todo &= todo - 1;
        f = c * chunk;
        f_end = min((c + 1) * chunk, n_rows);
        continue;
      }
      if (++sc >= nsc) return false;
      const bool e2 = lanes.template enters_each<kCount>(lo2 + 3 * sc, hi2 + 3 * sc, tl);
      if (!__any_sync(kFull, e2)) continue;
      const int c_end = min((sc + 1) * kSuper, nc);
      for (int c = sc * kSuper; c < c_end; ++c) {
        const bool e = lanes.template enters_each<kCount>(lo + 3 * c, hi + 3 * c, tl);
        const bool any = __any_sync(kFull, e);
        if (kCount) {
          tl.pairs += 1;
          tl.skipped += !any;
        }
        if (any) todo |= 1u << (c - sc * kSuper);
      }
    }
  }
};

__device__ __forceinline__ void listed_stage(float4* __restrict__ dst,
                                             const float* __restrict__ tri,
                                             const RowSlice& item, int lane) {
  const float4* src = reinterpret_cast<const float4*>(tri + (size_t)item.f0 * 12);
  for (int k = lane; k < item.cnt * 3; k += 32)
    __pipeline_memcpy_async(dst + k, src + k, sizeof(float4));
}

// The streamed sweep of one warp over the slices `cur` hands out (the
// whole warp calls it together).
template <int R, bool kCount, typename Cursor>
__device__ __forceinline__ void stream_rows(Lanes<R>& lanes, Cursor& cur,
                                            const float* __restrict__ tri,
                                            ListedStage& stage, VoteTally& tl) {
  const int lane = threadIdx.x & 31;
  RowSlice item, next;
  bool have = cur.template next<R, kCount>(lanes, item, tl);
  if (have) listed_stage(stage.rows[0], tri, item, lane);
  __pipeline_commit();
  for (int k = 0; have; ++k) {
    const bool more = cur.template next<R, kCount>(lanes, next, tl);
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
}

// ---- #6: the listed chunks of each block
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
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  VoteTally tl;
  ListCursor<true> cur = {lists + (size_t)blockIdx.x * list_stride, counts[blockIdx.x], lo,
                          hi, chunk, n_rows, -1, 0, 0};
  stream_rows<R, kCount>(lanes, cur, tri, stage, tl);
  if (kCount) tl.flush(tally);
  lanes.store(n, block, hit, idx, t_out);
}

// ---- #7: every listed chunk of each block, no box vote: each warp sweeps
// exactly its block's listed rows, as _trace_kernel2 and trace_listed_plain
// do, so its winners are theirs bit for bit
template <int R, bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
trace_listed_all_kernel(const float* __restrict__ tri, int n_rows, int chunk,
                        const int* __restrict__ counts,
                        const int* __restrict__ lists, long long list_stride,
                        const float* __restrict__ orig,
                        const float* __restrict__ dir, int n, int block,
                        uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                        float* __restrict__ t_out, unsigned long long* __restrict__ tally) {
  extern __shared__ float4 s_listed[];
  ListedStage& stage = reinterpret_cast<ListedStage*>(s_listed)[threadIdx.x >> 5];
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  VoteTally tl;
  ListCursor<false> cur = {lists + (size_t)blockIdx.x * list_stride, counts[blockIdx.x],
                           nullptr, nullptr, chunk, n_rows, -1, 0, 0};
  stream_rows<R, kCount>(lanes, cur, tri, stage, tl);
  if (kCount) tl.flush(tally);
  lanes.store(n, block, hit, idx, t_out);
}

// ---- #4: no mask and no lists, each warp's own two-level vote
template <int R, bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
trace_fused_cull_kernel(const float* __restrict__ tri, int n_rows, int chunk,
                        const float* __restrict__ lo, const float* __restrict__ hi,
                        int nc, const float* __restrict__ lo2,
                        const float* __restrict__ hi2, int nsc,
                        const float* __restrict__ orig,
                        const float* __restrict__ dir, int n, int block,
                        uint8_t* __restrict__ hit, int64_t* __restrict__ idx,
                        float* __restrict__ t_out, unsigned long long* __restrict__ tally) {
  extern __shared__ float4 s_listed[];
  ListedStage& stage = reinterpret_cast<ListedStage*>(s_listed)[threadIdx.x >> 5];
  Lanes<R> lanes;
  lanes.load(orig, dir, n, block);
  VoteTally tl;
  SuperCursor cur = {lo, hi, nc, lo2, hi2, nsc, chunk, n_rows, -1, 0u, 0, 0};
  stream_rows<R, kCount>(lanes, cur, tri, stage, tl);
  if (kCount) tl.flush(tally);
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

// Launch `kernel` on stream s with `smem` bytes of dynamic shared memory,
// lifting the 48 KB cap where it needs more; cudaGetLastError() of the
// launch.
template <typename... KArgs, typename... Args>
int launch_dyn(void (*kernel)(KArgs...), int blocks, int threads, int smem, cudaStream_t s,
               Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a shape the kernels do not take.

// The instance KERNEL<R, kCount> for `rays` ray slots a thread, counting
// into a tally when `count`.
#define SRT_INSTANCE(KERNEL, rays, C)                                              \
  ((rays) == 1 ? KERNEL<1, C> : (rays) == 2 ? KERNEL<2, C> : (rays) == 4 ? KERNEL<4, C> \
                                                                          : KERNEL<8, C>)
#define SRT_PICK(KERNEL, rays, count) \
  ((count) ? SRT_INSTANCE(KERNEL, rays, true) : SRT_INSTANCE(KERNEL, rays, false))

// The number of entries of the tally of #4, #6, #7 and #8 (an (entries,)
// uint64 buffer, or null for no count).
extern "C" int srt_trace_tally_entries() { return kTallyEntries; }

// The number of entries of #5's tally.
extern "C" int srt_cull_tally_entries() { return kCullTallyEntries; }

// #5: lo / hi the nc chunk boxes, lo2 / hi2 the nsc = ceil(nc / kSuper)
// super boxes (checked by the kernel, conditions (a) and (b)); adds its
// counts to `tally` unless it is null.
extern "C" int srt_cull_prepass(const float* lo, const float* hi, int nc, const float* lo2,
                                const float* hi2, int nsc, const float* orig,
                                const float* dir, int n, int block, uint8_t* mask,
                                unsigned long long* tally, void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays) || nc < 0 || nsc != (nc + kSuper - 1) / kSuper)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || nc == 0) return 0;
  const int nb = (n + block - 1) / block;
  const int per_cta = kMaxThreads / threads;  // ray blocks a CUDA block
  const int whole = (nc + kSuper - 1) / kSuper * kSuper;
  const int tile = whole < kCullTile ? whole : kCullTile;
  return launch_dyn(SRT_PICK(cull_prepass_kernel, rays, tally != nullptr),
                    (nb + per_cta - 1) / per_cta, threads * per_cta,
                    cull_smem_bytes(tile, per_cta), (cudaStream_t)stream, lo, hi, nc, lo2,
                    hi2, orig, dir, n, block, per_cta, tile, mask, tally);
}

// stream_rows 0: #7, trace_listed_all_kernel (lo and hi unread);
// stream_rows 1: #6, trace_listed_stream_kernel, which votes per warp on
// the boxes lo / hi (nc = ceil(n_rows / chunk) rows each). Either adds its
// counts to `tally` unless it is null.
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
  const int smem = (threads / 32) * (int)sizeof(ListedStage);
  cudaStream_t s = (cudaStream_t)stream;
  if (stream_rows)
    return launch_dyn(SRT_PICK(trace_listed_stream_kernel, rays, tally != nullptr), blocks,
                      threads, smem, s, tri, n_rows, chunk, lo, hi, counts, lists,
                      list_stride, orig, dir, n, block, hit, idx, t, tally);
  return launch_dyn(SRT_PICK(trace_listed_all_kernel, rays, tally != nullptr), blocks,
                    threads, smem, s, tri, n_rows, chunk, counts, lists, list_stride, orig,
                    dir, n, block, hit, idx, t, tally);
}

// #4: `tally` as in srt_trace_listed.
extern "C" int srt_trace_fused_cull(const float* tri, int n_rows, int chunk,
                                    const float* lo, const float* hi, int nc,
                                    const float* lo2, const float* hi2, int nsc,
                                    const float* orig, const float* dir, int n,
                                    int block, uint8_t* hit, int64_t* idx, float* t,
                                    unsigned long long* tally, void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays) || chunk < 1 || chunk > kMaxChunk ||
      nsc != (nc + kSuper - 1) / kSuper)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  return launch_dyn(SRT_PICK(trace_fused_cull_kernel, rays, tally != nullptr),
                    (n + block - 1) / block, threads, (threads / 32) * (int)sizeof(ListedStage),
                    (cudaStream_t)stream, tri, n_rows, chunk, lo, hi, nc, lo2, hi2, nsc, orig,
                    dir, n, block, hit, idx, t, tally);
}

// `tally` as in srt_trace_listed.
extern "C" int srt_trace_unculled(const float* tri, int n_rows, const float* orig,
                                  const float* dir, int n, int block, uint8_t* hit,
                                  int64_t* idx, float* t, unsigned long long* tally,
                                  void* stream) {
  int threads, rays;
  if (!launch_shape(block, &threads, &rays)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  return launch_dyn(SRT_PICK(trace_unculled_kernel, rays, tally != nullptr),
                    (n + block - 1) / block, threads, 0, (cudaStream_t)stream, tri, n_rows,
                    orig, dir, n, block, hit, idx, t, tally);
}
