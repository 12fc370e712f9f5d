// What the nearest-hit kernels share: the Moller-Trumbore test of one ray
// against one [v0|e1|e2|pad] table row, the ray-box slab test, and the
// walk over the super, chunk and leaf boxes of a table that the culled
// instances of the camera, bounce and Whitted kernels take
// (warp_walk_chunks).
//
// Both are the expressions of the plain PyTorch versions in their order.
// Built with -fmad=false and without fast math, every multiply and add
// rounds on its own, so a kernel and its plain version agree bit for bit,
// and every kernel that sweeps the same rows picks the same winner.

#pragma once

#include <cuda_pipeline.h>
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

// ---- the two-stage Moller-Trumbore test of #2, #4, #6, #7 and #8
//
// Stage 1 computes p, det, inv, tvec and u with mt_test's expressions in
// mt_test's order, and its predicate `pass` is the first three terms of
// mt_test's `ok`: |det| >= 1e-6, u >= 0, u <= 1. The warp votes on `pass`;
// stage 2 (q, v, t and the rest of `ok`) runs only if some lane passed.
// Why the result is mt_test's bit for bit:
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
// So the winners equal mt_test's sweep and the plain versions.
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

// The work the two-stage kernels count when the caller passes a tally
// (kTallyEntries unsigned 64-bit totals, ops/trace_kernel.TALLY_NAMES):
// warp-steps (one warp, one row, one ray slot j), the warp-steps whose vote
// passed (stage 2 ran), the active rays' (ray, row) tests, those of them in
// voted steps (full tests), the active rays' slab tests (#4, #6), the
// (warp, chunk) votes of #6 (listed chunks) and #4 (the chunks of the
// supers a warp enters) with those the warp skipped (no active ray of it
// enters the box), and the tests whose own stage 1 passed. #2 and #7 make
// no slab test and no chunk vote. A thread counts its own; the warp sums
// them at the end.
constexpr int kTallyEntries = 8;
struct VoteTally {
  uint32_t steps = 0, voted = 0, tests = 0, full = 0, slabs = 0, pairs = 0, skipped = 0,
           passes = 0;
  __device__ __forceinline__ void flush(unsigned long long* total) const {
    // warp-uniform counts are the same in every lane: lane 0 adds its own
    const uint32_t tests_w = __reduce_add_sync(0xffffffffu, tests);
    const uint32_t full_w = __reduce_add_sync(0xffffffffu, full);
    const uint32_t slabs_w = __reduce_add_sync(0xffffffffu, slabs);
    const uint32_t passes_w = __reduce_add_sync(0xffffffffu, passes);
    if ((threadIdx.x & 31) != 0) return;
    const uint32_t v[kTallyEntries] = {steps,   voted, tests_w, full_w,
                                       slabs_w, pairs, skipped, passes_w};
#pragma unroll
    for (int k = 0; k < kTallyEntries; ++k)
      if (v[k]) atomicAdd(total + k, (unsigned long long)v[k]);
  }

  // one warp-step of a ray slot: its vote `any`, whether the thread's ray
  // is there (`active`) and passed stage 1 (`pass`)
  __device__ __forceinline__ void step(bool any, bool active, bool pass) {
    steps += 1;
    voted += any;
    tests += active;
    full += any && active;
    passes += pass && active;
  }
};

// min and max that hand a NaN on, as torch.minimum / torch.maximum do
// (fminf / fmaxf drop it): PTX min.NaN / max.NaN, one FMNMX.NAN each on
// sm_80+ (the select form `(a < b || a != a) ? a : b` took ~2.5
// instructions on an H100). Either form gives a NaN when either input is
// one and otherwise the same value up to the sign of a zero, which only
// feeds comparisons and further min / max here, so every slab test's
// bool is unchanged.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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
// t >= 0 (t_exit >= max(t_enter, 0)), the box given by its six floats.
__device__ __forceinline__ bool slab_enter(const Ray& r, const InvDir& i, float lx,
                                           float ly, float lz, float hx, float hy,
                                           float hz) {
  float t0 = (lx - r.ox) * i.x;
  float t1 = (hx - r.ox) * i.x;
  float tmin = nan_min(t0, t1);
  float tmax = nan_max(t0, t1);
  t0 = (ly - r.oy) * i.y;
  t1 = (hy - r.oy) * i.y;
  tmin = nan_max(tmin, nan_min(t0, t1));
  tmax = nan_min(tmax, nan_max(t0, t1));
  t0 = (lz - r.oz) * i.z;
  t1 = (hz - r.oz) * i.z;
  tmin = nan_max(tmin, nan_min(t0, t1));
  tmax = nan_min(tmax, nan_max(t0, t1));
  return tmax >= nan_max(tmin, 0.0f);
}

// The same, lo and hi pointing at 3 floats each.
__device__ __forceinline__ bool slab_enter(const Ray& r, const InvDir& i,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi) {
  return slab_enter(r, i, lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]);
}

// The tables of a culled walk: the boxes of runs of `chunk` rows of the
// triangle table (RTScene.chunk_lo / chunk_hi, BVH leaf order), of runs of
// kSuper chunks (ops/trace_tiers.super_bounds) and of runs of kLeaf rows
// (the leaves, ops/trace_tiers.leaf_bounds), chunk / kLeaf of them a
// chunk.
constexpr int kSuper = 8;  // ops/trace_tiers.MM2C_SUPER
// rows of a leaf box: one a thread of a warp, so that one (ray, leaf) pair
// is one row-step of the warp (ops/trace_tiers.LEAF)
constexpr int kLeaf = 32;
struct CullTables {
  const float* lo;   // (nc,3)
  const float* hi;
  const float* lo2;  // (nsc,3), nsc = ceil(nc / kSuper)
  const float* hi2;
  const float* lo3;  // (nl,3), nl * kLeaf >= the rows walked
  const float* hi3;
  int nc, nsc, nl, chunk;
};

__host__ __device__ inline CullTables cull_tables(const float* lo, const float* hi,
                                                  const float* lo2, const float* hi2,
                                                  const float* lo3, const float* hi3,
                                                  int nc, int nl, int chunk) {
  return CullTables{lo, hi, lo2, hi2, lo3, hi3, nc, (nc + kSuper - 1) / kSuper, nl, chunk};
}

// A thread's count of the (ray, row) tests and the slab tests it made,
// added to a device total at the end when the caller asks for it (the
// work a bound is computed from).
struct Tally {
  uint32_t rows = 0, slabs = 0;
  __device__ __forceinline__ void flush(unsigned long long* total) const {
    if (total == nullptr) return;
    atomicAdd(total, (unsigned long long)rows);
    atomicAdd(total + 1, (unsigned long long)slabs);
  }
};

// ---- the warp walk: one warp tests each (ray, leaf) pair together
//
// Each ray enters the leaves whose boxes it meets: a slab test on each
// super-chunk's box, then on each of its chunks' boxes, then on each leaf
// box of an entered chunk. The test is conservative, so a nearest-hit
// search over the entered rows under a strict `<` finds the full sweep's
// winner: only rows the ray cannot hit are skipped. A walk per thread (the
// plain version's ops/trace_tiers.walk_nearest_plain) leaves each thread
// to its own leaves, so a warp runs every row of every leaf that any of
// its 32 rays enters while the threads whose ray did not enter it idle.
// warp_walk_chunks makes the same slab tests per ray, ballots each leaf
// across the warp, stages the entered leaves' rows, and then lets all 32
// threads test them for one entering ray at a time, one row a thread: a
// warp issues one row-step for each (ray, leaf) pair, the sum of its rays'
// leaves, not the union. Where few of its rays enter a box, the warp tests
// their (ray, child box) pairs one a thread too (child_boxes).

constexpr unsigned kFullMask = 0xffffffffu;
// rows of one staged slice: kSliceLeaves entered leaves, packed in walk
// order whatever chunk each comes from. A tuning value that changes no
// result: on an H100 the camera kernel's 16-spp frame took 107.6 ms at
// 128 and 109.0 at 64 at 9,216 triangles (64 was ahead at 147,456 and in
// the bounce kernel).
constexpr int kSlice = 128;
constexpr int kSliceLeaves = kSlice / kLeaf;

// A warp's staging area in shared memory: two slices of kSlice 48-byte
// rows (3 float4 each; 12 KB, 48 KB a block of four warps), one tested
// while the next one lands. A thread reads whole rows as float4: eight
// threads at a 48-byte stride meet eight disjoint groups of four banks,
// so a warp's reads do not conflict.
struct WarpStage {
  float4 rows[2][kSlice * 3];
};
constexpr int kWarpStageBytes = (int)sizeof(WarpStage);

// The nearest row of one ray's walk: t (kBig on a miss) and row (-1).
struct RowHit {
  float t;
  int row;
};

// One slice: up to kSliceLeaves leaves that some ray of the warp enters,
// ascending, and each one's ballot of the warp's rays that enter it; a
// slot past `n` has leaf 0 and an empty ballot. Warp-uniform.
struct WalkItem {
  int leaf[kSliceLeaves];
  unsigned mask[kSliceLeaves];
  int n;
};

// The walk's position: super box sc, the chunks of it still to visit
// (`todo`, warp-uniform; bit j = chunk sc * kSuper + j), this thread's
// own chunks of it (`mine`), and of chunk c the leaves still to visit
// (`ltodo`, warp-uniform; bit j = leaf c * (chunk / kLeaf) + j) and this
// thread's own leaves of it (`lmine`).
struct WalkCursor {
  int sc;
  unsigned todo, mine;
  int c;
  unsigned ltodo, lmine;
};

// The slots a warp's walk issues, warp-uniform (every thread holds the
// same counts; lane 0 adds them up): `rows`, 32 a row-step, one (ray,
// leaf) pair; `box_steps`, the slab-test steps of the chunk and leaf
// levels (32 slots each), the work the box tests' lane efficiency (the
// chunk and leaf tests / box slots) is read from.
struct WalkSlots {
  unsigned long long rows = 0;
  uint32_t box_steps = 0;
  // lane 0 adds the row-test slots to *rows_total and the box slots to
  // *box_total, either of them skipped where null
  __device__ __forceinline__ void flush(unsigned long long* rows_total,
                                        unsigned long long* box_total) const {
    if ((threadIdx.x & 31) != 0) return;
    if (rows_total != nullptr && rows != 0) atomicAdd(rows_total, rows);
    if (box_total != nullptr && box_steps != 0)
      atomicAdd(box_total, 32ull * box_steps);
  }
};

// ---- cooperative box tests: one (ray, child box) pair a thread
//
// A box (a super box, or a chunk) that k rays of the warp enter has n
// child boxes (its chunks, or its leaves), at most `per` of them. Each ray
// testing its own children on its own thread costs the warp n slab-test
// steps while the 32 - k threads whose ray did not enter sit idle. The
// cooperative form tests the k x n pairs 32 threads at a time instead:
// pass p gives thread i the ray of rank p * (32 / per) + i / per among the
// entering rays (the rank-th set bit of their ballot) and child i % per,
// so a pass holds 32 / per rays, and costs ceil(k / (32 / per)) steps.
// It runs where `per` divides 32 (so no pair straddles two passes),
// where k <= kCoopRays and where it takes fewer steps than the n of the
// own-thread loop; otherwise each ray tests its own children, as before.
// The choice depends on the ballot and the table alone, so it is
// warp-uniform. Coherent rays (camera rays enter most boxes together)
// keep the own-thread loop, which needs no shuffle.
//
// Why the cooperative form enters exactly the boxes the own-thread loop
// enters, and leaves every tally equal:
//   * every pair (ray q, child j < n) is tested once, in pass q / (32 /
//     per), by thread (q % (32 / per)) * per + j: the passes step the
//     ranks by 32 / per, and a thread's rank and child are fixed within a
//     pass;
//   * the test is slab_enter on the ray's own origin and its own InvDir,
//     moved bit for bit from the ray's thread by __shfl_sync (inv_dir is
//     computed there, as in the own-thread loop), against the same six
//     floats of the same box: the same expression on the same bits, so
//     the same bool. A chunk past n_rows is not entered in both forms;
//   * the ray's thread takes bits [(q % (32 / per)) * per, + per) of that
//     pass's ballot as its own children's bits, bit j for child j; a child
//     j >= n is never tested and reads 0 in both forms. So `mine` /
//     `lmine`, and with them `todo` / `ltodo`, each leaf's ballot and the
//     order of the leaves, are the own-thread loop's; the row-steps, the
//     winners and the tie rule follow unchanged;
//   * the thread that makes a test counts it (one slab test; an entered
//     leaf's rows), where the ray's own thread counted it before: the
//     warp's sums are k x n slab tests and the same rows, and the flush
//     adds every thread's counts, so `rows` and `slabs` are unchanged.
// Only the slots move: `box_steps` counts the passes, or n.

// rays of the warp at most that test a box's children together
// (cooperative form). A tuning value that changes no result: on an H100
// the culled camera kernel's 16-spp frame took 101.1 / 164.8 ms at 9,216 /
// 147,456 triangles at 24, the same within 0.5% at 16 and 32 (where the
// step count alone decides), and 101.6 / 167.5 at 8.
constexpr int kCoopRays = 24;

// position of the (q + 1)-th set bit of m, for q < popc(m): a binary search
// on the population counts of the low halves
__device__ __forceinline__ int nth_set_bit(unsigned m, int q) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    const bool up = q >= c;
    q -= up ? c : 0;
    m = up ? m >> w : m;
    pos += up ? w : 0;
  }
  return pos;
}

// Of the boxes `first` .. `first + n - 1` of lo / hi (children of a box
// entered by the rays of the threads in ballot `in`; n <= per <= 32),
// those this thread's ray enters, bit j for box first + j (0 for a thread
// outside `in`). `enter(b, ray, inv)` is the test of box b (counting
// what it enters); `tl.slabs` gets a count a test made, `box_steps` the
// steps the warp issues. Warp-uniform.
template <typename Enter>
__device__ __forceinline__ unsigned child_boxes(const Ray& r, const InvDir& inv,
                                                unsigned in, int first, int n, int per,
                                                Enter enter, Tally& tl,
                                                uint32_t& box_steps) {
  const int lane = threadIdx.x & 31;
  const bool mine_in = (in >> lane) & 1u;
  const int k = __popc(in);
  const int shift = __ffs(per) - 1;  // log2(per) where per divides 32
  const int rays = 32 >> shift;      // rays a pass
  const int passes = (k + rays - 1) >> (5 - shift);
  unsigned bits = 0u;
  if ((per & (per - 1)) == 0 && k <= kCoopRays && passes < n) {
    box_steps += passes;
    // `src`: the thread whose ray has rank `lane`; `rank`: this thread's
    // ray's rank among the entering rays, 32 outside `in`: in no pass, as
    // every pass's base is a multiple of `rays` below 32
    const int src = nth_set_bit(in, min(lane, k - 1));
    const int rank = mine_in ? __popc(in & ((1u << lane) - 1u)) : 32;
    for (int base = 0; base < k; base += rays) {
      // this thread's pair: rank base + lane / per, child lane % per
      const int q = base + (lane >> shift), j = lane & (per - 1);
      const int from = __shfl_sync(kFullMask, src, min(q, k - 1));
      const Ray rq = {__shfl_sync(kFullMask, r.ox, from), __shfl_sync(kFullMask, r.oy, from),
                      __shfl_sync(kFullMask, r.oz, from), 0.0f, 0.0f, 0.0f};
      const InvDir iq = {__shfl_sync(kFullMask, inv.x, from),
                         __shfl_sync(kFullMask, inv.y, from),
                         __shfl_sync(kFullMask, inv.z, from)};
      bool hit = false;
      if (q < k && j < n) {
        tl.slabs += 1;
        hit = enter(first + j, rq, iq);
      }
      const unsigned bal = __ballot_sync(kFullMask, hit);
      const unsigned d = (unsigned)(rank - base);
      if (d < (unsigned)rays) bits = (bal >> (d << shift)) & (kFullMask >> (32 - per));
    }
  } else {
    box_steps += n;
    if (mine_in) {
      tl.slabs += n;
      for (int j = 0; j < n; ++j)
        if (enter(first + j, r, inv)) bits |= 1u << j;
    }
  }
  return bits;
}

// Advance `cur` to the next leaf in row order that some active ray of the
// warp enters, with its ballot; false when none is left. Each ray makes
// its slab tests in the per-ray walk's order (the super box, then the
// chunks of an entered super box, then the leaves of an entered chunk),
// the chunk and leaf tests through child_boxes, own-thread or
// cooperative, which enter the same boxes and tally the same tests and
// rows either way (the argument above child_boxes). Warp-uniform: every
// thread of the warp calls it together.
__device__ __forceinline__ bool walk_next_leaf(const Ray& r, const InvDir& inv,
                                               bool active, const CullTables& ct,
                                               int n_rows, WalkCursor& cur, int& leaf,
                                               unsigned& mask, Tally& tl,
                                               uint32_t& box_steps) {
  const int per_chunk = ct.chunk / kLeaf;
  while (true) {
    if (cur.ltodo != 0) {
      const int j = __ffs(cur.ltodo) - 1;
      cur.ltodo &= cur.ltodo - 1;
      leaf = cur.c * per_chunk + j;
      mask = __ballot_sync(kFullMask, (cur.lmine >> j) & 1u);
      return true;
    }
    // the next box whose children the warp tests: a chunk still to visit
    // (its leaves), else the next super box that some ray enters (its
    // chunks)
    const bool leaves = cur.todo != 0;
    unsigned in;
    int first, n, per;
    if (leaves) {
      const int j = __ffs(cur.todo) - 1;
      cur.todo &= cur.todo - 1;
      cur.c = cur.sc * kSuper + j;
      in = __ballot_sync(kFullMask, (cur.mine >> j) & 1u);
      first = cur.c * per_chunk;
      n = min(per_chunk, (n_rows + kLeaf - 1) / kLeaf - first);
      per = per_chunk;
    } else {
      if (++cur.sc >= ct.nsc) return false;
      const int sc = cur.sc;
      in = __ballot_sync(kFullMask,
                         active && slab_enter(r, inv, ct.lo2 + 3 * sc, ct.hi2 + 3 * sc));
      if (in == 0u) continue;
      first = sc * kSuper;
      n = min(kSuper, ct.nc - first);
      per = kSuper;
    }
    const float* lo = leaves ? ct.lo3 : ct.lo;
    const float* hi = leaves ? ct.hi3 : ct.hi;
    const unsigned bits = child_boxes(
        r, inv, in, first, n, per,
        [&](int b, const Ray& rb, const InvDir& ib) {
          // a chunk past n_rows is not entered
          if (!leaves && b * ct.chunk >= n_rows) return false;
          if (!slab_enter(rb, ib, lo + 3 * b, hi + 3 * b)) return false;
          if (leaves) tl.rows += min(kLeaf, n_rows - b * kLeaf);
          return true;
        },
        tl, box_steps);
    const unsigned any = __reduce_or_sync(kFullMask, bits);
    if (leaves) {
      cur.lmine = bits;
      cur.ltodo = any;
    } else {
      cur.mine = bits;
      cur.todo = any;
    }
  }
}

// The next slice: up to kSliceLeaves leaves from walk_next_leaf; false
// when none is left. Warp-uniform.
__device__ __forceinline__ bool walk_next(const Ray& r, const InvDir& inv, bool active,
                                          const CullTables& ct, int n_rows,
                                          WalkCursor& cur, WalkItem& item, Tally& tl,
                                          uint32_t& box_steps) {
#pragma unroll
  for (int q = 0; q < kSliceLeaves; ++q) {
    item.leaf[q] = 0;
    item.mask[q] = 0u;
  }
  item.n = 0;
  int leaf;
  unsigned mask;
  while (item.n < kSliceLeaves &&
         walk_next_leaf(r, inv, active, ct, n_rows, cur, leaf, mask, tl, box_steps)) {
#pragma unroll
    for (int q = 0; q < kSliceLeaves; ++q)
      if (q == item.n) {
        item.leaf[q] = leaf;
        item.mask[q] = mask;
      }
    ++item.n;
  }
  return item.n > 0;
}

// Stage the rows of `item`'s leaves from the [v0|e1|e2|pad] table `tri`
// (16-byte aligned) into `dst` with cp.async, leaf q at rows [q * kLeaf,
// (q + 1) * kLeaf): 3 float4 a row, spread over the warp.
__device__ __forceinline__ void walk_stage(float4* __restrict__ dst,
                                           const float* __restrict__ tri,
                                           const WalkItem& item, int n_rows, int lane) {
#pragma unroll
  for (int q = 0; q < kSliceLeaves; ++q) {
    if (q >= item.n) break;
    const int f0 = item.leaf[q] * kLeaf;
    const int cnt3 = 3 * min(kLeaf, n_rows - f0);
    const float4* src = reinterpret_cast<const float4*>(tri + (size_t)f0 * 12);
    for (int k = lane; k < cnt3; k += 32)
      __pipeline_memcpy_async(dst + q * kLeaf * 3 + k, src + k, sizeof(float4));
  }
}

// The nearest row of ray `r` over the leaves whose boxes it enters, for
// every thread of a warp at once; `test(g, ray)` is the kernel's
// Moller-Trumbore of `ray` against the 12 floats `g` of one row (t or
// kBig). Equal to a sequential per-ray walk under a strict `<`:
//   * each (ray, row) pair that the per-ray walk tests is tested once, with
//     the same `test`, by thread (row % kLeaf) of the warp, in the slice
//     that holds the row's leaf;
//   * for each ray that enters a leaf of the slice, a thread keeps the
//     minimum of its rows of the ray's leaves under a strict `<` (the
//     leaves ascend, so its rows do); two warp reductions then take the
//     lexicographic minimum of (t, row) over the slice (t >= 1e-6 or kBig,
//     never NaN, so its bits order as unsigned integers), and the ray's
//     thread merges it with a strict `<`; slices ascend, so the lowest row
//     wins a tie.
// An inactive thread (active false) enters nothing and keeps a miss but
// takes part in every vote and shuffle: the whole warp must call this
// together. `stage` is the warp's own area; `slots` gets the row-steps
// the warp issues, one a (ray, leaf) pair, the work the SIMT efficiency
// is read from, and the slab-test steps of its chunk and leaf levels.
template <typename Test>
__device__ __forceinline__ RowHit warp_walk_chunks(
    const Ray& r, bool active, const CullTables& ct,
    const float* __restrict__ tri, int n_rows, WarpStage& stage, Test test,
    Tally& tl, WalkSlots& slots) {
  const int lane = threadIdx.x & 31;
  const InvDir inv = inv_dir(r);
  if (active) tl.slabs += ct.nsc;
  RowHit best = {kBig, -1};
  WalkCursor cur = {-1, 0u, 0u, 0, 0u, 0u};
  WalkItem item, next;
  bool have = walk_next(r, inv, active, ct, n_rows, cur, item, tl, slots.box_steps);
  if (have) walk_stage(stage.rows[0], tri, item, n_rows, lane);
  __pipeline_commit();
  for (int k = 0; have; ++k) {
    const bool more = walk_next(r, inv, active, ct, n_rows, cur, next, tl, slots.box_steps);
    if (more) walk_stage(stage.rows[(k + 1) & 1], tri, next, n_rows, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // item's rows have landed; next's may fly
    __syncwarp();
    const float4* rows = stage.rows[k & 1];
    unsigned any = 0u, pairs = 0u;
#pragma unroll
    for (int q = 0; q < kSliceLeaves; ++q) {
      any |= item.mask[q];
      pairs += (unsigned)__popc(item.mask[q]);
    }
    slots.rows += 32ull * pairs;
    for (unsigned m = any; m != 0; m &= m - 1) {
      const int L = __ffs(m) - 1;
      const Ray rl = {__shfl_sync(kFullMask, r.ox, L), __shfl_sync(kFullMask, r.oy, L),
                      __shfl_sync(kFullMask, r.oz, L), __shfl_sync(kFullMask, r.dx, L),
                      __shfl_sync(kFullMask, r.dy, L), __shfl_sync(kFullMask, r.dz, L)};
      // the slots of ray L's leaves (warp-uniform): a row-step each
      unsigned qs = 0u;
#pragma unroll
      for (int q = 0; q < kSliceLeaves; ++q) qs |= ((item.mask[q] >> L) & 1u) << q;
      float bt = kBig;
      int bf = 0x7fffffff;
      for (; qs != 0; qs &= qs - 1) {
        const int q = __ffs(qs) - 1;
        int leaf = item.leaf[0];
#pragma unroll
        for (int s = 1; s < kSliceLeaves; ++s) leaf = q == s ? item.leaf[s] : leaf;
        // a row past n_rows (the last leaf's tail) is tested on stale data
        // and its result dropped
        const int f = leaf * kLeaf + lane;
        const int i = q * kLeaf + lane;
        const float4 a = rows[3 * i], b = rows[3 * i + 1], c = rows[3 * i + 2];
        const float g[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                             c.x, c.y, c.z, c.w};
        const float tm = test(g, rl);
        if (f < n_rows && tm < bt) {
          bt = tm;
          bf = f;
        }
      }
      const unsigned tbits = __reduce_min_sync(kFullMask, __float_as_uint(bt));
      const int fmin = (int)__reduce_min_sync(
          kFullMask, __float_as_uint(bt) == tbits ? (unsigned)bf : 0x7fffffffu);
      const float tmin = __uint_as_float(tbits);
      if (lane == L && tmin < best.t) {
        best.t = tmin;
        best.row = fmin;
      }
    }
    __syncwarp();  // every thread has left this buffer before it is refilled
    item = next;
    have = more;
  }
  return best;
}

// Whether the tables cover `n_rows` rows: ceil(nc / kSuper) super boxes,
// chunks of a whole number of leaves (at most 32 a chunk, one bit each of
// a 32-bit ballot), and as many leaf boxes as the rows need.
inline bool cull_tables_ok(const CullTables& ct, int n_rows) {
  return ct.chunk >= kLeaf && ct.chunk % kLeaf == 0 && ct.chunk / kLeaf <= 32 &&
         ct.nc >= 0 && (long long)ct.nc * ct.chunk >= n_rows &&
         ct.nsc == (ct.nc + kSuper - 1) / kSuper && ct.nl >= 0 &&
         (long long)ct.nl * kLeaf >= n_rows && ct.lo3 != nullptr && ct.hi3 != nullptr;
}

}  // namespace srt
