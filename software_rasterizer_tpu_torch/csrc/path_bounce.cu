// Fused bounce kernel of the wavefront path integrator for Hopper
// (sm_90a).
//
// Replaces ops/pallas_path.py::_bounce_kernel (behind fused_bounce_group)
// of the JAX package: up to `n_bounces` bounces of every lane of an
// explicit wavefront in one launch. A bounce samples a light direction
// over the emitter table (Scene::sampleLight, Scene.cpp:429-476), plays
// Russian roulette, samples the uniform hemisphere, traces the shadow ray
// and the bounce ray through one loop over triangles then spheres,
// evaluates the NEE term and moves the lane to the bounce ray's hit.
//
// Two kernels, one bounce (`bounce_step`), and the same results lane for
// lane:
//   * path_bounce_major (the full sweep) runs bounce-major in one
//     cooperative launch, a grid of as many blocks as fit on the card at
//     once. For b in [0, n_bounces) the grid strides over the list of the
//     lanes live at the start of bounce b, runs bounce b of each with the
//     table staged in shared memory (path_common.cuh dual_trace_block),
//     appends the lanes that live on to the next list (one ballot and one
//     atomicAdd a warp) and meets at grid.sync(). A warp thus issues the
//     bounces of 32 live lanes, and no lane waits for a longer one: 26% of
//     a Cornell frame's lanes outlive their first bounce, and the
//     per-lane loop this replaces held each warp until its longest lane
//     died.
//   * path_bounce_culled (the chunk-culled walk) keeps a per-lane loop:
//     each ray culls by the super, chunk and leaf boxes on its own and the
//     warp tests each (ray, leaf) pair together (path_common.cuh
//     dual_trace_culled). Its loop runs while any lane of the warp is
//     live; a dead lane (or one past n) stays in it, inactive, for the
//     warp's votes, and keeps its state.
//
// In: state (18,N) [pos|nrm|kd|emit|color|throughput], component-major,
// and live (N,). Out: acc (3,N), the radiance the lane gathered; the new
// state and live. A lane that is dead at the start of a bounce keeps its
// state as it is; a lane that dies in a bounce still takes that bounce's
// state update. acc and live are defined on every lane. A lane's sum has
// one term a bounce, added in bounce order, and its draws are keyed by
// its column and the bounce: any schedule that runs each lane's bounces in
// order gives the same bits.
//
// Bound: on a launch of few bounces the 2 x 18 x 4 bytes of state a lane
// (150 MB a million lanes); from a few bounces on FP32 ALU work, two
// Moller-Trumbore tests a triangle and lane-bounce. The bounce-major
// kernel keeps a live lane between bounces in a workspace from the
// wrapper: two lists of columns (int32) and two scratch planes of 21
// floats a lane (the 18 state rows and the 3 sums), component-major in
// list order so that a warp's loads and stores stay coalesced; bounce 0
// reads the input state by column. A lane that is done (dead on entry,
// dead after a bounce, or past the last bounce) writes its outputs once,
// as its row of a done plane of 24 floats a column (lane-major: six
// 16-byte stores, three whole 32-byte sectors), and a last pass copies
// the plane out column by column, so the component-major outputs are
// written in whole lines (22 scattered word stores a lane, at the columns
// of later lists, took more time than the copy on an H100). Data another
// SM wrote in this launch is read with ld.global.cg (L2).
//
// Draws are the JAX kernel's `_Rng`: one lowbias32 round of
// lane * 0x9E3779B1 ^ (seed + ctr * 0x85EBCA6B), twelve draws a bounce in
// a fixed order (pick 1, gauss3 4, gauss3 4, roulette 1, hemisphere 2),
// so draw k of bounce b has counter 12 b + k + 1. Build with -fmad=false
// and without fast math, so every multiply and add rounds on its own as
// in the plain PyTorch version; logf, cosf and sinf are the only place a
// last bit could differ from it.

#include <cooperative_groups.h>

#include "path_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;

// _Rng.uniform: one lowbias32 round, 24-bit float in [0, 1).
__device__ __forceinline__ float uniform1(uint32_t seed, uint32_t lane,
                                          uint32_t ctr) {
  uint32_t x = (lane * 0x9E3779B1u) ^ (seed + ctr * 0x85EBCA6Bu);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(int)(x >> 8) * (1.0f / 16777216.0f);
}

// _Rng.gauss3: Box-Muller, four uniforms (counters ctr..ctr+3) in, three
// standard normals out.
__device__ __forceinline__ V3 gauss3(uint32_t seed, uint32_t lane,
                                     uint32_t ctr) {
  const float u1 = uniform1(seed, lane, ctr);
  const float u2 = uniform1(seed, lane, ctr + 1u);
  const float u3 = uniform1(seed, lane, ctr + 2u);
  const float u4 = uniform1(seed, lane, ctr + 3u);
  const float r1 = sqrtf(-2.0f * logf(fmaxf(u1, 1e-12f)));
  const float r2 = sqrtf(-2.0f * logf(fmaxf(u3, 1e-12f)));
  const float a2 = kTwoPi * u2;
  return {r1 * cosf(a2), r1 * sinf(a2), r2 * cosf(kTwoPi * u4)};
}

struct BounceParams {
  const float* tri;         // (F,12) [v0|e1|e2|pad]
  const float* attr;        // (F,16) [n0|n1|n2|kd|emit|pad]
  const float* sph;         // (S,12) [c|r|emit|valid|kd|pad]
  const float* ecr;         // (O,4) emitter [center|radius]
  const float* state;       // (18,N)
  const uint8_t* live;      // (N,)
  float* out_state;         // (18,N)
  uint8_t* out_live;        // (N,)
  float* acc;               // (3,N)
  CullTables cull;          // read by the culled kernel only
  // the bounce-major kernel's workspace: 3 list lengths (zero on entry),
  // two lists of N columns, two scratch planes of (kScratchRows, N) and N
  // done rows of kDoneRows
  int* counts;
  int* lists;
  float* scratch;
  float4* done;
  // (n_tally,) [row tests, slab tests, row-test slots of the culled walk's
  // warps, the full sweep's active lane-bounces and issued lane-slots, the
  // box-test slots of the culled walk's warps] added, or null
  unsigned long long* tally;
  int n_tally;
  // (n_bounces + 3,) the bounce-major kernel's device clock (ns) at its
  // start, after its first list, after each bounce and at its end, or null
  unsigned long long* timeline;
  int n_tri, n_sph, n_emitters, n, n_bounces;
  uint32_t seed;
  float p_rr;
};

// A lane's path state between bounces.
struct PathState {
  V3 pos, nrm, kd, emit, col, tp;
};

// rows of a scratch plane: the 18 state rows, then the 3 sums
constexpr int kScratchRows = 21;
// floats of a done lane's row: its state, its sums, live, 2 of padding
constexpr int kDoneRows = 24;
constexpr int kDoneVecs = kDoneRows / 4;

// One bounce b of the lane `lane` in state `s` with its sum `acc`:
// sampleLight, roulette, the hemisphere, both traces through
// `trace(o, ll, w, &A, &B)`, the NEE term. An active lane adds the term
// to acc and takes the state update; returns whether it lives on (false
// for an inactive one, which changes nothing).
template <typename Trace>
__device__ __forceinline__ bool bounce_step(const BounceParams& p, uint32_t lane_u,
                                            int b, bool active, PathState& s,
                                            float acc[3], Trace trace) {
  const int n_e = p.n_emitters;
  const bool any_e = n_e > 0;
  const float n_e_f = (float)max(n_e, 1);
  const uint32_t c0 = (uint32_t)(12 * b);
  const V3 pos = s.pos, kd = s.kd, tp = s.tp;
  const V3 nn = norm3(s.nrm.x, s.nrm.y, s.nrm.z, 0.0f);

  // ---- sampleLight (Scene.cpp:429-476): draws 1-9
  const float u_pick = uniform1(p.seed, lane_u, c0 + 1u);
  const int k_e = min((int)floorf(u_pick * n_e_f), max(n_e - 1, 0));
  const float* e = p.ecr + 4 * k_e;
  const V3 cc = {e[0], e[1], e[2]};
  const float crad = e[3];
  const V3 bl = norm3(cc.x - pos.x, cc.y - pos.y, cc.z - pos.z, 0.0f);
  const V3 g = gauss3(p.seed, lane_u, c0 + 2u);
  V3 sd = norm3(g.x, g.y, g.z, 1e-20f);
  if (sd.x * bl.x + sd.y * bl.y + sd.z * bl.z < 0.0f) sd = {-sd.x, -sd.y, -sd.z};
  const V3 hg = gauss3(p.seed, lane_u, c0 + 6u);
  const V3 h = norm3(hg.x, hg.y, hg.z, 1e-20f);
  sd = norm3(sd.x + 1e-6f * h.x, sd.y + 1e-6f * h.y, sd.z + 1e-6f * h.z, 0.0f);
  const V3 sp = {cc.x + sd.x * crad, cc.y + sd.y * crad, cc.z + sd.z * crad};
  const V3 ll = norm3(sp.x - pos.x, sp.y - pos.y, sp.z - pos.z, 0.0f);
  const float cos_t = ll.x * bl.x + ll.y * bl.y + ll.z * bl.z;
  const float pdf_l = any_e ? cos_t * kInv2Pi : 0.0f;

  // ---- RR + uniform hemisphere (Material.cpp:14-34): draws 10-12
  const float u_rr = uniform1(p.seed, lane_u, c0 + 10u);
  const bool survive = u_rr <= p.p_rr;
  const float x1 = uniform1(p.seed, lane_u, c0 + 11u);
  const float x2 = uniform1(p.seed, lane_u, c0 + 12u);
  const float zl = fabsf(1.0f - 2.0f * x1);
  const float rl = sqrtf(fmaxf(0.0f, 1.0f - zl * zl));
  const float phi = kTwoPi * x2;
  V3 w = to_world(rl * cosf(phi), rl * sinf(phi), zl, nn);
  w = norm3(w.x, w.y, w.z, 0.0f);
  const float wdn = w.x * nn.x + w.y * nn.y + w.z * nn.z;
  const float cos_o = fmaxf(0.0f, wdn);
  const float pdf_b = wdn > 0.0f ? kInv2Pi : 0.0f;
  const V3 fr = wdn > 0.0f
                    ? V3{kd.x * kInvPi, kd.y * kInvPi, kd.z * kInvPi}
                    : V3{0.0f, 0.0f, 0.0f};

  // ---- both traces, one primitive loop
  const V3 o = {pos.x + 1e-6f * nn.x, pos.y + 1e-6f * nn.y,
                pos.z + 1e-6f * nn.z};
  Hit A, B;
  trace(o, ll, w, &A, &B);

  // ---- NEE evaluation (Scene.cpp:671-717)
  const bool hit_a = A.t < kBig;
  const float dx = pos.x - (o.x + ll.x * A.t);
  const float dy = pos.y - (o.y + ll.y * A.t);
  const float dz = pos.z - (o.z + ll.z * A.t);
  const float dist2 = dx * dx + dy * dy + dz * dz;
  const bool not_shadow = fabsf(A.t * A.t - dist2) <= 1e-4f;
  const bool lit = hit_a && len3(A.emit) > kEps && any_e;
  const V3 sn = norm3(A.nrm.x, A.nrm.y, A.nrm.z, 1e-20f);
  const float cos_on = fmaxf(0.0f, nn.x * ll.x + nn.y * ll.y + nn.z * ll.z);
  const float cos_ln =
      fmaxf(0.0f, -(sn.x * ll.x + sn.y * ll.y + sn.z * ll.z));
  const float ldn = ll.x * nn.x + ll.y * nn.y + ll.z * nn.z;
  const bool pdf_ok_l = pdf_l >= kEps && pdf_l < 1e30f && pdf_l == pdf_l;
  const float denom = (pdf_ok_l ? pdf_l : 1.0f) * fmaxf(dist2, 1e-30f);
  const float scale =
      (lit && not_shadow && pdf_ok_l) ? cos_on * cos_ln / denom : 0.0f;
  const bool fr_gate = ldn > 0.0f;
  const float nee_r = A.emit.x * (fr_gate ? kd.x * kInvPi : 0.0f) * scale;
  const float nee_g = A.emit.y * (fr_gate ? kd.y * kInvPi : 0.0f) * scale;
  const float nee_b = A.emit.z * (fr_gate ? kd.z * kInvPi : 0.0f) * scale;
  const bool cur_emissive = len3(s.emit) > kEps;
  if (!active) return false;
  acc[0] = acc[0] + tp.x * (cur_emissive ? s.col.x : nee_r);
  acc[1] = acc[1] + tp.y * (cur_emissive ? s.col.y : nee_g);
  acc[2] = acc[2] + tp.z * (cur_emissive ? s.col.z : nee_b);

  // ---- state update
  const bool hit_b = B.t < kBig;
  const bool emis_b = len3(B.emit) > kEps;
  const float wgt = cos_o / fmaxf(pdf_b * p.p_rr, 1e-30f);
  s.tp = {tp.x * fr.x * wgt, tp.y * fr.y * wgt, tp.z * fr.z * wgt};
  s.pos = {o.x + w.x * B.t, o.y + w.y * B.t, o.z + w.z * B.t};
  s.nrm = norm3(B.nrm.x, B.nrm.y, B.nrm.z, 1e-20f);
  s.kd = B.kd;
  s.emit = B.emit;
  // spheres keep the reference's Properties.color = 0 quirk
  // (Object.hpp:36-40); triangles shade color as Kd
  s.col = B.is_sphere ? V3{0.f, 0.f, 0.f} : B.kd;
  return survive && pdf_b >= kEps && hit_b && !emis_b;
}

// The 18 rows of column `c` of a component-major (18, stride) plane.
__device__ __forceinline__ PathState load_state(const float* st, size_t stride) {
  return {{st[0], st[stride], st[2 * stride]},
          {st[3 * stride], st[4 * stride], st[5 * stride]},
          {st[6 * stride], st[7 * stride], st[8 * stride]},
          {st[9 * stride], st[10 * stride], st[11 * stride]},
          {st[12 * stride], st[13 * stride], st[14 * stride]},
          {st[15 * stride], st[16 * stride], st[17 * stride]}};
}

// The same through L2 (ld.global.cg): a plane another SM wrote in this
// launch.
__device__ __forceinline__ PathState load_state_cg(const float* st, size_t stride) {
  float v[18];
#pragma unroll
  for (int k = 0; k < 18; ++k) v[k] = __ldcg(st + k * stride);
  return {{v[0], v[1], v[2]},    {v[3], v[4], v[5]},    {v[6], v[7], v[8]},
          {v[9], v[10], v[11]},  {v[12], v[13], v[14]}, {v[15], v[16], v[17]}};
}

__device__ __forceinline__ void store_state(float* so, size_t stride,
                                            const PathState& s) {
  so[0] = s.pos.x, so[stride] = s.pos.y, so[2 * stride] = s.pos.z;
  so[3 * stride] = s.nrm.x, so[4 * stride] = s.nrm.y, so[5 * stride] = s.nrm.z;
  so[6 * stride] = s.kd.x, so[7 * stride] = s.kd.y, so[8 * stride] = s.kd.z;
  so[9 * stride] = s.emit.x, so[10 * stride] = s.emit.y, so[11 * stride] = s.emit.z;
  so[12 * stride] = s.col.x, so[13 * stride] = s.col.y, so[14 * stride] = s.col.z;
  so[15 * stride] = s.tp.x, so[16 * stride] = s.tp.y, so[17 * stride] = s.tp.z;
}

// Lane c's outputs: its state, live flag and sum.
__device__ __forceinline__ void write_lane(const BounceParams& p, int c,
                                           const PathState& s, bool live,
                                           const float acc[3]) {
  const size_t n = (size_t)p.n;
  store_state(p.out_state + c, n, s);
  p.out_live[c] = live ? 1 : 0;
  p.acc[c] = acc[0];
  p.acc[n + c] = acc[1];
  p.acc[2 * n + c] = acc[2];
}

// Append column c to `list` where `take`: one ballot and one atomicAdd on
// `count` a warp; returns c's index in the list (or -1). The whole warp
// calls it together.
__device__ __forceinline__ int warp_append(bool take, int c, int* count, int* list) {
  const unsigned m = __ballot_sync(srt::kFullMask, take);
  if (m == 0) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(srt::kFullMask, base, leader);
  if (!take) return -1;
  const int j = base + __popc(m & ((1u << lane) - 1u));
  list[j] = c;
  return j;
}

// Lane c is done: its outputs go to its row of the done plane.
__device__ __forceinline__ void write_done(const BounceParams& p, int c,
                                           const PathState& s, bool live,
                                           const float acc[3]) {
  float4* row = p.done + (size_t)c * kDoneVecs;
  row[0] = {s.pos.x, s.pos.y, s.pos.z, s.nrm.x};
  row[1] = {s.nrm.y, s.nrm.z, s.kd.x, s.kd.y};
  row[2] = {s.kd.z, s.emit.x, s.emit.y, s.emit.z};
  row[3] = {s.col.x, s.col.y, s.col.z, s.tp.x};
  row[4] = {s.tp.y, s.tp.z, acc[0], acc[1]};
  row[5] = {acc[2], live ? 1.0f : 0.0f, 0.0f, 0.0f};
}

// Column c's outputs, from its row of the done plane.
__device__ __forceinline__ void copy_done(const BounceParams& p, int c) {
  const float4* row = p.done + (size_t)c * kDoneVecs;
  float4 v[kDoneVecs];
#pragma unroll
  for (int j = 0; j < kDoneVecs; ++j) v[j] = __ldcg(row + j);
  const PathState s = {{v[0].x, v[0].y, v[0].z}, {v[0].w, v[1].x, v[1].y},
                       {v[1].z, v[1].w, v[2].x}, {v[2].y, v[2].z, v[2].w},
                       {v[3].x, v[3].y, v[3].z}, {v[3].w, v[4].x, v[4].y}};
  const float acc[3] = {v[4].z, v[4].w, v[5].x};
  write_lane(p, c, s, v[5].y != 0.0f, acc);
}

// Entry k of the timeline, if asked for: the device's clock in ns, by one
// thread of the grid.
__device__ __forceinline__ void stamp(const BounceParams& p, int k) {
  if (p.timeline == nullptr || blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  p.timeline[k] = t;
}

// ---- the full sweep, bounce-major (one cooperative launch)
__global__ void __launch_bounds__(kThreads) path_bounce_major(const BounceParams p) {
  extern __shared__ float4 s_rows[];  // the staged table rows
  cg::grid_group grid = cg::this_grid();
  const size_t n = (size_t)p.n;
  const int stride = gridDim.x * kThreads;
  stamp(p, 0);
  if (stage_resident(p.n_tri)) {
    block_stage_rows(s_rows, p.tri, 0, p.n_tri);
    __syncthreads();
  }
  srt::Tally tl;
  LoopTally lt;

  // lanes dead on entry, or every lane when no bounce runs, are done
  // now; the others form the list of bounce 0, in lane order a warp
  for (int c0 = blockIdx.x * kThreads; c0 < p.n; c0 += stride) {
    const int c = c0 + threadIdx.x;
    const bool valid = c < p.n;
    const bool live = valid && p.live[c] != 0;
    if (valid && (!live || p.n_bounces == 0)) {
      const float zero[3] = {0.0f, 0.0f, 0.0f};
      write_done(p, c, load_state(p.state + c, n), live, zero);
    }
    warp_append(live && p.n_bounces > 0, c, p.counts, p.lists);
  }
  grid.sync();
  stamp(p, 1);

  for (int b = 0; b < p.n_bounces; ++b) {
    const int n_cur = __ldcg(p.counts + b % 3);
    if (n_cur == 0) break;  // every thread read the same length
    if (blockIdx.x == 0 && threadIdx.x == 0) p.counts[(b + 2) % 3] = 0;
    const int* cur = p.lists + (size_t)(b & 1) * n;
    int* nxt = p.lists + (size_t)((b + 1) & 1) * n;
    const float* s_in = p.scratch + (size_t)(b & 1) * kScratchRows * n;
    float* s_out = p.scratch + (size_t)((b + 1) & 1) * kScratchRows * n;
    const bool last = b + 1 == p.n_bounces;
    // block-uniform trip count: the staged sweep's barriers need the block
    for (int i0 = blockIdx.x * kThreads; i0 < n_cur; i0 += stride) {
      const int i = i0 + threadIdx.x;
      const bool active = i < n_cur;
      lt.step(active);
      int c = 0;
      PathState s = {};
      float acc[3] = {0.0f, 0.0f, 0.0f};
      if (active) {
        c = __ldcg(cur + i);
        if (b == 0) {
          s = load_state(p.state + c, n);
        } else {
          s = load_state_cg(s_in + i, n);
          acc[0] = __ldcg(s_in + 18 * n + i);
          acc[1] = __ldcg(s_in + 19 * n + i);
          acc[2] = __ldcg(s_in + 20 * n + i);
        }
      }
      const bool live = bounce_step(
          p, (uint32_t)c, b, active, s, acc,
          [&](V3 o, V3 ll, V3 w, Hit* A, Hit* B) {
            dual_trace_block(p.tri, p.attr, p.sph, p.n_tri, p.n_sph, s_rows, o,
                             ll, w, active, A, B, tl);
          });
      if (active && (!live || last)) write_done(p, c, s, live, acc);
      const int j = warp_append(live && !last, c, p.counts + (b + 1) % 3, nxt);
      if (j >= 0) {
        store_state(s_out + j, n, s);
        s_out[18 * n + j] = acc[0];
        s_out[19 * n + j] = acc[1];
        s_out[20 * n + j] = acc[2];
      }
    }
    grid.sync();
    stamp(p, b + 2);
  }
  // every column's outputs, in order
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < p.n; c += stride)
    copy_done(p, c);
  if (p.timeline != nullptr) {
    grid.sync();
    stamp(p, p.n_bounces + 2);
  }
  tl.flush(p.tally);
  lt.flush(p.tally, p.n_tally);
}

// ---- the culled walk, a per-lane loop
__global__ void __launch_bounds__(kThreads) path_bounce_culled(const BounceParams p) {
  extern __shared__ srt::WarpStage s_stage[];  // one a warp
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = lane < p.n;
  const size_t n = (size_t)p.n;
  // a thread past n reads lane 0's state and is never live
  PathState s = load_state(p.state + (valid ? lane : 0), n);
  bool live = valid && p.live[valid ? lane : 0] != 0;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  srt::Tally tl;
  srt::WalkSlots slots;

  for (int b = 0; b < p.n_bounces; ++b) {
    if (!__any_sync(srt::kFullMask, live)) break;
    // the lanes live at the start of this bounce take its result
    const bool active = live;
    const bool next = bounce_step(
        p, (uint32_t)lane, b, active, s, acc,
        [&](V3 o, V3 ll, V3 w, Hit* A, Hit* B) {
          dual_trace_culled(p.tri, p.attr, p.sph, p.n_tri, p.n_sph, p.cull, o, ll,
                            w, active, s_stage[threadIdx.x >> 5], A, B, tl, slots);
        });
    if (active) live = next;
  }

  if (!valid) return;
  write_lane(p, lane, s, live, acc);
  tl.flush(p.tally);
  if (p.tally != nullptr)
    slots.flush(p.n_tally > 2 ? p.tally + 2 : nullptr, p.n_tally > 5 ? p.tally + 5 : nullptr);
}

}  // namespace

// `lo`..`hi3` are the box tables of the culled kernel; with lo null the
// full sweep runs, bounce-major, in `counts` (3 int32, zero), `lists`
// (2 x n int32), `scratch` (2 x 21 x n float32) and `done` (n x 24
// float32, 16-byte aligned), and fills `timeline` if it is not null.
extern "C" int srt_path_bounce(const float* tri, const float* attr,
                               const float* sph, const float* ecr,
                               const float* state, const uint8_t* live,
                               float* out_state, uint8_t* out_live, float* acc,
                               int n_tri, int n_sph, int n_emitters, int n,
                               int n_bounces, int seed, float p_rr,
                               const float* lo, const float* hi,
                               const float* lo2, const float* hi2,
                               const float* lo3, const float* hi3, int nc,
                               int nl, int chunk, int* counts, int* lists,
                               float* scratch, float* done,
                               unsigned long long* tally,
                               int n_tally, unsigned long long* timeline,
                               void* stream) {
  const CullTables ct =
      srt::cull_tables(lo, hi, lo2, hi2, lo3, hi3, nc, nl, chunk);
  if (lo != nullptr && !srt::cull_tables_ok(ct, n_tri))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  BounceParams p{tri,   attr,  sph,        ecr, state,     live,
                 out_state, out_live, acc,
                 ct,        counts,   lists,   scratch,
                 reinterpret_cast<float4*>(done),
                 tally,     n_tally,  timeline,
                 n_tri, n_sph, n_emitters,
                 n,     n_bounces, (uint32_t)seed, p_rr};
  if (lo != nullptr) {
    const int blocks = (n + kThreads - 1) / kThreads;
    path_bounce_culled<<<blocks, kThreads, (kThreads / 32) * srt::kWarpStageBytes,
                         (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  }
  if (counts == nullptr || lists == nullptr || scratch == nullptr ||
      done == nullptr || ((uintptr_t)done & 15) != 0)
    return (int)cudaErrorInvalidValue;
  // the grid: as many blocks as fit on the card at once (a cooperative
  // launch needs them all resident), and no more than the lanes need
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = stage_bytes(n_tri);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, path_bounce_major,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int need = (n + kThreads - 1) / kThreads;
  const int blocks = per_sm * sms < need ? per_sm * sms : need;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)path_bounce_major, blocks,
                                          kThreads, args, smem,
                                          (cudaStream_t)stream);
}
