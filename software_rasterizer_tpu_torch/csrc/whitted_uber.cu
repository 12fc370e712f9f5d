// Whitted über-kernel for Hopper (sm_90a).
//
// Replaces ops/pallas_whitted.py::_uber_kernel (behind whitted_uber_trace)
// of the JAX package, together with the texture pass that follows it
// (ops/whitted.py::_apply_tex_slots). One launch walks every lane's whole
// Whitted tree (Scene::whittedRayTracing, Scene.cpp:478-617): nearest hit
// over triangles and spheres; a miss adds weight * background; a diffuse
// hit adds the Phong term toward an emitter's centre behind a shadow
// trace (with several emitters: the mean over `spp` emitter picks, see
// below); a mirror or glass hit below max_depth continues into its reflect
// child and, for glass with a refraction, pushes the refract child; a lane
// with nothing to continue pops its stack and ends when it is empty.
//
// Bound: FP32 ALU work (every node of a tree intersects its ray, and a
// diffuse node also its shadow ray, with every triangle and sphere) and
// divergence between lanes whose DFS paths differ in length: a warp runs
// until its longest tree is done. Design: one thread per lane, 128
// threads a block. All DFS state lives in registers (current ray, weight,
// depth) and in a per-thread stack of K refract children (local memory,
// cached in L1); K is the smallest of 8, 16 and 32 that holds max_depth,
// one instance each, so a shallow render keeps the small stack.
//
// The step is warp-uniform, as the JAX kernel sweeps a whole tile of lanes
// a DFS step (ops/pallas_whitted.py:197): each pass of a warp makes one
// main trace for the lanes that have a ray, then the shadow traces of the
// lanes whose hit is diffuse (one; with several emitters one an emitter,
// in ascending order, for the lanes whose picks count it), each called by
// all 32 threads together. A thread whose tree is done, or that lies past
// n_lanes, stays in the loop as an inactive lane until no lane of its warp
// is live. A lane's rays, stack and sums are those of a thread that walks
// its tree alone; only the interleaving across lanes differs, so the frame
// keeps its bits.
//
// Large scenes (the culled instances, kCull): the main trace and each
// shadow trace go through the warp walk (trace_common.cuh
// warp_walk_chunks): each ray's slab tests on the super, chunk and leaf
// boxes (those of the chunks and leaves one a thread where few rays of the
// warp enter their box), the warp ballots every entered leaf, stages its rows in
// shared memory (a WarpStage a warp) and tests them for one entering ray
// at a time with the kernel's own `mt`; the winner is the full sweep's,
// pixel for pixel. The full-sweep instance reads the table from global
// memory; the active threads of a warp read the same row, so the loads
// broadcast. A textured diffuse hit fetches its texel directly, so the
// TPU kernel's per-lane texture slots, and their overflow, have no
// counterpart.
//
// Several emitters (the JAX package serves these by its wavefront,
// ops/whitted.py:214-265): a ray carries the id `rid`, the absolute pixel
// id at depth 0, 2 rid + 1 for a reflect child and 2 rid + 2 for a
// refract child. At a diffuse hit of depth d, sample s picks emitter
// min(floor(u * n_e), n_e - 1) with u one lowbias32 round of rid ^
// pick_seeds[d][s]; the term is sum_o count_o * v(o) / spp in ascending
// o, v(o) the Phong term toward emitter o's centre. The counts are
// recounted for each emitter from the hashes (spp hashes cost less than
// one shadow trace), so there is no array of counts and no cap on the
// number of emitters. A scene with one emitter shades toward that
// emitter and reads neither the seeds nor the ray id.
//
// Semantics are the JAX kernel's: exact Moller-Trumbore with the same
// thresholds (the TPU's bilinear MXU form is not carried over), the lowest
// index wins a tie and a triangle beats a sphere on a tie, the hit point
// from the winner's exact t, the three EPSILON offset rules, the shadow
// bias and the |t^2 - dist^2| quirk. Build with -fmad=false and without
// fast math, so every multiply and add rounds on its own as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using srt::CullTables;
using srt::kFullMask;

constexpr float kEps = 1e-5f;
constexpr float kBig = 1e30f;
constexpr int kMaxDepth = 32;  // ops/whitted_kernel.MAX_DEPTH
constexpr int kAttrCols = 40;
constexpr int kSphCols = 24;
constexpr int kThreads = 128;
// blocks an SM asked of the compiler, which caps the registers a thread.
// Culled: four blocks' WarpStages fill the SM's shared memory, so 4 (128
// registers; asked for 1 it took 135 and ran 3 blocks, 1.16x / 1.17x the
// time on an H100 at 9,216 / 147,456 triangles). Full sweep: 6 (80
// registers), up to 3% less time on the Cornell scenes than unasked (95
// registers, 5 blocks) or 8 (64 registers and a 208-byte spill).
constexpr int kMinBlocksCull = 4;
constexpr int kMinBlocksFull = 6;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// _norm3: zero vector when |v| <= eps (or |v| == 0).
__device__ __forceinline__ V3 norm3(float x, float y, float z, float eps) {
  float n = sqrtf(x * x + y * y + z * z);
  float inv = n > 0.0f ? 1.0f / n : 0.0f;
  inv = n > eps ? inv : 0.0f;
  return {x * inv, y * inv, z * inv};
}

// Moller-Trumbore on a [v0|e1|e2] row: the raw t, u and v, and whether
// the reference thresholds accept the hit.
__device__ __forceinline__ float mt(const float* g, V3 o, V3 d, float* u_out,
                                    float* v_out, bool* ok) {
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  float px = d.y * e2z - d.z * e2y;
  float py = d.z * e2x - d.x * e2z;
  float pz = d.x * e2y - d.y * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
  float tx = o.x - g[0], ty = o.y - g[1], tz = o.z - g[2];
  float u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (d.x * qx + d.y * qy + d.z * qz) * inv;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  *ok = fabsf(det) >= 1e-6f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
        u + v <= 1.0f && t >= 1e-6f;
  *u_out = u;
  *v_out = v;
  return t;
}

// t of the ray (o, d) at row g where the thresholds accept the hit, else kBig
__device__ __forceinline__ float mt_t(const float* g, V3 o, V3 d) {
  float u, v;
  bool ok;
  const float t = mt(g, o, d, &u, &v, &ok);
  return ok ? t : kBig;
}

struct Nearest {
  float tt;  // nearest triangle t (kBig: none)
  int bf;    // its index
  float st;  // nearest sphere t (kBig: none)
  int bs;    // its index
};

// What the traces of one kind of ray (main or shadow) cost: the (ray,
// row) and slab tests of its lanes, and the row-test slots (32 a row-step
// of the warp) and box-test slots its warps issued.
struct TraceTally {
  srt::Tally tests;
  srt::WalkSlots slots;
};

struct Params {
  const float* tri;      // (F,12) [v0|e1|e2|pad]
  const float* attr;     // (F,40) pack_uber_tables rows
  const float* sph;      // (S,24) [c|r|emit|valid|type|ior|ka|ks|spec|pad]
  const float* scal;     // (8,) [emitter centre|background|bias|any emitter]
  const float* ecr;      // (O,4) emitter [centre|radius] rows
  const int* pick_seeds;  // (max_depth+1, spp) seeds of the emitter picks
  const uint8_t* atlas;  // (K,Hm,Wm,3) u8
  const int* tex_wh;     // (K,2) (width, height)
  const float* orig;     // (N,3)
  const float* dir;      // (N,3)
  float* rgb;            // (N,3)
  int* nray;             // (2,N) [main rays traced, diffuse hits]
  CullTables cull;       // read by the culled instances only
  // (2,4) [main | shadow] x [row tests, slab tests, row-test slots, box-test
  // slots] added, or null
  unsigned long long* tally;
  int n_tri, n_sph, n_lanes, tex_h, tex_w, max_depth;
  int n_emitters, spp, lane_offset;
};

// Nearest triangle and nearest sphere of the ray (o, d) for the `active`
// threads; a strict `<` keeps the lowest index on a tie. Sphere rows are
// rejected by their valid column 7. The culled instance tests the rows of
// the chunks the ray enters (the warp walk), the other every row. The
// whole warp calls it; an inactive thread tests nothing and gets misses.
template <bool kCull>
__device__ __forceinline__ Nearest trace(const Params& p, V3 o, V3 d,
                                         bool active, srt::WarpStage& stage,
                                         TraceTally& tt) {
  Nearest r{kBig, 0, kBig, 0};
  if (!__any_sync(kFullMask, active)) return r;
  if (kCull) {
    const srt::RowHit best = srt::warp_walk_chunks(
        srt::Ray{o.x, o.y, o.z, d.x, d.y, d.z}, active, p.cull, p.tri, p.n_tri,
        stage,
        [](const float* g, const srt::Ray& rl) {
          return mt_t(g, V3{rl.ox, rl.oy, rl.oz}, V3{rl.dx, rl.dy, rl.dz});
        },
        tt.tests, tt.slots);
    if (best.row >= 0) {
      r.tt = best.t;
      r.bf = best.row;
    }
  } else {
    tt.slots.rows += 32ull * (unsigned)p.n_tri;
    if (active) {
      tt.tests.rows += (uint32_t)p.n_tri;
      for (int f = 0; f < p.n_tri; ++f) {
        const float tm = mt_t(p.tri + 12 * f, o, d);
        if (tm < r.tt) {
          r.tt = tm;
          r.bf = f;
        }
      }
    }
  }
  if (!active) return r;
  for (int s = 0; s < p.n_sph; ++s) {
    const float* row = p.sph + kSphCols * s;
    const float rr = row[3];
    const V3 l = {o.x - row[0], o.y - row[1], o.z - row[2]};
    float a = d.x * d.x + d.y * d.y + d.z * d.z;
    float b = 2.0f * (d.x * l.x + d.y * l.y + d.z * l.z);
    float c0 = l.x * l.x + l.y * l.y + l.z * l.z - rr * rr;
    float disc = b * b - 4.0f * a * c0;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
    q = q == 0.0f ? 1e-30f : q;
    float x0 = q / a;
    float x1 = c0 / q;
    bool both = x0 > 0.0f && x1 > 0.0f;
    float ts = both ? fminf(x0, x1) : (x0 > 0.0f ? x0 : x1);
    ts = (disc >= 0.0f && ts > 0.0f && row[7] > 0.0f) ? ts : kBig;
    if (ts < r.st) {
      r.st = ts;
      r.bs = s;
    }
  }
  return r;
}

// fetch_nearest (TextureLoader.cpp:14-31): uv clamped to [0,1],
// x = int(u*w), y = int(v*h), out of range -> black, texels u8/255.
__device__ __forceinline__ V3 fetch_nearest(const Params& p, int tid,
                                            float uvx, float uvy) {
  const int w = p.tex_wh[2 * tid], h = p.tex_wh[2 * tid + 1];
  const int x = (int)(fminf(fmaxf(uvx, 0.0f), 1.0f) * (float)w);
  const int y = (int)(fminf(fmaxf(uvy, 0.0f), 1.0f) * (float)h);
  if (x >= w || y >= h) return {0.0f, 0.0f, 0.0f};
  const uint8_t* px =
      p.atlas + (((size_t)tid * p.tex_h + y) * p.tex_w + x) * 3;
  return {(float)px[0] / 255.0f, (float)px[1] / 255.0f,
          (float)px[2] / 255.0f};
}

// The hit point, shading normal and material of a main ray's winner.
struct Surface {
  V3 c, n, ka, ks, kd;
  int mtype;
  float ior, sexp;
};

// The Phong term toward the emitter centre `ec` behind a shadow trace
// (Scene.cpp:509-574), without the ray's weight; false when the shadow
// ray's nearest hit is not an emitter. The whole warp calls it; a thread
// that is not `active` traces nothing and gets false.
template <bool kCull>
__device__ __forceinline__ bool phong_toward(const Params& p, V3 ec,
                                             const Surface& sf, V3 d,
                                             bool active, float shadow_bias,
                                             bool any_e, V3* out,
                                             srt::WarpStage& stage,
                                             TraceTally& tt) {
  const V3 c = sf.c, n = sf.n;
  const V3 l = norm3(ec.x - c.x, ec.y - c.y, ec.z - c.z, 0.0f);
  const float ndl = dot3(n, l);
  const float side = ndl >= 0.0f ? 1.0f : -1.0f;
  const float bias =
      shadow_bias *
      fmaxf(fmaxf(fabsf(c.x), fmaxf(fabsf(c.y), fabsf(c.z))), 1.0f);
  const float sb = side * bias;
  const V3 so = {c.x + n.x * sb, c.y + n.y * sb, c.z + n.z * sb};

  const Nearest s2 = trace<kCull>(p, so, l, active, stage, tt);
  if (!active) return false;
  const bool use_s2 = s2.st < s2.tt;
  const float t_sh = use_s2 ? s2.st : s2.tt;
  V3 em = {0.0f, 0.0f, 0.0f};
  if (use_s2) {
    const float* s = p.sph + kSphCols * s2.bs;
    em = {s[4], s[5], s[6]};
  } else if (s2.tt < kBig) {
    const float* a = p.attr + kAttrCols * s2.bf;
    em = {a[27], a[28], a[29]};
  }
  const bool lit = t_sh < kBig && sqrtf(dot3(em, em)) >= kEps && any_e;
  if (!lit) return false;
  const float diff = fmaxf(ndl, 0.0f);
  const float mldn = (-l.x) * n.x + (-l.y) * n.y + (-l.z) * n.z;
  const float m2 = 2.0f * mldn;
  const V3 rl =
      norm3(-l.x - m2 * n.x, -l.y - m2 * n.y, -l.z - m2 * n.z, 0.0f);
  const float sdot = fmaxf(-dot3(d, rl), 0.0f);
  const float spec =
      sdot > 0.0f ? expf(sf.sexp * logf(fmaxf(sdot, 1e-30f)))
                  : (sf.sexp == 0.0f ? 1.0f : 0.0f);
  const V3 dl = {l.x * t_sh, l.y * t_sh, l.z * t_sh};
  const float dist2 = dot3(dl, dl);
  // the |t^2 - dist^2| quirk (Scene.cpp:541-545) zeroes the ambient and
  // diffuse terms, not the specular one
  const float amb = fabsf(t_sh * t_sh - dist2) > 1e-6f ? 0.0f : 1.0f;
  const V3 ka = sf.ka, ks = sf.ks, kd = sf.kd;
  *out = {amb * (ka.x + diff * kd.x) * em.x + spec * ks.x * em.x,
          amb * (ka.y + diff * kd.y) * em.y + spec * ks.y * em.y,
          amb * (ka.z + diff * kd.z) * em.z + spec * ks.z * em.z};
  return true;
}

// utils/rng.lane_uniforms: one lowbias32 round of rid ^ seed, and the
// emitter it picks among n_e.
__device__ __forceinline__ int pick_emitter(uint32_t rid, uint32_t seed,
                                            int n_e) {
  uint32_t x = rid ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float u = (float)(int)(x >> 8) * (1.0f / 16777216.0f);
  return min((int)floorf(u * (float)n_e), n_e - 1);
}

// K: the stack's entries, at least max_depth (a refract child is pushed
// at most once a depth level).
template <bool kCull, int K>
__global__ void __launch_bounds__(kThreads, kCull ? kMinBlocksCull : kMinBlocksFull)
whitted_uber_kernel(const Params p) {
  extern __shared__ srt::WarpStage s_stage[];  // culled: one a warp
  srt::WarpStage& stage = s_stage[threadIdx.x >> 5];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = idx < p.n_lanes;
  const int li = valid ? idx : 0;
  const V3 ec = {p.scal[0], p.scal[1], p.scal[2]};
  const V3 bg = {p.scal[3], p.scal[4], p.scal[5]};
  const float shadow_bias = p.scal[6];
  const bool any_e = p.scal[7] > 0.0f;

  V3 o = {p.orig[3 * li], p.orig[3 * li + 1], p.orig[3 * li + 2]};
  V3 d = {p.dir[3 * li], p.dir[3 * li + 1], p.dir[3 * li + 2]};
  V3 w = {1.0f, 1.0f, 1.0f};
  int depth = 0, sp = 0;
  uint32_t rid = (uint32_t)(p.lane_offset + li);
  // refract children: [origin | direction | weight], their depth and id
  float stk[K][9];
  int stk_depth[K];
  uint32_t stk_rid[K];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int n_main = 0, n_diff = 0;
  TraceTally t_main, t_shadow;
  bool live = valid;

  // a pass: one DFS step of every live lane of the warp
  while (__any_sync(kFullMask, live)) {
    if (live) ++n_main;
    const Nearest h = trace<kCull>(p, o, d, live, stage, t_main);
    const bool hit = live && fminf(h.st, h.tt) < kBig;
    if (live && !hit) {
      // ---- miss -> background (Scene.cpp:486-497)
      acc_r = acc_r + w.x * bg.x;
      acc_g = acc_g + w.y * bg.y;
      acc_b = acc_b + w.z * bg.z;
    }
    // ---- the winner: exact hit point, normal and material
    Surface sf = {};
    if (hit) {
      if (h.st < h.tt) {
        const float* s = p.sph + kSphCols * h.bs;
        sf.c = {o.x + d.x * h.st, o.y + d.y * h.st, o.z + d.z * h.st};
        sf.n = norm3(sf.c.x - s[0], sf.c.y - s[1], sf.c.z - s[2], 1e-20f);
        sf.mtype = (int)rintf(s[8]);
        sf.ior = s[9];
        sf.ka = {s[10], s[11], s[12]};
        sf.ks = {s[13], s[14], s[15]};
        sf.sexp = s[16];
        sf.kd = {0.0f, 0.0f, 0.0f};  // sphere colour quirk (Object.hpp:36-40)
      } else {
        const float* a = p.attr + kAttrCols * h.bf;
        float u, v;
        bool ok;
        const float t = mt(p.tri + 12 * h.bf, o, d, &u, &v, &ok);
        sf.c = {o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
        const float wb = 1.0f - u - v;
        sf.n = norm3(wb * a[9] + u * a[12] + v * a[15],
                     wb * a[10] + u * a[13] + v * a[16],
                     wb * a[11] + u * a[14] + v * a[17], 1e-20f);
        sf.mtype = (int)rintf(a[30]);
        sf.ior = a[31];
        sf.ka = {a[33], a[34], a[35]};
        sf.ks = {a[36], a[37], a[38]};
        sf.sexp = a[39];
        if (a[32] >= 0.0f) {
          sf.kd = fetch_nearest(p, (int)rintf(a[32]),
                                wb * a[18] + u * a[20] + v * a[22],
                                wb * a[19] + u * a[21] + v * a[23]);
        } else {
          sf.kd = {a[24], a[25], a[26]};
        }
      }
    }

    // ---- Phong toward an emitter's centre behind a shadow trace
    const bool diffuse = hit && sf.mtype == 0;
    if (diffuse) ++n_diff;
    if (p.n_emitters <= 1) {
      V3 v;
      if (phong_toward<kCull>(p, ec, sf, d, diffuse, shadow_bias, any_e, &v,
                              stage, t_shadow)) {
        acc_r = acc_r + w.x * v.x;
        acc_g = acc_g + w.y * v.y;
        acc_b = acc_b + w.z * v.z;
      }
    } else {
      // mean over the spp emitter picks, regrouped by emitter: a shadow
      // trace an emitter, for the lanes whose picks count it
      const int* seeds = p.pick_seeds + depth * p.spp;
      float tr = 0.0f, tg = 0.0f, tb = 0.0f;
      for (int k = 0; k < p.n_emitters; ++k) {
        int count = 0;
        if (diffuse)
          for (int j = 0; j < p.spp; ++j)
            count += pick_emitter(rid, (uint32_t)seeds[j], p.n_emitters) == k;
        if (!__any_sync(kFullMask, count > 0)) continue;
        const float* e = p.ecr + 4 * k;
        V3 v;
        if (phong_toward<kCull>(p, V3{e[0], e[1], e[2]}, sf, d, count > 0,
                                shadow_bias, any_e, &v, stage, t_shadow)) {
          const float cf = (float)count;
          tr = tr + cf * v.x;
          tg = tg + cf * v.y;
          tb = tb + cf * v.z;
        }
      }
      if (diffuse) {
        const float spp_f = (float)p.spp;
        acc_r = acc_r + w.x * (tr / spp_f);
        acc_g = acc_g + w.y * (tg / spp_f);
        acc_b = acc_b + w.z * (tb / spp_f);
      }
    }

    bool cont = false;
    if (hit && (sf.mtype == 1 || sf.mtype == 2) && depth < p.max_depth) {
      // ---- Fresnel fork (Tools.cpp:250-293, Scene.cpp:576-614)
      cont = true;
      const V3 c = sf.c, n = sf.n;
      const float ior = sf.ior;
      const bool glass = sf.mtype == 1;
      const float cosi = fminf(fmaxf(dot3(d, n), -1.0f), 1.0f);
      const bool exiting = cosi > 0.0f;
      const float etai = exiting ? ior : 1.0f;
      const float etat = exiting ? 1.0f : ior;
      const float sint =
          etai / etat * sqrtf(fmaxf(1.0f - cosi * cosi, 0.0f));
      const float cost = sqrtf(fmaxf(1.0f - sint * sint, 0.0f));
      const float ci = fabsf(cosi);
      const float rs = (etat * ci - etai * cost) / (etat * ci + etai * cost);
      const float rp = (etai * ci - etat * cost) / (etai * ci + etat * cost);
      float kr = sint >= 1.0f ? 1.0f : (rs * rs + rp * rp) * 0.5f;
      kr = fminf(fmaxf(kr, 0.0f), 1.0f);
      const float c2 = 2.0f * cosi;
      const V3 rf = norm3(d.x - c2 * n.x, d.y - c2 * n.y, d.z - c2 * n.z,
                          0.0f);
      const bool entering = cosi < 0.0f;
      const float r_etai = entering ? 1.0f : ior;
      const float r_etat = entering ? ior : 1.0f;
      const V3 nn2 = entering ? n : V3{-n.x, -n.y, -n.z};
      const float eta = r_etai / r_etat;
      const float kk = 1.0f - eta * eta * (1.0f - ci * ci);
      const float rr_s = eta * ci - sqrtf(fmaxf(kk, 0.0f));
      V3 rr = kk < 0.0f ? V3{0.0f, 0.0f, 0.0f}
                        : V3{eta * d.x + rr_s * nn2.x,
                             eta * d.y + rr_s * nn2.y,
                             eta * d.z + rr_s * nn2.z};
      const bool has_refr =
          sqrtf(dot3(rr, rr)) > 1e-6f && fabsf(kr - 1.0f) > 1e-6f;
      rr = norm3(rr.x, rr.y, rr.z, 1e-20f);
      // three offset rules: glass reflect by I.N, mirror reflect by
      // R.N, refract by I.N the other way
      const float side_g = cosi < 0.0f ? 1.0f : -1.0f;
      const float side_m = dot3(rf, n) > 0.0f ? 1.0f : -1.0f;
      const float side_r = cosi > 0.0f ? 1.0f : -1.0f;
      const float refl_side = glass ? side_g : side_m;
      if (glass && has_refr) {
        float* e = stk[sp];
        e[0] = c.x + n.x * side_r * kEps;
        e[1] = c.y + n.y * side_r * kEps;
        e[2] = c.z + n.z * side_r * kEps;
        e[3] = rr.x;
        e[4] = rr.y;
        e[5] = rr.z;
        e[6] = w.x * (1.0f - kr);
        e[7] = w.y * (1.0f - kr);
        e[8] = w.z * (1.0f - kr);
        stk_depth[sp] = depth + 1;
        stk_rid[sp] = 2u * rid + 2u;
        ++sp;
      }
      o = {c.x + n.x * refl_side * kEps, c.y + n.y * refl_side * kEps,
           c.z + n.z * refl_side * kEps};
      d = rf;
      const float refl_w = glass ? kr : 1.0f;
      w = {w.x * refl_w, w.y * refl_w, w.z * refl_w};
      ++depth;
      rid = 2u * rid + 1u;
    }
    // a specular hit at max_depth adds nothing: the reference's black
    if (live && !cont) {
      if (sp == 0) {
        live = false;
      } else {
        --sp;
        const float* e = stk[sp];
        o = {e[0], e[1], e[2]};
        d = {e[3], e[4], e[5]};
        w = {e[6], e[7], e[8]};
        depth = stk_depth[sp];
        rid = stk_rid[sp];
      }
    }
  }
  if (valid) {
    p.rgb[3 * idx] = acc_r;
    p.rgb[3 * idx + 1] = acc_g;
    p.rgb[3 * idx + 2] = acc_b;
    p.nray[idx] = n_main;
    p.nray[p.n_lanes + idx] = n_diff;
  }
  if (p.tally != nullptr) {
    t_main.tests.flush(p.tally);
    t_shadow.tests.flush(p.tally + 4);
    t_main.slots.flush(p.tally + 2, p.tally + 3);
    t_shadow.slots.flush(p.tally + 6, p.tally + 7);
  }
}

template <bool kCull>
void launch(const Params& p, int blocks, cudaStream_t s) {
  const size_t shmem = kCull ? (kThreads / 32) * srt::kWarpStageBytes : 0;
  if (p.max_depth <= 8)
    whitted_uber_kernel<kCull, 8><<<blocks, kThreads, shmem, s>>>(p);
  else if (p.max_depth <= 16)
    whitted_uber_kernel<kCull, 16><<<blocks, kThreads, shmem, s>>>(p);
  else
    whitted_uber_kernel<kCull, kMaxDepth><<<blocks, kThreads, shmem, s>>>(p);
}

}  // namespace

// `lo`..`hi3` are the box tables of the culled instances; with lo null
// a full-sweep instance runs.
extern "C" int srt_whitted_uber(const float* tri, const float* attr,
                                const float* sph, const float* scal,
                                const float* ecr, const int* pick_seeds,
                                const uint8_t* atlas, const int* tex_wh,
                                const float* orig, const float* dir,
                                float* rgb, int* nray, int n_tri, int n_sph,
                                int n_lanes, int tex_h, int tex_w,
                                int max_depth, int n_emitters, int spp,
                                int lane_offset, const float* lo,
                                const float* hi, const float* lo2,
                                const float* hi2, const float* lo3,
                                const float* hi3, int nc, int nl, int chunk,
                                unsigned long long* tally, void* stream) {
  const CullTables ct =
      srt::cull_tables(lo, hi, lo2, hi2, lo3, hi3, nc, nl, chunk);
  if (max_depth < 0 || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  if (n_emitters > 1 && spp < 1) return (int)cudaErrorInvalidValue;
  if (lo != nullptr && !srt::cull_tables_ok(ct, n_tri))
    return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0) return 0;
  Params p{tri,   attr,  sph,     scal,  ecr,   pick_seeds, atlas,
           tex_wh, orig, dir,     rgb,   nray,  ct,         tally, n_tri,
           n_sph, n_lanes, tex_h, tex_w, max_depth, n_emitters, spp,
           lane_offset};
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  if (lo != nullptr)
    launch<true>(p, blocks, (cudaStream_t)stream);
  else
    launch<false>(p, blocks, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
