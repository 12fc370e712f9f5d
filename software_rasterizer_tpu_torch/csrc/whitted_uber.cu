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
// depth) and in a per-thread stack of kMaxDepth refract children (local
// memory, cached in L1). The tables are read from global memory; every
// thread of a warp reads the same row, so the loads broadcast. A textured
// diffuse hit fetches its texel directly, so the TPU kernel's per-lane
// texture slots, and their overflow, have no counterpart.
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

namespace {

constexpr float kEps = 1e-5f;
constexpr float kBig = 1e30f;
constexpr int kMaxDepth = 8;  // ops/whitted_kernel.MAX_DEPTH
constexpr int kAttrCols = 40;
constexpr int kSphCols = 24;

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

struct Nearest {
  float tt;  // nearest triangle t (kBig: none)
  int bf;    // its index
  float st;  // nearest sphere t (kBig: none)
  int bs;    // its index
};

// Nearest triangle and nearest sphere; a strict `<` keeps the lowest
// index on a tie. Sphere rows are rejected by their valid column 7.
__device__ __forceinline__ Nearest trace(const float* __restrict__ tri,
                                         const float* __restrict__ sph,
                                         int n_tri, int n_sph, V3 o, V3 d) {
  Nearest r{kBig, 0, kBig, 0};
  for (int f = 0; f < n_tri; ++f) {
    float u, v;
    bool ok;
    const float t = mt(tri + 12 * f, o, d, &u, &v, &ok);
    const float tm = ok ? t : kBig;
    if (tm < r.tt) {
      r.tt = tm;
      r.bf = f;
    }
  }
  for (int s = 0; s < n_sph; ++s) {
    const float* row = sph + kSphCols * s;
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
  int n_tri, n_sph, n_lanes, tex_h, tex_w, max_depth;
  int n_emitters, spp, lane_offset;
};

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

// The Phong term toward the emitter centre `ec` behind a shadow trace
// (Scene.cpp:509-574), without the ray's weight; false when the shadow
// ray's nearest hit is not an emitter.
__device__ __forceinline__ bool phong_toward(const Params& p, V3 ec, V3 c,
                                             V3 n, V3 d, V3 ka, V3 ks, V3 kd,
                                             float sexp, float shadow_bias,
                                             bool any_e, V3* out) {
  const V3 l = norm3(ec.x - c.x, ec.y - c.y, ec.z - c.z, 0.0f);
  const float ndl = dot3(n, l);
  const float side = ndl >= 0.0f ? 1.0f : -1.0f;
  const float bias =
      shadow_bias *
      fmaxf(fmaxf(fabsf(c.x), fmaxf(fabsf(c.y), fabsf(c.z))), 1.0f);
  const float sb = side * bias;
  const V3 so = {c.x + n.x * sb, c.y + n.y * sb, c.z + n.z * sb};
  const float diff = fmaxf(ndl, 0.0f);
  const float mldn = (-l.x) * n.x + (-l.y) * n.y + (-l.z) * n.z;
  const float m2 = 2.0f * mldn;
  const V3 rl =
      norm3(-l.x - m2 * n.x, -l.y - m2 * n.y, -l.z - m2 * n.z, 0.0f);
  const float sdot = fmaxf(-dot3(d, rl), 0.0f);
  const float spec =
      sdot > 0.0f ? expf(sexp * logf(fmaxf(sdot, 1e-30f)))
                  : (sexp == 0.0f ? 1.0f : 0.0f);

  const Nearest s2 = trace(p.tri, p.sph, p.n_tri, p.n_sph, so, l);
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
  const V3 dl = {l.x * t_sh, l.y * t_sh, l.z * t_sh};
  const float dist2 = dot3(dl, dl);
  // the |t^2 - dist^2| quirk (Scene.cpp:541-545) zeroes the ambient and
  // diffuse terms, not the specular one
  const float amb = fabsf(t_sh * t_sh - dist2) > 1e-6f ? 0.0f : 1.0f;
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

__global__ void __launch_bounds__(128) whitted_uber_kernel(const Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n_lanes) return;
  const V3 ec = {p.scal[0], p.scal[1], p.scal[2]};
  const V3 bg = {p.scal[3], p.scal[4], p.scal[5]};
  const float shadow_bias = p.scal[6];
  const bool any_e = p.scal[7] > 0.0f;

  V3 o = {p.orig[3 * idx], p.orig[3 * idx + 1], p.orig[3 * idx + 2]};
  V3 d = {p.dir[3 * idx], p.dir[3 * idx + 1], p.dir[3 * idx + 2]};
  V3 w = {1.0f, 1.0f, 1.0f};
  int depth = 0, sp = 0;
  uint32_t rid = (uint32_t)(p.lane_offset + idx);
  // refract children: [origin | direction | weight], their depth and id
  float stk[kMaxDepth][9];
  int stk_depth[kMaxDepth];
  uint32_t stk_rid[kMaxDepth];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int n_main = 0, n_diff = 0;

  while (true) {
    ++n_main;
    const Nearest h = trace(p.tri, p.sph, p.n_tri, p.n_sph, o, d);
    const bool use_s = h.st < h.tt;
    bool cont = false;
    if (!(fminf(h.st, h.tt) < kBig)) {
      // ---- miss -> background (Scene.cpp:486-497)
      acc_r = acc_r + w.x * bg.x;
      acc_g = acc_g + w.y * bg.y;
      acc_b = acc_b + w.z * bg.z;
    } else {
      // ---- the winner: exact hit point, normal and material
      V3 c, n, ka, ks, kd;
      int mtype;
      float ior, sexp;
      if (use_s) {
        const float* s = p.sph + kSphCols * h.bs;
        c = {o.x + d.x * h.st, o.y + d.y * h.st, o.z + d.z * h.st};
        n = norm3(c.x - s[0], c.y - s[1], c.z - s[2], 1e-20f);
        mtype = (int)rintf(s[8]);
        ior = s[9];
        ka = {s[10], s[11], s[12]};
        ks = {s[13], s[14], s[15]};
        sexp = s[16];
        kd = {0.0f, 0.0f, 0.0f};  // sphere colour quirk (Object.hpp:36-40)
      } else {
        const float* a = p.attr + kAttrCols * h.bf;
        float u, v;
        bool ok;
        const float t = mt(p.tri + 12 * h.bf, o, d, &u, &v, &ok);
        c = {o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
        const float wb = 1.0f - u - v;
        n = norm3(wb * a[9] + u * a[12] + v * a[15],
                  wb * a[10] + u * a[13] + v * a[16],
                  wb * a[11] + u * a[14] + v * a[17], 1e-20f);
        mtype = (int)rintf(a[30]);
        ior = a[31];
        ka = {a[33], a[34], a[35]};
        ks = {a[36], a[37], a[38]};
        sexp = a[39];
        if (a[32] >= 0.0f) {
          kd = fetch_nearest(p, (int)rintf(a[32]),
                             wb * a[18] + u * a[20] + v * a[22],
                             wb * a[19] + u * a[21] + v * a[23]);
        } else {
          kd = {a[24], a[25], a[26]};
        }
      }

      if (mtype == 0) {
        // ---- Phong toward an emitter's centre behind a shadow trace
        ++n_diff;
        if (p.n_emitters <= 1) {
          V3 v;
          if (phong_toward(p, ec, c, n, d, ka, ks, kd, sexp, shadow_bias,
                           any_e, &v)) {
            acc_r = acc_r + w.x * v.x;
            acc_g = acc_g + w.y * v.y;
            acc_b = acc_b + w.z * v.z;
          }
        } else {
          // mean over the spp emitter picks, regrouped by emitter
          const int* seeds = p.pick_seeds + depth * p.spp;
          float tr = 0.0f, tg = 0.0f, tb = 0.0f;
          for (int k = 0; k < p.n_emitters; ++k) {
            int count = 0;
            for (int j = 0; j < p.spp; ++j)
              count += pick_emitter(rid, (uint32_t)seeds[j], p.n_emitters) == k;
            if (count == 0) continue;
            const float* e = p.ecr + 4 * k;
            V3 v;
            if (phong_toward(p, V3{e[0], e[1], e[2]}, c, n, d, ka, ks, kd,
                             sexp, shadow_bias, any_e, &v)) {
              const float cf = (float)count;
              tr = tr + cf * v.x;
              tg = tg + cf * v.y;
              tb = tb + cf * v.z;
            }
          }
          const float spp_f = (float)p.spp;
          acc_r = acc_r + w.x * (tr / spp_f);
          acc_g = acc_g + w.y * (tg / spp_f);
          acc_b = acc_b + w.z * (tb / spp_f);
        }
      } else if ((mtype == 1 || mtype == 2) && depth < p.max_depth) {
        // ---- Fresnel fork (Tools.cpp:250-293, Scene.cpp:576-614)
        cont = true;
        const bool glass = mtype == 1;
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
    }
    if (!cont) {
      if (sp == 0) break;
      --sp;
      const float* e = stk[sp];
      o = {e[0], e[1], e[2]};
      d = {e[3], e[4], e[5]};
      w = {e[6], e[7], e[8]};
      depth = stk_depth[sp];
      rid = stk_rid[sp];
    }
  }
  p.rgb[3 * idx] = acc_r;
  p.rgb[3 * idx + 1] = acc_g;
  p.rgb[3 * idx + 2] = acc_b;
  p.nray[idx] = n_main;
  p.nray[p.n_lanes + idx] = n_diff;
}

}  // namespace

extern "C" int srt_whitted_uber(const float* tri, const float* attr,
                                const float* sph, const float* scal,
                                const float* ecr, const int* pick_seeds,
                                const uint8_t* atlas, const int* tex_wh,
                                const float* orig, const float* dir,
                                float* rgb, int* nray, int n_tri, int n_sph,
                                int n_lanes, int tex_h, int tex_w,
                                int max_depth, int n_emitters, int spp,
                                int lane_offset, void* stream) {
  if (max_depth < 0 || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  if (n_emitters > 1 && spp < 1) return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0) return 0;
  Params p{tri,   attr,  sph,     scal,  ecr,   pick_seeds, atlas,
           tex_wh, orig, dir,     rgb,   nray,  n_tri,      n_sph,
           n_lanes, tex_h, tex_w, max_depth, n_emitters, spp, lane_offset};
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  whitted_uber_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
