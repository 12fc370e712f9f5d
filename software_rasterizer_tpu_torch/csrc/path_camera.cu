// Persistent path-tracing camera kernel for Hopper (sm_90a).
//
// Replaces ops/pallas_path.py::_pt_kernel (its mm=False mode, behind
// fused_path_camera_render) of the JAX package: one launch renders
// `spp` path-traced samples of every pixel lane in [lane_offset,
// lane_offset + n_lanes): camera ray, primary trace, the Russian-roulette
// bounce loop with an NEE shadow ray and a bounce ray that share one
// triangle loop, and sample regeneration (a lane whose path ends restarts
// its pixel's next sample on the bounce-ray slot).
//
// Bound: FP32 ALU work. Each loop iteration intersects two rays with
// every triangle, about 60 flops per triangle per ray, and the scene
// tables are a few KB that stay in L1/L2. Design: one thread per pixel
// lane (128 threads a block) runs its own loop; all path state lives in
// registers, and device memory is touched only to read the tables (every
// thread of a warp reads the same triangle row, so the loads broadcast)
// and to write the (3, n) sum once at the end.
//
// Semantics are the JAX kernel's, lane for lane: the same lowbias32
// draws keyed by (sample seed, absolute lane, depth*8 + slot), the same
// thresholds and tie rules, the same quirks. Build with -fmad=false and
// without fast math, so every multiply and add rounds on its own as in
// the plain PyTorch version and in XLA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv2Pi = 0.15915494309189535f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kEps = 1e-5f;
constexpr float kBig = 1e30f;

struct V3 {
  float x, y, z;
};

// _RngDyn.uniform: two lowbias32 rounds, 24-bit float in [0, 1).
__device__ __forceinline__ float uniform(uint32_t seed, uint32_t lane,
                                         uint32_t ctr) {
  uint32_t c = ctr * 0x85EBCA6Bu + seed;
  c ^= c >> 16;
  c *= 0x7FEB352Du;
  c ^= c >> 15;
  uint32_t x = (lane * 0x9E3779B1u) ^ c;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(int)(x >> 8) * (1.0f / 16777216.0f);
}

// _norm3: zero vector when |v| <= eps (or |v| == 0).
__device__ __forceinline__ V3 norm3(float x, float y, float z, float eps) {
  float n = sqrtf(x * x + y * y + z * z);
  float inv = n > 0.0f ? 1.0f / n : 0.0f;
  inv = n > eps ? inv : 0.0f;
  return {x * inv, y * inv, z * inv};
}

// _to_world (Tools::toWorld, Tools.cpp:315-327).
__device__ __forceinline__ V3 to_world(float lx, float ly, float lz, V3 n) {
  bool use_x = fabsf(n.x) > fabsf(n.y);
  float inv_a = 1.0f / sqrtf(fmaxf(n.x * n.x + n.z * n.z, 1e-30f));
  float inv_b = 1.0f / sqrtf(fmaxf(n.y * n.y + n.z * n.z, 1e-30f));
  float cx = use_x ? n.z * inv_a : 0.0f;
  float cy = use_x ? 0.0f : n.z * inv_b;
  float cz = use_x ? -n.x * inv_a : -n.y * inv_b;
  float bx = cy * n.z - cz * n.y;
  float by = cz * n.x - cx * n.z;
  float bz = cx * n.y - cy * n.x;
  return {lx * bx + ly * cx + lz * n.x, lx * by + ly * cy + lz * n.y,
          lx * bz + ly * cz + lz * n.z};
}

// glm::sphericalRand's (z, phi) unit-sphere draw from two slots.
__device__ __forceinline__ V3 sphere_dir(uint32_t seed, uint32_t lane,
                                         uint32_t ctr) {
  float z = 1.0f - 2.0f * uniform(seed, lane, ctr);
  float r = sqrtf(fmaxf(0.0f, 1.0f - z * z));
  float phi = kTwoPi * uniform(seed, lane, ctr + 1u);
  return {r * cosf(phi), r * sinf(phi), z};
}

struct Hit {
  float t;
  V3 nrm, kd, emit;
  bool is_sphere;
};

// Moller-Trumbore with the reference thresholds; kBig on a miss.
__device__ __forceinline__ float mt(V3 d, V3 tv, V3 q, V3 e1, V3 e2,
                                    float* u_out, float* v_out) {
  float px = d.y * e2.z - d.z * e2.y;
  float py = d.z * e2.x - d.x * e2.z;
  float pz = d.x * e2.y - d.y * e2.x;
  float det = e1.x * px + e1.y * py + e1.z * pz;
  float inv = 1.0f / (fabsf(det) < 1e-6f ? 1.0f : det);
  float u = (tv.x * px + tv.y * py + tv.z * pz) * inv;
  float v = (d.x * q.x + d.y * q.y + d.z * q.z) * inv;
  float t = (e2.x * q.x + e2.y * q.y + e2.z * q.z) * inv;
  bool ok = fabsf(det) >= 1e-6f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
            u + v <= 1.0f && t >= 1e-6f;
  *u_out = u;
  *v_out = v;
  return ok ? t : kBig;
}

// Sphere quadratic (the JAX kernel's hit_sph); kBig on a miss.
__device__ __forceinline__ float hit_sphere(V3 d, V3 l, float c0,
                                            bool valid) {
  float a = d.x * d.x + d.y * d.y + d.z * d.z;
  float b = 2.0f * (d.x * l.x + d.y * l.y + d.z * l.z);
  float disc = b * b - 4.0f * a * c0;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  q = q == 0.0f ? 1e-30f : q;
  float x0 = q / a;
  float x1 = c0 / q;
  bool both = x0 > 0.0f && x1 > 0.0f;
  float t = both ? fminf(x0, x1) : (x0 > 0.0f ? x0 : x1);
  bool ok = disc >= 0.0f && t > 0.0f && valid;
  return ok ? t : kBig;
}

// _dual_trace: nearest hits of the shadow ray A (o, la) and the bounce
// ray B (o, lb) in one pass over triangles, then spheres. A strict `<`
// keeps the lowest index on a tie, and triangles ahead of spheres.
__device__ __forceinline__ void dual_trace(
    const float* __restrict__ tri, const float* __restrict__ attr,
    const float* __restrict__ sph, int n_tri, int n_sph, V3 o, V3 la, V3 lb,
    Hit* A, Hit* B) {
  *A = {kBig, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, false};
  *B = *A;
  for (int f = 0; f < n_tri; ++f) {
    const float* g = tri + 12 * f;
    const float* at = attr + 16 * f;
    V3 e1 = {g[3], g[4], g[5]};
    V3 e2 = {g[6], g[7], g[8]};
    V3 tv = {o.x - g[0], o.y - g[1], o.z - g[2]};
    V3 q = {tv.y * e1.z - tv.z * e1.y, tv.z * e1.x - tv.x * e1.z,
            tv.x * e1.y - tv.y * e1.x};
    float u, v;
    float tm = mt(la, tv, q, e1, e2, &u, &v);
    if (tm < A->t) {
      float w = 1.0f - u - v;
      A->t = tm;
      A->nrm = {w * at[0] + u * at[3] + v * at[6],
                w * at[1] + u * at[4] + v * at[7],
                w * at[2] + u * at[5] + v * at[8]};
      A->emit = {at[12], at[13], at[14]};
    }
    tm = mt(lb, tv, q, e1, e2, &u, &v);
    if (tm < B->t) {
      float w = 1.0f - u - v;
      B->t = tm;
      B->nrm = {w * at[0] + u * at[3] + v * at[6],
                w * at[1] + u * at[4] + v * at[7],
                w * at[2] + u * at[5] + v * at[8]};
      B->kd = {at[9], at[10], at[11]};
      B->emit = {at[12], at[13], at[14]};
      B->is_sphere = false;
    }
  }
  for (int s = 0; s < n_sph; ++s) {
    const float* r = sph + 12 * s;
    V3 c = {r[0], r[1], r[2]};
    float rr = r[3];
    V3 l = {o.x - c.x, o.y - c.y, o.z - c.z};
    float c0 = l.x * l.x + l.y * l.y + l.z * l.z - rr * rr;
    bool valid = r[7] > 0.0f;
    float inv_r = 1.0f / fmaxf(rr, 1e-20f);
    float ts = hit_sphere(la, l, c0, valid);
    if (ts < A->t) {
      A->t = ts;
      A->nrm = {(o.x + la.x * ts - c.x) * inv_r,
                (o.y + la.y * ts - c.y) * inv_r,
                (o.z + la.z * ts - c.z) * inv_r};
      A->emit = {r[4], r[5], r[6]};
    }
    ts = hit_sphere(lb, l, c0, valid);
    if (ts < B->t) {
      B->t = ts;
      B->nrm = {(o.x + lb.x * ts - c.x) * inv_r,
                (o.y + lb.y * ts - c.y) * inv_r,
                (o.z + lb.z * ts - c.z) * inv_r};
      B->kd = {r[8], r[9], r[10]};
      B->emit = {r[4], r[5], r[6]};
      B->is_sphere = true;
    }
  }
}

__device__ __forceinline__ float len3(V3 v) {
  return sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
}

struct Params {
  const float* tri;    // (F,12) [v0|e1|e2|pad]
  const float* attr;   // (F,16) [n0|n1|n2|kd|emit|pad]
  const float* sph;    // (S,12) [c|r|emit|valid|kd|pad]
  const float* ecr;    // (O,4) emitter [center|radius]
  const int* seeds;    // (spp,) per-sample seeds
  const float* cam;    // (8,) [eye|scale|aspect|background]
  float* acc;          // (3, n_lanes) radiance sum
  int n_tri, n_sph, n_emitters, spp, lane_offset, n_lanes, width, height,
      max_bounces;
  float p_rr;
};

__global__ void __launch_bounds__(128)
path_camera_kernel(const Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n_lanes) return;
  const int lane = p.lane_offset + idx;
  const uint32_t lane_u = (uint32_t)lane;
  const bool inb = lane < p.width * p.height;
  const int n_e = p.n_emitters;
  const bool any_e = n_e > 0;
  const float n_e_f = (float)max(n_e, 1);
  const float* cam = p.cam;
  const V3 eye = {cam[0], cam[1], cam[2]};
  const float scale = cam[3], aspect = cam[4];

  // camera ray of this lane (constant across the loop)
  const int lane_c = inb ? lane : 0;
  const int py_i = lane_c / p.width;
  const int px_i = lane_c - py_i * p.width;
  const float cxp = (2.0f * ((float)px_i + 0.5f) / (float)p.width - 1.0f) *
                    aspect * scale;
  const float cyp =
      (1.0f - 2.0f * ((float)py_i + 0.5f) / (float)p.height) * scale;
  const V3 cd = norm3(cxp - eye.x, cyp - eye.y, 0.0f * cxp - eye.z, 0.0f);

  bool live = false;
  int next_s = inb ? 0 : p.spp;
  int depth = 0;
  V3 pos = {0.f, 0.f, 0.f}, nrm = pos, kd = pos, emit = pos, col = pos;
  V3 tp = pos;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  while (live || next_s < p.spp) {
    const bool restart = !live && next_s < p.spp;
    // the current sample of a live lane is next_s - 1; a restarting lane
    // draws with the previous sample's seed and discards the draws
    const int local_s = max(next_s - 1, 0);
    const uint32_t seed = (uint32_t)p.seeds[local_s];
    const uint32_t base = (uint32_t)(depth * 8);

    const V3 nn = norm3(nrm.x, nrm.y, nrm.z, 0.0f);

    // ---- sampleLight (Scene.cpp:429-476): slots 0-4
    const float u_pick = uniform(seed, lane_u, base);
    const int k_e = min((int)floorf(u_pick * n_e_f), max(n_e - 1, 0));
    const float* e = p.ecr + 4 * k_e;
    const V3 cc = {e[0], e[1], e[2]};
    const float crad = e[3];
    const V3 bl = norm3(cc.x - pos.x, cc.y - pos.y, cc.z - pos.z, 0.0f);
    V3 s = sphere_dir(seed, lane_u, base + 1u);
    if (s.x * bl.x + s.y * bl.y + s.z * bl.z < 0.0f) s = {-s.x, -s.y, -s.z};
    const V3 h = sphere_dir(seed, lane_u, base + 3u);
    s = norm3(s.x + 1e-6f * h.x, s.y + 1e-6f * h.y, s.z + 1e-6f * h.z, 0.0f);
    const V3 sp = {cc.x + s.x * crad, cc.y + s.y * crad, cc.z + s.z * crad};
    const V3 ll = norm3(sp.x - pos.x, sp.y - pos.y, sp.z - pos.z, 0.0f);
    const float cos_t = ll.x * bl.x + ll.y * bl.y + ll.z * bl.z;
    const float pdf_l = any_e ? cos_t * kInv2Pi : 0.0f;

    // ---- RR + uniform hemisphere (Material.cpp:14-34): slots 5-7
    const float u_rr = uniform(seed, lane_u, base + 5u);
    const bool survive = u_rr <= p.p_rr;
    const float x1 = uniform(seed, lane_u, base + 6u);
    const float x2 = uniform(seed, lane_u, base + 7u);
    const float zl = fabsf(1.0f - 2.0f * x1);
    const float rl = sqrtf(fmaxf(0.0f, 1.0f - zl * zl));
    const float phi = kTwoPi * x2;
    V3 w = to_world(rl * cosf(phi), rl * sinf(phi), zl, nn);
    w = norm3(w.x, w.y, w.z, 0.0f);
    const float wdn = w.x * nn.x + w.y * nn.y + w.z * nn.z;
    const float cos_o = fmaxf(0.0f, wdn);
    const float pdf_b = wdn > 0.0f ? kInv2Pi : 0.0f;

    // ---- both traces; a restarting lane rides the B slot with its
    // camera ray
    const V3 o = restart ? eye
                         : V3{pos.x + 1e-6f * nn.x, pos.y + 1e-6f * nn.y,
                              pos.z + 1e-6f * nn.z};
    const V3 bd = restart ? cd : w;
    Hit A, B;
    dual_trace(p.tri, p.attr, p.sph, p.n_tri, p.n_sph, o, ll, bd, &A, &B);

    // ---- NEE evaluation for live lanes (Scene.cpp:671-717)
    const bool hit_a = A.t < kBig;
    const float scx = o.x + ll.x * A.t;
    const float scy = o.y + ll.y * A.t;
    const float scz = o.z + ll.z * A.t;
    const float dx = pos.x - scx, dy = pos.y - scy, dz = pos.z - scz;
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
    const float nee_s = (lit && not_shadow && pdf_ok_l && ldn > 0.0f)
                            ? cos_on * cos_ln / denom * kInvPi
                            : 0.0f;
    const bool cur_emissive = len3(emit) > kEps;
    const float dir_r = cur_emissive ? col.x : A.emit.x * kd.x * nee_s;
    const float dir_g = cur_emissive ? col.y : A.emit.y * kd.y * nee_s;
    const float dir_b = cur_emissive ? col.z : A.emit.z * kd.z * nee_s;
    acc_r = acc_r + (live ? tp.x * dir_r : 0.0f);
    acc_g = acc_g + (live ? tp.y * dir_g : 0.0f);
    acc_b = acc_b + (live ? tp.z * dir_b : 0.0f);

    // ---- primary miss -> background, once per restarted sample
    const bool hit_b = B.t < kBig;
    if (restart && !hit_b) {
      acc_r = acc_r + cam[5];
      acc_g = acc_g + cam[6];
      acc_b = acc_b + cam[7];
    }

    // ---- state update
    const bool emis_b = len3(B.emit) > kEps;
    const int depth_n = depth + 1;
    const bool live_b = live && survive && pdf_b >= kEps && hit_b &&
                        !emis_b && depth_n < p.max_bounces;
    const bool new_live = live_b || (restart && hit_b);
    if (new_live) {
      const float wgt =
          (wdn > 0.0f ? cos_o / fmaxf(pdf_b * p.p_rr, 1e-30f) : 0.0f) *
          kInvPi;
      tp = restart ? V3{1.0f, 1.0f, 1.0f}
                   : V3{tp.x * kd.x * wgt, tp.y * kd.y * wgt,
                        tp.z * kd.z * wgt};
      pos = {o.x + bd.x * B.t, o.y + bd.y * B.t, o.z + bd.z * B.t};
      nrm = norm3(B.nrm.x, B.nrm.y, B.nrm.z, 1e-20f);
      kd = B.kd;
      emit = B.emit;
      // spheres keep the reference's Properties.color = 0 quirk
      // (Object.hpp:36-40); triangles shade color as Kd
      col = B.is_sphere ? V3{0.f, 0.f, 0.f} : B.kd;
    }
    live = new_live;
    next_s = restart ? next_s + 1 : next_s;
    depth = restart ? 0 : depth_n;
  }
  p.acc[idx] = acc_r;
  p.acc[p.n_lanes + idx] = acc_g;
  p.acc[2 * p.n_lanes + idx] = acc_b;
}

}  // namespace

extern "C" int srt_path_camera_render(
    const float* tri, const float* attr, const float* sph, const float* ecr,
    const int* seeds, const float* cam, float* acc, int n_tri, int n_sph,
    int n_emitters, int spp, int lane_offset, int n_lanes, int width,
    int height, int max_bounces, float p_rr, void* stream) {
  if (n_lanes <= 0) return 0;
  Params p{tri,   attr,  sph,         ecr,        seeds,   cam,
           acc,   n_tri, n_sph,       n_emitters, spp,     lane_offset,
           n_lanes, width, height,    max_bounces, p_rr};
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  path_camera_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
