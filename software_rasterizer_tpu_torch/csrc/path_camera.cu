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

#include "path_common.cuh"

namespace {

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

// glm::sphericalRand's (z, phi) unit-sphere draw from two slots.
__device__ __forceinline__ V3 sphere_dir(uint32_t seed, uint32_t lane,
                                         uint32_t ctr) {
  float z = 1.0f - 2.0f * uniform(seed, lane, ctr);
  float r = sqrtf(fmaxf(0.0f, 1.0f - z * z));
  float phi = kTwoPi * uniform(seed, lane, ctr + 1u);
  return {r * cosf(phi), r * sinf(phi), z};
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
