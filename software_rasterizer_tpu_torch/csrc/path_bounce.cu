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
// In: state (18,N) [pos|nrm|kd|emit|color|throughput], component-major,
// and live (N,). Out: acc (3,N), the radiance the lane gathered; the new
// state and live. A lane that is dead at the start of a bounce keeps its
// state as it is (the thread leaves the loop); a lane that dies in a
// bounce still takes that bounce's state update. acc and live are defined
// on every lane.
//
// Bound: on a launch of few bounces the 2 x 18 x 4 bytes of state a lane
// (150 MB a million lanes); from a few bounces on FP32 ALU work, two
// Moller-Trumbore tests a triangle and bounce. Design: one thread per
// lane, 128 threads a block; component-major state makes every load and
// store of a warp one coalesced 128-byte line; the path state lives in
// registers between bounces; the tables are read as broadcasts. No
// (rows,128) tiling and no padding of N.
//
// Draws are the JAX kernel's `_Rng`: one lowbias32 round of
// lane * 0x9E3779B1 ^ (seed + ctr * 0x85EBCA6B), twelve draws a bounce in
// a fixed order (pick 1, gauss3 4, gauss3 4, roulette 1, hemisphere 2),
// so draw k of bounce b has counter 12 b + k + 1. Build with -fmad=false
// and without fast math, so every multiply and add rounds on its own as
// in the plain PyTorch version; logf, cosf and sinf are the only place a
// last bit could differ from it.

#include "path_common.cuh"

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
  int n_tri, n_sph, n_emitters, n, n_bounces;
  uint32_t seed;
  float p_rr;
};

__global__ void __launch_bounds__(kThreads)
path_bounce_kernel(const BounceParams p) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= p.n) return;
  const uint32_t lane_u = (uint32_t)lane;
  const size_t n = (size_t)p.n;
  const float* st = p.state + lane;
  V3 pos = {st[0], st[n], st[2 * n]};
  V3 nrm = {st[3 * n], st[4 * n], st[5 * n]};
  V3 kd = {st[6 * n], st[7 * n], st[8 * n]};
  V3 emit = {st[9 * n], st[10 * n], st[11 * n]};
  V3 col = {st[12 * n], st[13 * n], st[14 * n]};
  V3 tp = {st[15 * n], st[16 * n], st[17 * n]};
  bool live = p.live[lane] != 0;
  const int n_e = p.n_emitters;
  const bool any_e = n_e > 0;
  const float n_e_f = (float)max(n_e, 1);
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  for (int b = 0; b < p.n_bounces && live; ++b) {
    const uint32_t c0 = (uint32_t)(12 * b);
    const V3 nn = norm3(nrm.x, nrm.y, nrm.z, 0.0f);

    // ---- sampleLight (Scene.cpp:429-476): draws 1-9
    const float u_pick = uniform1(p.seed, lane_u, c0 + 1u);
    const int k_e = min((int)floorf(u_pick * n_e_f), max(n_e - 1, 0));
    const float* e = p.ecr + 4 * k_e;
    const V3 cc = {e[0], e[1], e[2]};
    const float crad = e[3];
    const V3 bl = norm3(cc.x - pos.x, cc.y - pos.y, cc.z - pos.z, 0.0f);
    const V3 g = gauss3(p.seed, lane_u, c0 + 2u);
    V3 s = norm3(g.x, g.y, g.z, 1e-20f);
    if (s.x * bl.x + s.y * bl.y + s.z * bl.z < 0.0f) s = {-s.x, -s.y, -s.z};
    const V3 hg = gauss3(p.seed, lane_u, c0 + 6u);
    const V3 h = norm3(hg.x, hg.y, hg.z, 1e-20f);
    s = norm3(s.x + 1e-6f * h.x, s.y + 1e-6f * h.y, s.z + 1e-6f * h.z, 0.0f);
    const V3 sp = {cc.x + s.x * crad, cc.y + s.y * crad, cc.z + s.z * crad};
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
    dual_trace(p.tri, p.attr, p.sph, p.n_tri, p.n_sph, o, ll, w, &A, &B);

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
    const bool cur_emissive = len3(emit) > kEps;
    // the lane is live here: dead lanes have left the loop
    acc_r = acc_r + tp.x * (cur_emissive ? col.x : nee_r);
    acc_g = acc_g + tp.y * (cur_emissive ? col.y : nee_g);
    acc_b = acc_b + tp.z * (cur_emissive ? col.z : nee_b);

    // ---- state update
    const bool hit_b = B.t < kBig;
    const bool emis_b = len3(B.emit) > kEps;
    live = survive && pdf_b >= kEps && hit_b && !emis_b;
    const float wgt = cos_o / fmaxf(pdf_b * p.p_rr, 1e-30f);
    tp = {tp.x * fr.x * wgt, tp.y * fr.y * wgt, tp.z * fr.z * wgt};
    pos = {o.x + w.x * B.t, o.y + w.y * B.t, o.z + w.z * B.t};
    nrm = norm3(B.nrm.x, B.nrm.y, B.nrm.z, 1e-20f);
    kd = B.kd;
    emit = B.emit;
    // spheres keep the reference's Properties.color = 0 quirk
    // (Object.hpp:36-40); triangles shade color as Kd
    col = B.is_sphere ? V3{0.f, 0.f, 0.f} : B.kd;
  }

  float* so = p.out_state + lane;
  so[0] = pos.x, so[n] = pos.y, so[2 * n] = pos.z;
  so[3 * n] = nrm.x, so[4 * n] = nrm.y, so[5 * n] = nrm.z;
  so[6 * n] = kd.x, so[7 * n] = kd.y, so[8 * n] = kd.z;
  so[9 * n] = emit.x, so[10 * n] = emit.y, so[11 * n] = emit.z;
  so[12 * n] = col.x, so[13 * n] = col.y, so[14 * n] = col.z;
  so[15 * n] = tp.x, so[16 * n] = tp.y, so[17 * n] = tp.z;
  p.out_live[lane] = live ? 1 : 0;
  p.acc[lane] = acc_r;
  p.acc[n + lane] = acc_g;
  p.acc[2 * n + lane] = acc_b;
}

}  // namespace

extern "C" int srt_path_bounce(const float* tri, const float* attr,
                               const float* sph, const float* ecr,
                               const float* state, const uint8_t* live,
                               float* out_state, uint8_t* out_live, float* acc,
                               int n_tri, int n_sph, int n_emitters, int n,
                               int n_bounces, int seed, float p_rr,
                               void* stream) {
  if (n <= 0) return 0;
  BounceParams p{tri,   attr,  sph,        ecr, state,     live,
                 out_state, out_live, acc, n_tri, n_sph, n_emitters,
                 n,     n_bounces, (uint32_t)seed, p_rr};
  const int blocks = (n + kThreads - 1) / kThreads;
  path_bounce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
