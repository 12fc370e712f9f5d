// Binned tile rasterization kernels for Hopper (sm_90a).
//
// Replace ops/pallas_raster.py::_tile_kernel (behind raster_tiles_fused)
// and ::_tile_kernel_shaded (behind raster_tiles_shaded) of the JAX
// package. One block per screen tile, one thread per pixel. Every pixel
// walks its tile's ascending triangle list: affine barycentrics at the
// integer pixel coordinate, the strict (0,1) inside test, and a strict
// `<` on z, so the lowest triangle index wins a tie (Rasterizer.cpp:89-127,
// 325-335). The winner's normal / uv / color are then interpolated once
// from its own rows; the TPU kernel's second walk over the list exists
// only because a TPU lane cannot gather a row. The shaded variant goes on
// to evaluate Blinn-Phong (Shader.cpp:510-543: 2-D sqrt attenuation,
// screen-space positions, static ka / ks / p) for covered pixels and
// emits the terms of rgb = direct + tex_a * texel + tex_b * texel^2.
//
// Bound: FP32 ALU work in the list walk (about 21 operations a pixel and
// list entry) against 48 (fused) or 64 (shaded) bytes written a pixel; at
// tens of entries a tile the walk dominates. Design: the block stages its
// list in shared memory 128 triangles at a time (index and the nine
// coefficients), so the walk reads broadcast shared-memory words and keeps
// the running winner in registers; a warp is one tile row, so every plane
// is written in whole 128-byte lines.
//
// Semantics are the JAX kernels': the running best starts at 3.0e38 and
// the output z is +inf where nothing covers; NaN coefficients of
// degenerate triangles fail every comparison; row0 is added to y before
// the conversion to float. Build with -fmad=false and without fast math,
// so every multiply and add rounds on its own as in the plain PyTorch
// version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kGeoCols = 12;
constexpr int kAttrCols = 28;
constexpr int kStage = 128;  // triangles staged in shared memory at a time
constexpr int kMaxThreads = 1024;

struct Params {
  const float* geo;    // (F,12) [row_a | row_b | zrow | pad]
  const float* attr;   // (F,28) [n0 n1 n2 | uv0 uv1 uv2 | c0 c1 c2 | sid | tid | pad]
  const int* lists;    // (T,cap) ascending triangle ids per tile
  const int* counts;   // (T,)
  const float* lights; // (3 + 6L,) [eye | pos int per light], shaded only
  float* z;            // (H,W)
  int* idx;            // (H,W)
  float* planes;       // (8,H,W) fused, (12,H,W) shaded
  int* ids;            // (2,H,W)
  int cap, gw, tile_h, tile_w, height, width, row0, n_lights;
};

// 1/n where n > 0, else 0 (the kernels' guarded normalisation).
__device__ __forceinline__ float inv_or_zero(float n) {
  return n > 0.0f ? 1.0f / n : 0.0f;
}

template <bool kShaded>
__global__ void __launch_bounds__(kMaxThreads)
raster_tile_kernel(Params p) {
  __shared__ float s_geo[kStage][9];
  __shared__ int s_idx[kStage];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int px = (t % p.gw) * p.tile_w + tid % p.tile_w;
  const int py = (t / p.gw) * p.tile_h + tid / p.tile_w;
  const float x = (float)px;
  const float y = (float)(py + p.row0);
  const int cnt = p.counts[t];
  const int* list = p.lists + (size_t)t * p.cap;

  float bz = kBig;
  int bi = -1;
  for (int base = 0; base < cnt; base += kStage) {
    const int n = min(kStage, cnt - base);
    for (int k = tid; k < n; k += nthreads) s_idx[k] = list[base + k];
    for (int k = tid; k < n * 9; k += nthreads) {
      const int r = k / 9;
      const int c = k - 9 * r;
      s_geo[r][c] = p.geo[(size_t)list[base + r] * kGeoCols + c];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* g = s_geo[j];
      const float alpha = x * g[0] + y * g[1] + g[2];
      const float beta = x * g[3] + y * g[4] + g[5];
      const float gamma = 1.0f - alpha - beta;
      const bool inside = alpha > 0.0f && alpha < 1.0f && beta > 0.0f &&
                          beta < 1.0f && gamma > 0.0f && gamma < 1.0f;
      const float zz = x * g[6] + y * g[7] + g[8];
      const float score = inside ? zz : kBig;
      if (score < bz) {  // strict <: the lowest index wins a tie
        bz = score;
        bi = s_idx[j];
      }
    }
    __syncthreads();
  }
  if (px >= p.width || py >= p.height) return;

  // the winner's attributes, interpolated from its own rows
  float pl[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int sid = 0;
  int tex = -1;
  if (bi >= 0) {
    const float* g = p.geo + (size_t)bi * kGeoCols;
    const float* a = p.attr + (size_t)bi * kAttrCols;
    const float alpha = x * g[0] + y * g[1] + g[2];
    const float beta = x * g[3] + y * g[4] + g[5];
    const float gamma = 1.0f - alpha - beta;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pl[k] = alpha * a[k] + beta * a[k + 3] + gamma * a[k + 6];
      pl[5 + k] = alpha * a[15 + k] + beta * a[18 + k] + gamma * a[21 + k];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      pl[3 + k] = alpha * a[9 + k] + beta * a[11 + k] + gamma * a[13 + k];
    sid = (int)a[24];
    tex = (int)a[25];
  }

  const size_t hw = (size_t)p.height * p.width;
  const size_t o = (size_t)py * p.width + px;
  p.z[o] = bi >= 0 ? bz : INFINITY;
  p.idx[o] = bi;

  if (!kShaded) {
#pragma unroll
    for (int k = 0; k < 8; ++k) p.planes[k * hw + o] = pl[k];
    p.ids[o] = sid;
    p.ids[hw + o] = tex;
    return;
  }

  // direct(3) | tex_a(3) | uv(2) | tex_b(3) | 0
  float out[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                   0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  out[6] = pl[3];
  out[7] = pl[4];
  if (bi >= 0) {
    const float nn = sqrtf(pl[0] * pl[0] + pl[1] * pl[1] + pl[2] * pl[2]);
    const float ninv = inv_or_zero(nn);
    const float nx = pl[0] * ninv, ny = pl[1] * ninv, nz = pl[2] * ninv;
    const float vx = p.lights[0] - x, vy = p.lights[1] - y,
                vz = p.lights[2] - bz;
    float amb[3] = {0.0f, 0.0f, 0.0f};
    float dif[3] = {0.0f, 0.0f, 0.0f};
    for (int li = 0; li < p.n_lights; ++li) {
      const float* l = p.lights + 3 + 6 * li;
      const float ldx = l[0] - x, ldy = l[1] - y, ldz = l[2] - bz;
      const float att = sqrtf(ldx * ldx + ldy * ldy);
      const float inv_att = 1.0f / fmaxf(att, 1e-12f);
      const float ln = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
      const float cos_t =
          fmaxf((nx * ldx + ny * ldy + nz * ldz) * inv_or_zero(ln), 0.0f);
      const float hx = ldx + vx, hy = ldy + vy, hz = ldz + vz;
      const float hn = sqrtf(hx * hx + hy * hy + hz * hz);
      const float cos_a =
          fmaxf((nx * hx + ny * hy + nz * hz) * inv_or_zero(hn), 0.0f);
      // cos_a^150 (Shader.cpp:7-12: p = 150)
      const float spec =
          cos_a > 0.0f ? expf(150.0f * logf(fmaxf(cos_a, 1e-30f))) : 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        amb[k] = amb[k] + (0.005f + 0.7937f * spec * inv_att) * l[3 + k];
        dif[k] = dif[k] + cos_t * inv_att * l[3 + k];
      }
    }
    const float nrm[3] = {nx, ny, nz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float c = pl[5 + k];
      if (sid == 1) {          // TEXTURE: the texel enters outside
        out[3 + k] = amb[k];
        out[8 + k] = dif[k];
      } else if (sid == 0) {   // NORMAL
        out[k] = (nrm[k] + 1.0f) * 0.5f;
      } else {                 // PHONG: kd = payload = vertex color
        out[k] = amb[k] * c + dif[k] * c * c;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) p.planes[k * hw + o] = out[k];
  p.ids[o] = sid == 1 ? tex : -1;
  p.ids[hw + o] = sid;
}

}  // namespace

extern "C" int srt_raster_tiles(const float* geo, const float* attr,
                                const int* lists, const int* counts,
                                const float* lights, float* z, int* idx,
                                float* planes, int* ids, int n_faces, int cap,
                                int gh, int gw, int tile_h, int tile_w,
                                int height, int width, int row0, int n_lights,
                                int shaded, void* stream) {
  const int threads = tile_h * tile_w;
  if (n_faces < 0 || cap < 1 || gh < 1 || gw < 1 || tile_h < 1 || tile_w < 1 ||
      threads > kMaxThreads || height < 1 || width < 1 || n_lights < 0 ||
      (shaded && lights == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{geo,   attr,   lists, counts, lights, z,     idx,      planes, ids,
           cap,   gw,     tile_h, tile_w, height, width, row0,     n_lights};
  const int blocks = gh * gw;
  cudaStream_t s = (cudaStream_t)stream;
  if (shaded)
    raster_tile_kernel<true><<<blocks, threads, 0, s>>>(p);
  else
    raster_tile_kernel<false><<<blocks, threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
