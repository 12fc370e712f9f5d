// Binned tile rasterization kernels for Hopper (sm_90a).
//
// Replace ops/pallas_raster.py::_tile_kernel (behind raster_tiles_fused)
// and ::_tile_kernel_shaded (behind raster_tiles_shaded) of the JAX
// package, and the binning in front of them (ops/pallas_raster.py:
// bin_triangles, which the JAX package runs in XLA outside the
// pallas_call because a TPU lane cannot compact in order). Two launches:
//
//   1. coarse_bin_kernel: one block per coarse tile (about 128 x 128
//      pixels, a whole number of kernel tiles) scans the kept triangles'
//      screen boxes in ascending index, a box a thread in each of eight
//      rounds a pass, tests each against the coarse rectangle, and
//      compacts the hits in order with a warp
//      ballot and a prefix of the warps' counts: an ascending list per
//      coarse tile.
//   2. raster_tile_kernel: one block per kernel tile, one thread per
//      pixel. Level 2 of the binning: the block scans its coarse tile's
//      list with bin_triangles' exact comparisons, compacts the hits in
//      order the same way, keeps the first `cap` and counts the rest into
//      `dropped`. The kept hits are staged in shared memory and every
//      pixel walks them: affine barycentrics at the integer pixel
//      coordinate, the strict (0,1) inside test, and a strict `<` on z, so
//      the lowest triangle index wins a tie (Rasterizer.cpp:89-127,
//      325-335). The winner's normal / uv / color are then interpolated
//      once from its own rows; the TPU kernel's second walk over the list
//      exists only because a TPU lane cannot gather a row. The shaded
//      variant goes on to evaluate Blinn-Phong (Shader.cpp:510-543: 2-D
//      sqrt attenuation, screen-space positions, static ka / ks / p) for
//      covered pixels and emits the terms of
//      rgb = direct + tex_a * texel + tex_b * texel^2. A third instance
//      runs level 2 alone and writes the lists out (bin_triangles_device).
//
// Why the two levels give bin_triangles' lists exactly. bin_triangles
// keeps triangle f in kernel tile (r, c) iff keep[f] and
//   b0 <= tx1, b1 <= ty1, b2 >= tx0, b3 >= ty0
// with tx0 = float(c) * tile_w, tx1 = tx0 + (tile_w - 1), ty0 =
// float(r * tile_h + row0), ty1 = ty0 + (tile_h - 1), each a float32
// operation on float32 operands (tile_rect below computes the same
// operations). A coarse tile's rectangle takes x0 = tx0 of its first
// column, x1 = tx1 of its last, y0 = ty0 of its first row and y1 = ty1 of
// its last, not clipped to the frame. Float32 conversion, multiplication
// by a positive constant and addition of a constant round monotonically,
// so every kernel tile of the coarse tile has x0 <= tx0, tx1 <= x1, y0 <=
// ty0, ty1 <= y1 (at small integers, the usual case, all of them are
// exact). Hence b0 <= tx1 implies b0 <= x1, and so on for the other three:
// a comparison against the coarse bound can only fail where the fine one
// fails. A NaN bound fails every comparison at both levels, as it does in
// bin_triangles, which is why the tests are written as `a <= b` / `a >=
// b` and never as a negated `>` / `<`; +-inf compares as in
// bin_triangles. So the coarse list holds every triangle the kernel tile
// keeps. It is ascending, and level 2 takes the subsequence that passes
// the fine test, so the kernel tile's list is bin_triangles' list: the
// same triangles in the same order, the first `cap` kept, the rest counted.
//
// Bound: the walk's FP32 work (about 21 operations a pixel and list
// entry) against 48 (fused) or 64 (shaded) bytes written a pixel. At ten
// entries a tile neither binds: the two launches and their dependent
// loads do. Design: the coarse level reads every box once per coarse
// tile (64 tiles at 1024x1024), eight boxes a thread in flight; level 2
// reads a hundred-odd entries a kernel tile from L2. A thread that finds
// a hit stages that triangle's row itself, as two float4 and a float2
// (the coefficients and the index), so the walk reads three broadcast
// shared-memory words an entry and keeps the running winner in
// registers; a warp is one tile row, so every plane is written in whole
// 128-byte lines.
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
constexpr int kStage = 128;       // list entries staged in shared memory at a time
constexpr int kMaxThreads = 1024;
constexpr int kBinThreads = 1024;  // threads of a coarse block
constexpr int kBinBoxes = 8;       // boxes a coarse thread tests a pass

// modes of raster_tile_kernel
constexpr int kFused = 0;
constexpr int kShaded = 1;
constexpr int kListsOnly = 2;

struct Grid {
  int gh, gw;            // kernel tiles
  int tile_h, tile_w;    // pixels a kernel tile
  int row0;              // absolute screen row of the grid's first row
  int cy, cx;            // kernel tiles a coarse tile (rows, columns)
  int gcw;               // coarse tiles a row
};

// bin_triangles' rectangle of kernel tile rows [r0, r1] x columns [c0, c1]
// (one tile when r0 == r1 and c0 == c1): the same float32 operations.
__device__ __forceinline__ void tile_rect(const Grid& g, int r0, int r1, int c0, int c1,
                                          float& x0, float& x1, float& y0, float& y1) {
  x0 = (float)c0 * (float)g.tile_w;
  x1 = (float)c1 * (float)g.tile_w + (float)(g.tile_w - 1);
  y0 = (float)(r0 * g.tile_h + g.row0);
  y1 = (float)(r1 * g.tile_h + g.row0) + (float)(g.tile_h - 1);
}

// bin_triangles' overlap test, operand for operand (a NaN fails it)
__device__ __forceinline__ bool overlaps(float4 b, float x0, float x1, float y0, float y1) {
  return b.x <= x1 && b.y <= y1 && b.z >= x0 && b.w >= y0;
}

// the lanes of warp `warp` in a block of `n` threads
__device__ __forceinline__ unsigned lanes_of(int warp, int n) {
  const int k = n - 32 * warp;
  return k >= 32 ? 0xffffffffu : (1u << k) - 1u;
}

__global__ void __launch_bounds__(kBinThreads)
coarse_bin_kernel(const float4* __restrict__ bbox, const unsigned char* __restrict__ keep,
                  int n_faces, Grid g, int* __restrict__ clists, int* __restrict__ ccounts,
                  int* __restrict__ dropped) {
  __shared__ int s_off[kBinBoxes][kBinThreads / 32];
  __shared__ int s_pass;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;  // blockDim.x is kBinThreads
  const unsigned below = (1u << lane) - 1u;
  const int r0 = (c / g.gcw) * g.cy, c0 = (c % g.gcw) * g.cx;
  float x0, x1, y0, y1;
  tile_rect(g, r0, min(r0 + g.cy, g.gh) - 1, c0, min(c0 + g.cx, g.gw) - 1, x0, x1, y0, y1);
  int* list = clists + (size_t)c * n_faces;
  if (c == 0 && tid == 0) *dropped = 0;  // level 2 adds to it after this launch

  int total = 0;
  const int step = kBinBoxes * kBinThreads;
  for (int base = 0; base < n_faces; base += step) {
    bool hit[kBinBoxes];
#pragma unroll
    for (int r = 0; r < kBinBoxes; ++r) {
      const int f = base + r * kBinThreads + tid;
      hit[r] = false;
      if (f < n_faces) {  // both loads in flight at once
        const bool kept = keep[f] != 0;
        hit[r] = overlaps(bbox[f], x0, x1, y0, y1) && kept;
      }
    }
    unsigned m[kBinBoxes];
#pragma unroll
    for (int r = 0; r < kBinBoxes; ++r) {
      m[r] = __ballot_sync(0xffffffffu, hit[r]);
      if (lane == 0) s_off[r][warp] = __popc(m[r]);
    }
    __syncthreads();
    // the hits in (pass round, warp, lane) order are in ascending index:
    // warp 0 turns the counts into exclusive offsets
    if (warp == 0) {
      int run = 0;
#pragma unroll
      for (int r = 0; r < kBinBoxes; ++r) {
        const int v = lane < nwarps ? s_off[r][lane] : 0;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += u;
        }
        if (lane < nwarps) s_off[r][lane] = run + incl - v;
        run += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) s_pass = run;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kBinBoxes; ++r)
      if (hit[r]) list[total + s_off[r][warp] + __popc(m[r] & below)] = base + r * kBinThreads + tid;
    total += s_pass;
    __syncthreads();  // s_off and s_pass are written again next pass
  }
  if (tid == 0) ccounts[c] = total;
}

struct Params {
  const float* geo;    // (F,12) [row_a | row_b | zrow | pad]
  const float* attr;   // (F,28) [n0 n1 n2 | uv0 uv1 uv2 | c0 c1 c2 | sid | tid | pad]
  const float4* bbox;  // (F,4) [min_x, min_y, max_x, max_y]
  const int* clists;   // (C,F) ascending triangle ids per coarse tile
  const int* ccounts;  // (C,)
  const float* lights; // (3 + 6L,) [eye | pos int per light], shaded only
  float* z;            // (H,W)
  int* idx;            // (H,W)
  float* planes;       // (8,H,W) fused, (12,H,W) shaded
  int* ids;            // (2,H,W)
  int* dropped;        // () triangles beyond `cap` over all tiles
  int* lists_out;      // (T,cap) or null: each tile's kept list
  int* counts_out;     // (T,) or null: each tile's kept count
  int n_faces, cap, height, width, n_lights;
  Grid g;
};

// 1/n where n > 0, else 0 (the kernels' guarded normalisation).
__device__ __forceinline__ float inv_or_zero(float n) {
  return n > 0.0f ? 1.0f / n : 0.0f;
}

// blocks of kMaxThreads an SM the instance is built for: two for the fused
// and lists-only instances (32 registers, four 512-thread tiles an SM: the
// launch is latency-bound; on an H100 the fused frame of 9,216 triangles at
// 1024x1024 took 0.049 ms on the device against 0.054 at one), one for the
// shaded (its lighting needs 56)
constexpr int min_blocks(int mode) { return mode == kShaded ? 1 : 2; }

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(kMode))
raster_tile_kernel(Params p) {
  // a staged list entry: [a0 a1 a2 b0] [b1 b2 z0 z1] and [z2, index bits]
  __shared__ float4 s_ab[kStage][2];
  __shared__ float2 s_zi[kStage];
  __shared__ int s_off[kMaxThreads / 32];
  __shared__ int s_pass;

  const Grid& g = p.g;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
  const unsigned wmask = lanes_of(warp, nthreads);
  const unsigned below = (1u << lane) - 1u;
  const int row = t / g.gw, col = t - (t / g.gw) * g.gw;
  const int px = col * g.tile_w + tid % g.tile_w;
  const int py = row * g.tile_h + tid / g.tile_w;
  const float x = (float)px;
  const float y = (float)(py + g.row0);
  float tx0, tx1, ty0, ty1;
  tile_rect(g, row, row, col, col, tx0, tx1, ty0, ty1);
  const int c = (row / g.cy) * g.gcw + col / g.cx;
  const int* clist = p.clists + (size_t)c * p.n_faces;
  const int ccount = p.ccounts[c];
  const float4* geo4 = reinterpret_cast<const float4*>(p.geo);

  float bz = kBig;
  int bi = -1;
  int total = 0;  // this tile's hits so far, kept or not (block-uniform)
  for (int base = 0; base < ccount; base += nthreads) {
    // level 2: one pass over nthreads entries of the coarse list
    const int k = base + tid;
    int f = -1;
    bool hit = false;
    if (k < ccount) {
      f = clist[k];
      hit = overlaps(p.bbox[f], tx0, tx1, ty0, ty1);
    }
    const unsigned m = __ballot_sync(wmask, hit);
    if (lane == 0) s_off[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? s_off[lane] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(wmask, incl, d);
        if (lane >= d) incl += u;
      }
      if (lane < nwarps) s_off[lane] = incl - v;
      if (lane == nwarps - 1) s_pass = incl;
    }
    __syncthreads();
    const int pos = total + s_off[warp] + __popc(m & below);  // the hit's slot in the tile's list
    const int n_pass = s_pass;
    if (hit && pos < p.cap && p.lists_out != nullptr)
      p.lists_out[(size_t)t * p.cap + pos] = f;
    const int n_keep = max(0, min(total + n_pass, p.cap) - total);
    total += n_pass;
    if (kMode == kListsOnly) {
      __syncthreads();  // s_off and s_pass are written again next pass
      continue;
    }
    // the kept hits of this pass, kStage at a time: each thread stages its
    // own hit's row, then every pixel walks the stage
    const int first = pos - (total - n_pass);  // the hit's slot in this pass
    for (int s = 0; s < n_keep; s += kStage) {
      const int n = min(kStage, n_keep - s);
      if (hit && first >= s && first < s + n) {
        const float4 a = geo4[(size_t)f * 3];
        const float4 b = geo4[(size_t)f * 3 + 1];
        const float4 zr = geo4[(size_t)f * 3 + 2];
        s_ab[first - s][0] = a;
        s_ab[first - s][1] = b;
        s_zi[first - s] = make_float2(zr.x, __int_as_float(f));
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float4 a = s_ab[j][0];
        const float4 b = s_ab[j][1];
        const float2 zi = s_zi[j];
        const float alpha = x * a.x + y * a.y + a.z;
        const float beta = x * a.w + y * b.x + b.y;
        const float gamma = 1.0f - alpha - beta;
        const bool inside = alpha > 0.0f && alpha < 1.0f && beta > 0.0f &&
                            beta < 1.0f && gamma > 0.0f && gamma < 1.0f;
        const float zz = x * b.z + y * b.w + zi.x;
        const float score = inside ? zz : kBig;
        if (score < bz) {  // strict <: the lowest index wins a tie
          bz = score;
          bi = __float_as_int(zi.y);
        }
      }
      __syncthreads();
    }
    if (n_keep == 0) __syncthreads();  // s_off and s_pass are written again next pass
  }
  if (tid == 0) {
    if (p.counts_out != nullptr) p.counts_out[t] = min(total, p.cap);
    if (total > p.cap) atomicAdd(p.dropped, total - p.cap);
  }
  if (kMode == kListsOnly || px >= p.width || py >= p.height) return;

  // the winner's attributes, interpolated from its own rows
  float pl[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int sid = 0;
  int tex = -1;
  if (bi >= 0) {
    const float* gr = p.geo + (size_t)bi * kGeoCols;
    const float* a = p.attr + (size_t)bi * kAttrCols;
    const float alpha = x * gr[0] + y * gr[1] + gr[2];
    const float beta = x * gr[3] + y * gr[4] + gr[5];
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

  if (kMode == kFused) {
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
      const float cc = pl[5 + k];
      if (sid == 1) {          // TEXTURE: the texel enters outside
        out[3 + k] = amb[k];
        out[8 + k] = dif[k];
      } else if (sid == 0) {   // NORMAL
        out[k] = (nrm[k] + 1.0f) * 0.5f;
      } else {                 // PHONG: kd = payload = vertex color
        out[k] = amb[k] * cc + dif[k] * cc * cc;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) p.planes[k * hw + o] = out[k];
  p.ids[o] = sid == 1 ? tex : -1;
  p.ids[hw + o] = sid;
}

}  // namespace

// Bins and rasterizes on `stream`: the coarse launch, then the tile
// launch in `mode` (0 fused, 1 shaded, 2 the lists alone). `clists` /
// `ccounts` are (C,F) / (C,) scratch, C = ceil(gh / cy) * ceil(gw / cx);
// `dropped` () is written; `lists_out` / `counts_out` may be null. Returns
// the first CUDA error (cudaErrorInvalidValue for bad arguments).
extern "C" int srt_raster_tiles(const float* geo, const float* attr, const float* bbox,
                                const unsigned char* keep, const float* lights, float* z,
                                int* idx, float* planes, int* ids, int* clists, int* ccounts,
                                int* dropped, int* lists_out, int* counts_out, int n_faces,
                                int cap, int gh, int gw, int tile_h, int tile_w, int cy, int cx,
                                int height, int width, int row0, int n_lights, int mode,
                                void* stream) {
  const int threads = tile_h * tile_w;
  const bool draws = mode == kFused || mode == kShaded;
  if (n_faces < 0 || cap < 1 || gh < 1 || gw < 1 || tile_h < 1 || tile_w < 1 ||
      threads > kMaxThreads || cy < 1 || cx < 1 || height < 1 || width < 1 ||
      n_lights < 0 || mode < kFused || mode > kListsOnly || clists == nullptr ||
      ccounts == nullptr || dropped == nullptr ||
      (n_faces > 0 && (bbox == nullptr || keep == nullptr)) ||
      (draws && n_faces > 0 && (geo == nullptr || attr == nullptr)) ||
      (draws && (z == nullptr || idx == nullptr || planes == nullptr || ids == nullptr)) ||
      (mode == kShaded && lights == nullptr) ||
      (reinterpret_cast<size_t>(geo) | reinterpret_cast<size_t>(bbox)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int gcw = (gw + cx - 1) / cx;
  const int coarse = ((gh + cy - 1) / cy) * gcw;
  Grid g{gh, gw, tile_h, tile_w, row0, cy, cx, gcw};
  cudaStream_t s = (cudaStream_t)stream;
  coarse_bin_kernel<<<coarse, kBinThreads, 0, s>>>(reinterpret_cast<const float4*>(bbox), keep,
                                                   n_faces, g, clists, ccounts, dropped);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Params p{geo,    attr,    reinterpret_cast<const float4*>(bbox),
           clists, ccounts, lights,
           z,      idx,     planes,
           ids,    dropped, lists_out,
           counts_out, n_faces, cap, height, width, n_lights, g};
  const int blocks = gh * gw;
  if (mode == kShaded)
    raster_tile_kernel<kShaded><<<blocks, threads, 0, s>>>(p);
  else if (mode == kFused)
    raster_tile_kernel<kFused><<<blocks, threads, 0, s>>>(p);
  else
    raster_tile_kernel<kListsOnly><<<blocks, threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
