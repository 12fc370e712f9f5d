// Native host-side runtime pieces for software_rasterizer_tpu.
//
// The reference implements its entire host runtime in C++17; the TPU
// build keeps the compute path in XLA but implements the load-time /
// host-side hot spots natively too:
//
//   * srt_build_bvh — the reference BVH build (BVHAcceleration.cpp:142-198:
//     median split on the longest centroid-extent axis, stable sort,
//     1-primitive leaves, preorder node numbering, cumulative surface
//     area per node for light sampling). Bit-compatible with the NumPy
//     builder in ops/bvh.py (same node order, same boxes) so Python
//     tests can assert exact equality.
//
//   * srt_parse_obj_counts / srt_parse_obj — a fast Wavefront OBJ
//     vertex/face scanner (positions, normals, uvs, v//vn faces with fan
//     triangulation) used by utils/obj_loader.py for large assets.
//
// C ABI only (ctypes-friendly): no exceptions across the boundary,
// caller allocates all outputs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BuildCtx {
  const float *bb_min, *bb_max, *areas;
  std::vector<float> cx, cy, cz;  // centroids
  float *node_min, *node_max, *area;
  int32_t *left, *right, *prim;
  int32_t next_node = 0;
};

int32_t new_node(BuildCtx &c) {
  int32_t ni = c.next_node++;
  c.left[ni] = -1;
  c.right[ni] = -1;
  c.prim[ni] = -1;
  c.area[ni] = 0.0f;
  return ni;
}

int32_t build(BuildCtx &c, int32_t *idxs, int32_t n) {
  int32_t ni = new_node(c);
  if (n == 1) {
    int32_t p = idxs[0];
    std::memcpy(&c.node_min[3 * ni], &c.bb_min[3 * p], 3 * sizeof(float));
    std::memcpy(&c.node_max[3 * ni], &c.bb_max[3 * p], 3 * sizeof(float));
    c.prim[ni] = p;
    c.area[ni] = c.areas[p];
    return ni;
  }
  int32_t l, r;
  if (n == 2) {
    l = build(c, idxs, 1);
    r = build(c, idxs + 1, 1);
  } else {
    // longest centroid-extent axis
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = 0; i < n; ++i) {
      const float cc[3] = {c.cx[idxs[i]], c.cy[idxs[i]], c.cz[idxs[i]]};
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], cc[k]);
        hi[k] = std::max(hi[k], cc[k]);
      }
    }
    int axis = 0;
    float best = hi[0] - lo[0];
    for (int k = 1; k < 3; ++k)
      if (hi[k] - lo[k] > best) { best = hi[k] - lo[k]; axis = k; }
    const std::vector<float> &key = axis == 0 ? c.cx : (axis == 1 ? c.cy : c.cz);
    std::stable_sort(idxs, idxs + n,
                     [&](int32_t a, int32_t b) { return key[a] < key[b]; });
    int32_t mid = n / 2;
    l = build(c, idxs, mid);
    r = build(c, idxs + mid, n - mid);
  }
  c.left[ni] = l;
  c.right[ni] = r;
  for (int k = 0; k < 3; ++k) {
    c.node_min[3 * ni + k] = std::min(c.node_min[3 * l + k], c.node_min[3 * r + k]);
    c.node_max[3 * ni + k] = std::max(c.node_max[3 * l + k], c.node_max[3 * r + k]);
  }
  c.area[ni] = c.area[l] + c.area[r];
  return ni;
}

}  // namespace

extern "C" {

// ABI version — bump on ANY signature/layout change (e.g. the r2 move
// of srt_parse_obj outputs from float* to double*). The ctypes loader
// refuses (and rebuilds) a library whose version doesn't match, so a
// stale .so can never be called through a mismatched prototype.
int32_t srt_abi_version(void) { return 2; }

// Number of nodes the caller must allocate for n primitives.
int32_t srt_bvh_node_count(int32_t n) { return n <= 0 ? 1 : 2 * n - 1; }

// Build the BVH. All outputs sized srt_bvh_node_count(n).
// Returns 0 on success.
int32_t srt_build_bvh(int32_t n, const float *bb_min, const float *bb_max,
                      const float *areas, float *node_min, float *node_max,
                      int32_t *left, int32_t *right, int32_t *prim,
                      float *area) {
  if (n <= 0) {
    for (int k = 0; k < 3; ++k) node_min[k] = node_max[k] = 0.0f;
    left[0] = right[0] = prim[0] = -1;
    area[0] = 0.0f;
    return 0;
  }
  BuildCtx c{bb_min, bb_max, areas, {}, {}, {},
             node_min, node_max, area, left, right, prim};
  c.cx.resize(n);
  c.cy.resize(n);
  c.cz.resize(n);
  for (int32_t i = 0; i < n; ++i) {
    c.cx[i] = 0.5f * (bb_min[3 * i + 0] + bb_max[3 * i + 0]);
    c.cy[i] = 0.5f * (bb_min[3 * i + 1] + bb_max[3 * i + 1]);
    c.cz[i] = 0.5f * (bb_min[3 * i + 2] + bb_max[3 * i + 2]);
  }
  std::vector<int32_t> idxs(n);
  for (int32_t i = 0; i < n; ++i) idxs[i] = i;
  build(c, idxs.data(), n);
  return c.next_node == 2 * n - 1 ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Fast OBJ scanner. Pass 1 (counts) then pass 2 (fill).

struct ObjCounts {
  int32_t n_pos, n_nrm, n_uv, n_corners;  // corners after fan triangulation
};

static bool is_ws(char ch) { return ch == ' ' || ch == '\t' || ch == '\r'; }

int32_t srt_parse_obj_counts(const char *text, int64_t len, int32_t *out4) {
  int32_t np = 0, nn = 0, nt = 0, nc = 0;
  const char *p = text, *end = text + len;
  while (p < end) {
    const char *line_end = static_cast<const char *>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    while (p < line_end && is_ws(*p)) ++p;
    if (line_end - p >= 2) {
      if (p[0] == 'v' && is_ws(p[1])) ++np;
      else if (p[0] == 'v' && p[1] == 'n' && line_end - p > 2 && is_ws(p[2])) ++nn;
      else if (p[0] == 'v' && p[1] == 't' && line_end - p > 2 && is_ws(p[2])) ++nt;
      else if (p[0] == 'f' && is_ws(p[1])) {
        int32_t verts = 0;
        const char *q = p + 1;
        // cap matches the fill pass's 64-vertex face buffer: both passes
        // must agree on the corner count or the fill pass would leave
        // uninitialized rows in the caller-allocated output
        while (q < line_end && verts < 64) {
          while (q < line_end && is_ws(*q)) ++q;
          if (q >= line_end) break;
          ++verts;
          while (q < line_end && !is_ws(*q)) ++q;
        }
        if (verts >= 3) nc += 3 * (verts - 2);  // fan triangulation
      }
    }
    p = line_end + 1;
  }
  out4[0] = np; out4[1] = nn; out4[2] = nt; out4[3] = nc;
  return 0;
}

// Fill positions (np,3) f64, normals (nn,3) f64, uvs (nt,2) f64, and
// per-corner index triples (nc,3) i32 of (v, vt, vn), -1 where absent.
// DOUBLES, not floats: the Python assembly normalizes vn rows and flips
// uv.v in f64 before the final f32 cast, and must be bit-identical to
// the pure-Python scan (and tinyobjloader's double parse). 1-based and
// negative OBJ indices are resolved here. Returns 0 on success.
int32_t srt_parse_obj(const char *text, int64_t len, double *pos, double *nrm,
                      double *uv, int32_t *corners) {
  int32_t np = 0, nn = 0, nt = 0, nc = 0;
  const char *p = text, *end = text + len;
  while (p < end) {
    const char *line_end = static_cast<const char *>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char *q = p;
    while (q < line_end && is_ws(*q)) ++q;
    if (line_end - q >= 2 && q[0] == 'v' && is_ws(q[1])) {
      char *e;
      for (int k = 0; k < 3; ++k) {
        pos[3 * np + k] = strtod(q + 1, &e);
        q = e - 1;
        ++q;
      }
      ++np;
    } else if (line_end - q > 2 && q[0] == 'v' && q[1] == 'n' && is_ws(q[2])) {
      char *e;
      q += 2;
      for (int k = 0; k < 3; ++k) {
        nrm[3 * nn + k] = strtod(q, &e);
        q = e;
      }
      ++nn;
    } else if (line_end - q > 2 && q[0] == 'v' && q[1] == 't' && is_ws(q[2])) {
      char *e;
      q += 2;
      for (int k = 0; k < 2; ++k) {
        uv[2 * nt + k] = strtod(q, &e);
        q = e;
      }
      ++nt;
    } else if (line_end - q >= 2 && q[0] == 'f' && is_ws(q[1])) {
      int32_t tri[64][3];
      int32_t verts = 0;
      const char *r = q + 1;
      while (r < line_end && verts < 64) {
        while (r < line_end && is_ws(*r)) ++r;
        if (r >= line_end) break;
        int32_t vi = 0, ti = 0, ni = 0, field = 0, sign = 1;
        bool has[3] = {false, false, false};
        int32_t val = 0;
        bool in_num = false;
        while (r < line_end && !is_ws(*r)) {
          char ch = *r;
          if (ch == '/') {
            if (in_num) {
              (field == 0 ? vi : field == 1 ? ti : ni) = sign * val;
              has[field] = true;
            }
            ++field; val = 0; sign = 1; in_num = false;
          } else if (ch == '-') {
            sign = -1; in_num = true;
          } else if (ch >= '0' && ch <= '9') {
            val = val * 10 + (ch - '0'); in_num = true;
          }
          ++r;
        }
        if (in_num && field < 3) {
          (field == 0 ? vi : field == 1 ? ti : ni) = sign * val;
          has[field] = true;
        }
        tri[verts][0] = has[0] ? (vi > 0 ? vi - 1 : np + vi) : -1;
        tri[verts][1] = has[1] && ti != 0 ? (ti > 0 ? ti - 1 : nt + ti) : -1;
        tri[verts][2] = has[2] && ni != 0 ? (ni > 0 ? ni - 1 : nn + ni) : -1;
        ++verts;
      }
      for (int32_t k = 1; k + 1 < verts; ++k) {
        std::memcpy(&corners[3 * nc++], tri[0], 3 * sizeof(int32_t));
        std::memcpy(&corners[3 * nc++], tri[k], 3 * sizeof(int32_t));
        std::memcpy(&corners[3 * nc++], tri[k + 1], 3 * sizeof(int32_t));
      }
    }
    p = line_end + 1;
  }
  return 0;
}

}  // extern "C"
