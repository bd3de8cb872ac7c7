// Native runtime components: fast dataset IO and a double-precision CPU
// collision oracle.
//
// Role in the framework: the device compute path is JAX/XLA/Pallas; this library
// covers the host-side work the reference implements in C++ — text-format
// dataset parsing (reference: Utils_rai.cu:11-109 readConfiguration*,
// :139-320 loadOBJFile) and the FCL-replacement CPU oracle used for tagging
// ground-truth verdicts (reference: Utils.cu:102-161 checkConfsCPU via FCL).
// The oracle algorithm is an independent double-precision implementation:
// rigid transform -> mesh AABB gate -> per-triangle AABB pair prefilter ->
// exact (tolerance-free) Moller interval tri-tri test with a true coplanar
// 2-D path. It intentionally does NOT share the f32 TOL-band semantics of the
// device kernels so differential tests catch bugs rather than inherit them.
//
// Exposed as a C ABI consumed through ctypes (robocheck/runtime/native.py);
// pure-Python fallbacks exist for every entry point.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// .conf parsing
// ---------------------------------------------------------------------------

// Parse a configuration file. Rows are "x y z pitch yaw roll [valid]".
// Returns the number of rows parsed, or -1 on open failure. If out_confs is
// null, only counts rows (capacity query). out_valid entries are set to -1
// for untagged rows.
int64_t rc_parse_conf(const char* path, float* out_confs, int8_t* out_valid,
                      int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  // Skip the header line if it is not numeric.
  char line[512];
  long data_start = 0;
  if (fgets(line, sizeof line, f)) {
    double probe;
    if (sscanf(line, "%lf", &probe) == 1) {
      // First line is data; rewind.
      fseek(f, 0, SEEK_SET);
    } else {
      data_start = ftell(f);
    }
  }
  (void)data_start;

  int64_t n = 0;
  while (fgets(line, sizeof line, f)) {
    double v[6];
    int valid = -1;
    int got = sscanf(line, "%lf %lf %lf %lf %lf %lf %d", &v[0], &v[1], &v[2],
                     &v[3], &v[4], &v[5], &valid);
    if (got < 6) continue;
    if (out_confs) {
      if (n >= capacity) break;
      for (int k = 0; k < 6; ++k) out_confs[n * 6 + k] = (float)v[k];
      out_valid[n] = (got == 7) ? (int8_t)(valid != 0) : (int8_t)-1;
    }
    ++n;
  }
  fclose(f);
  return n;
}

// Write a tagged configuration file in the reference format
// (header with valid/invalid counts, then "x y z pitch yaw roll valid").
int64_t rc_write_conf(const char* path, const float* confs,
                      const int8_t* valid, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int64_t nv = 0;
  for (int64_t i = 0; i < n; ++i) nv += valid[i] ? 1 : 0;
  fprintf(f, "There are %lld valid configurations and %lld invalid configurations\n",
          (long long)nv, (long long)(n - nv));
  for (int64_t i = 0; i < n; ++i) {
    const float* c = confs + i * 6;
    fprintf(f, "%g %g %g %g %g %g %d\n", c[0], c[1], c[2], c[3], c[4], c[5],
            valid[i] ? 1 : 0);
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// .obj parsing (vertices + fan-triangulated faces, v/vt/vn forms)
// ---------------------------------------------------------------------------

// If out_verts/out_tris are null: capacity query; writes counts to
// out_nv/out_nt and returns 0. Otherwise fills the buffers. Returns -1 on
// open failure, -2 on capacity overflow.
int64_t rc_parse_obj(const char* path, float* out_verts, int32_t* out_tris,
                     int64_t vcap, int64_t tcap, int64_t* out_nv,
                     int64_t* out_nt) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  int64_t nv = 0, nt = 0;
  while (fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x, y, z;
      if (sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        if (out_verts) {
          if (nv >= vcap) { fclose(f); return -2; }
          out_verts[nv * 3 + 0] = (float)x;
          out_verts[nv * 3 + 1] = (float)y;
          out_verts[nv * 3 + 2] = (float)z;
        }
        ++nv;
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      // Collect up to 32 vertex indices ("i", "i/j", "i/j/k", "i//k").
      int32_t idx[32];
      int cnt = 0;
      char* p = line + 2;
      while (*p && cnt < 32) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        long v = strtol(p, &p, 10);
        if (v == 0) break;
        idx[cnt++] = (int32_t)(v - 1);
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') ++p;  // skip /j/k
      }
      for (int k = 1; k + 1 < cnt; ++k) {
        if (out_tris) {
          if (nt >= tcap) { fclose(f); return -2; }
          out_tris[nt * 3 + 0] = idx[0];
          out_tris[nt * 3 + 1] = idx[k];
          out_tris[nt * 3 + 2] = idx[k + 1];
        }
        ++nt;
      }
    }
  }
  fclose(f);
  if (out_nv) *out_nv = nv;
  if (out_nt) *out_nt = nt;
  return 0;
}

// ---------------------------------------------------------------------------
// Double-precision oracle
// ---------------------------------------------------------------------------

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

inline double comp(Vec3 v, int k) { return k == 0 ? v.x : (k == 1 ? v.y : v.z); }

inline int dominant_axis(Vec3 v) {
  double ax = std::fabs(v.x), ay = std::fabs(v.y), az = std::fabs(v.z);
  if (ax >= ay && ax >= az) return 0;
  return (ay >= az) ? 1 : 2;
}

// Interval of a triangle on the intersection line (simplified projection on
// axis `ax`), with corners permuted so corner `alone` is by itself.
inline void interval(const Vec3 t[3], const double dv[3], int ax, int alone,
                     double* lo, double* hi) {
  int o1 = (alone + 1) % 3, o2 = (alone + 2) % 3;
  double pa = comp(t[alone], ax), pb = comp(t[o1], ax), pc = comp(t[o2], ax);
  double da = dv[alone], db = dv[o1], dc = dv[o2];
  double ta = pa + (pb - pa) * da / (da - db);
  double tb = pa + (pc - pa) * da / (da - dc);
  *lo = ta < tb ? ta : tb;
  *hi = ta < tb ? tb : ta;
}

inline int alone_corner(const double dv[3]) {
  if (dv[0] * dv[1] > 0) return 2;
  if (dv[0] * dv[2] > 0) return 1;
  return 0;
}

double orient2d(double ax, double ay, double bx, double by, double cx,
                double cy) {
  return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

bool on_segment(double px, double py, double qx, double qy, double rx,
                double ry) {
  return std::fmin(px, qx) <= rx && rx <= std::fmax(px, qx) &&
         std::fmin(py, qy) <= ry && ry <= std::fmax(py, qy);
}

bool segments_cross_2d(double p1x, double p1y, double p2x, double p2y,
                       double p3x, double p3y, double p4x, double p4y) {
  double d1 = orient2d(p3x, p3y, p4x, p4y, p1x, p1y);
  double d2 = orient2d(p3x, p3y, p4x, p4y, p2x, p2y);
  double d3 = orient2d(p1x, p1y, p2x, p2y, p3x, p3y);
  double d4 = orient2d(p1x, p1y, p2x, p2y, p4x, p4y);
  if (((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0)) && d1 != 0 && d2 != 0 &&
      d3 != 0 && d4 != 0)
    return true;
  if (d1 == 0 && on_segment(p3x, p3y, p4x, p4y, p1x, p1y)) return true;
  if (d2 == 0 && on_segment(p3x, p3y, p4x, p4y, p2x, p2y)) return true;
  if (d3 == 0 && on_segment(p1x, p1y, p2x, p2y, p3x, p3y)) return true;
  if (d4 == 0 && on_segment(p1x, p1y, p2x, p2y, p4x, p4y)) return true;
  return false;
}

bool point_in_tri_2d(double px, double py, const double tx[3],
                     const double ty[3]) {
  double o1 = orient2d(tx[0], ty[0], tx[1], ty[1], px, py);
  double o2 = orient2d(tx[1], ty[1], tx[2], ty[2], px, py);
  double o3 = orient2d(tx[2], ty[2], tx[0], ty[0], px, py);
  return (o1 >= 0 && o2 >= 0 && o3 >= 0) || (o1 <= 0 && o2 <= 0 && o3 <= 0);
}

bool coplanar_overlap(const Vec3 a[3], const Vec3 b[3], Vec3 n) {
  int ax = dominant_axis(n);
  int u = (ax + 1) % 3, v = (ax + 2) % 3;
  double aux[3], auy[3], bux[3], buy[3];
  for (int i = 0; i < 3; ++i) {
    aux[i] = comp(a[i], u);
    auy[i] = comp(a[i], v);
    bux[i] = comp(b[i], u);
    buy[i] = comp(b[i], v);
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      if (segments_cross_2d(aux[i], auy[i], aux[(i + 1) % 3], auy[(i + 1) % 3],
                            bux[j], buy[j], bux[(j + 1) % 3], buy[(j + 1) % 3]))
        return true;
  if (point_in_tri_2d(aux[0], auy[0], bux, buy)) return true;
  if (point_in_tri_2d(bux[0], buy[0], aux, auy)) return true;
  return false;
}

bool tri_tri_intersect(const Vec3 a[3], const Vec3 b[3]) {
  Vec3 n1 = cross(sub(a[1], a[0]), sub(a[2], a[0]));
  double d1 = -dot(n1, a[0]);
  Vec3 n2 = cross(sub(b[1], b[0]), sub(b[2], b[0]));
  double d2 = -dot(n2, b[0]);

  double dv1[3], dv2[3];
  for (int i = 0; i < 3; ++i) dv1[i] = dot(n2, a[i]) + d2;  // a vs plane(b)
  for (int i = 0; i < 3; ++i) dv2[i] = dot(n1, b[i]) + d1;  // b vs plane(a)

  bool sep1 = (dv1[0] > 0 && dv1[1] > 0 && dv1[2] > 0) ||
              (dv1[0] < 0 && dv1[1] < 0 && dv1[2] < 0);
  bool sep2 = (dv2[0] > 0 && dv2[1] > 0 && dv2[2] > 0) ||
              (dv2[0] < 0 && dv2[1] < 0 && dv2[2] < 0);
  if (sep1 || sep2) return false;

  if (dv1[0] == 0 && dv1[1] == 0 && dv1[2] == 0)
    return coplanar_overlap(a, b, n1);

  Vec3 D = cross(n1, n2);
  int ax = dominant_axis(D);
  double lo1, hi1, lo2, hi2;
  interval(a, dv1, ax, alone_corner(dv1), &lo1, &hi1);
  interval(b, dv2, ax, alone_corner(dv2), &lo2, &hi2);
  return !(hi1 < lo2 || hi2 < lo1);
}

// ---------------------------------------------------------------------------
// Static AABB BVH over a triangle set (median split on the longest axis).
//
// The reference's oracle rides FCL's BVHModel<OBBRSS> (`Utils.cu:102-161`);
// a linear Tr x To box scan is algorithmically weaker and flattered the
// vs_baseline ratio. This BVH restores FCL-class asymptotics: per posed
// robot triangle, traversal touches O(log To) boxes instead of To. Pruning
// uses the exact same strict-inequality AABB-overlap condition as the linear
// scan it replaces, and leaves run the identical tri_tri_intersect — the set
// of tri-tri tests whose boxes overlap is unchanged, so verdicts are
// bit-identical (tests assert this against the numpy oracle).
// ---------------------------------------------------------------------------

struct BvhNode {
  double lo[3], hi[3];
  // Internal: left child is node index + 1, right child is `right`.
  // Leaf: right == -1, triangles [start, start + count).
  int32_t right, start, count;
};

class Bvh {
 public:
  // tri_lo/tri_hi: [nt,3] per-triangle AABBs (any order; `order` maps
  // BVH-local triangle slots back to caller triangle ids).
  void build(const double* tri_lo, const double* tri_hi, int64_t nt,
             int leaf_size = 4) {
    order.resize(nt);
    for (int64_t i = 0; i < nt; ++i) order[i] = (int32_t)i;
    nodes.clear();
    nodes.reserve(nt ? 2 * nt : 1);
    if (nt) build_range(tri_lo, tri_hi, 0, (int32_t)nt, leaf_size);
  }

  bool empty() const { return nodes.empty(); }

  std::vector<BvhNode> nodes;
  std::vector<int32_t> order;

 private:
  int32_t build_range(const double* tlo, const double* thi, int32_t begin,
                      int32_t end, int leaf_size) {
    int32_t idx = (int32_t)nodes.size();
    nodes.push_back(BvhNode{});
    BvhNode& stub = nodes.back();
    for (int ax = 0; ax < 3; ++ax) {
      stub.lo[ax] = 1e300;
      stub.hi[ax] = -1e300;
    }
    for (int32_t i = begin; i < end; ++i) {
      const double* lo = tlo + order[i] * 3;
      const double* hi = thi + order[i] * 3;
      for (int ax = 0; ax < 3; ++ax) {
        nodes[idx].lo[ax] = std::fmin(nodes[idx].lo[ax], lo[ax]);
        nodes[idx].hi[ax] = std::fmax(nodes[idx].hi[ax], hi[ax]);
      }
    }
    if (end - begin <= leaf_size) {
      nodes[idx].right = -1;
      nodes[idx].start = begin;
      nodes[idx].count = end - begin;
      return idx;
    }
    int ax = 0;
    double best = -1;
    for (int k = 0; k < 3; ++k) {
      double ext = nodes[idx].hi[k] - nodes[idx].lo[k];
      if (ext > best) {
        best = ext;
        ax = k;
      }
    }
    int32_t mid = (begin + end) / 2;
    std::nth_element(order.begin() + begin, order.begin() + mid,
                     order.begin() + end, [&](int32_t a, int32_t b) {
                       return tlo[a * 3 + ax] + thi[a * 3 + ax] <
                              tlo[b * 3 + ax] + thi[b * 3 + ax];
                     });
    build_range(tlo, thi, begin, mid, leaf_size);
    int32_t right = build_range(tlo, thi, mid, end, leaf_size);
    nodes[idx].right = right;
    nodes[idx].start = 0;
    nodes[idx].count = 0;
    return idx;
  }
};

inline bool box_overlap(const double alo[3], const double ahi[3],
                        const double blo[3], const double bhi[3]) {
  return !(alo[0] > bhi[0] || blo[0] > ahi[0] || alo[1] > bhi[1] ||
           blo[1] > ahi[1] || alo[2] > bhi[2] || blo[2] > ahi[2]);
}

// Squared distance from a point to an axis-aligned box (0 inside).
inline double box_dist2(const Vec3& p, const double lo[3], const double hi[3]) {
  double d2 = 0;
  double dx = p.x < lo[0] ? lo[0] - p.x : (p.x > hi[0] ? p.x - hi[0] : 0);
  double dy = p.y < lo[1] ? lo[1] - p.y : (p.y > hi[1] ? p.y - hi[1] : 0);
  double dz = p.z < lo[2] ? lo[2] - p.z : (p.z > hi[2] ? p.z - hi[2] : 0);
  d2 = dx * dx + dy * dy + dz * dz;
  return d2;
}

// Squared distance from a point to a segment.
inline double point_seg_dist2(const Vec3& p, const Vec3& a, const Vec3& b) {
  Vec3 ab = sub(b, a), ap = sub(p, a);
  double denom = dot(ab, ab);
  double t = denom > 0 ? dot(ap, ab) / denom : 0.0;
  t = t < 0 ? 0 : (t > 1 ? 1 : t);
  Vec3 q = {a.x + t * ab.x, a.y + t * ab.y, a.z + t * ab.z};
  Vec3 d = sub(p, q);
  return dot(d, d);
}

// Exact point-to-triangle squared distance (Ericson, Real-Time Collision
// Detection 5.1.5) — the scalar twin of `planner/sdf.py`'s branch-free form.
// Degenerate (zero-area) triangles fall back to the min edge distance:
// without the guard the interior case divides by va+vb+vc == 0 and the NaN
// silently DROPS the triangle from the BVH min — an overestimated distance
// is an unsound clearance certificate.
inline double point_tri_dist2(const Vec3& p, const Vec3& a, const Vec3& b,
                              const Vec3& c) {
  Vec3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) {
    return dot(ap, ap);
  }
  Vec3 bp = sub(p, b);
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) {
    return dot(bp, bp);
  }
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    Vec3 q = {a.x + v * ab.x, a.y + v * ab.y, a.z + v * ab.z};
    Vec3 d = sub(p, q);
    return dot(d, d);
  }
  Vec3 cp = sub(p, c);
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) {
    return dot(cp, cp);
  }
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    Vec3 q = {a.x + w * ac.x, a.y + w * ac.y, a.z + w * ac.z};
    Vec3 d = sub(p, q);
    return dot(d, d);
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    Vec3 bc = sub(c, b);
    Vec3 q = {b.x + w * bc.x, b.y + w * bc.y, b.z + w * bc.z};
    Vec3 d = sub(p, q);
    return dot(d, d);
  }
  double sum = va + vb + vc;
  if (!(sum > 0) && !(sum < 0)) {  // degenerate or NaN: edges are exact
    double d2 = point_seg_dist2(p, a, b);
    double e2 = point_seg_dist2(p, b, c);
    double f2 = point_seg_dist2(p, c, a);
    return std::fmin(d2, std::fmin(e2, f2));
  }
  double denom = 1.0 / sum;
  double v = vb * denom, w = vc * denom;
  Vec3 q = {a.x + v * ab.x + w * ac.x, a.y + v * ab.y + w * ac.y,
            a.z + v * ab.z + w * ac.z};
  Vec3 d = sub(p, q);
  return dot(d, d);
}

}  // namespace

// Exact min distance from each query point to a triangle mesh's SURFACE
// (unsigned). BVH best-first descent with box-distance pruning: the
// distance-query half of FCL's API the boolean oracle lacked
// (`fcl::distance`; the reference only ever calls `fcl::collide`,
// `Utils.cu:139-160` — this exceeds it). Arrays row-major:
//   verts [nv,3] f64, tris [nt,3] i32, points [np,3] f64, out [np] f64.
// Returns number of points processed.
int64_t rc_point_mesh_dist(const double* verts, const int32_t* tris,
                           int64_t nv, int64_t nt, const double* points,
                           int64_t np, double* out_dist) {
  (void)nv;
  std::vector<Vec3> c(nt * 3);
  std::vector<double> lo(nt * 3), hi(nt * 3);
  for (int64_t t = 0; t < nt; ++t) {
    for (int k = 0; k < 3; ++k) {
      const double* v = verts + (int64_t)tris[t * 3 + k] * 3;
      c[t * 3 + k] = {v[0], v[1], v[2]};
    }
    for (int ax = 0; ax < 3; ++ax) {
      double a = comp(c[t * 3 + 0], ax), b = comp(c[t * 3 + 1], ax),
             d = comp(c[t * 3 + 2], ax);
      lo[t * 3 + ax] = std::fmin(a, std::fmin(b, d));
      hi[t * 3 + ax] = std::fmax(a, std::fmax(b, d));
    }
  }
  Bvh bvh;
  bvh.build(lo.data(), hi.data(), nt);
  if (bvh.empty()) {
    for (int64_t i = 0; i < np; ++i) out_dist[i] = 1e300;
    return np;
  }
  std::vector<int32_t> stack;
  stack.reserve(128);
  for (int64_t i = 0; i < np; ++i) {
    Vec3 p = {points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
    double best2 = 1e300;
    stack.clear();
    stack.push_back(0);
    while (!stack.empty()) {
      int32_t ni = stack.back();
      stack.pop_back();
      const BvhNode& node = bvh.nodes[ni];
      if (box_dist2(p, node.lo, node.hi) >= best2) continue;
      if (node.right == -1) {
        for (int32_t s = node.start; s < node.start + node.count; ++s) {
          int32_t t = bvh.order[s];
          double d2 = point_tri_dist2(p, c[t * 3], c[t * 3 + 1], c[t * 3 + 2]);
          if (d2 < best2) best2 = d2;
        }
      } else {
        // Nearer child last (popped first).
        int32_t l = ni + 1, r = node.right;
        double dl = box_dist2(p, bvh.nodes[l].lo, bvh.nodes[l].hi);
        double dr = box_dist2(p, bvh.nodes[r].lo, bvh.nodes[r].hi);
        if (dl < dr) {
          stack.push_back(r);
          stack.push_back(l);
        } else {
          stack.push_back(l);
          stack.push_back(r);
        }
      }
    }
    out_dist[i] = std::sqrt(best2);
  }
  return np;
}

// Oracle over a batch of configurations. Arrays are row-major:
//   rob_verts [nrv,3] f64, rob_tris [nrt,3] i32, obs_verts/tris likewise,
//   confs [n,6] f32 (x,y,z,pitch,yaw,roll), out_valid [n] i8 (1 = no hit).
// Returns number of configurations processed.
int64_t rc_oracle_check(const double* rob_verts, const int32_t* rob_tris,
                        int64_t nrv, int64_t nrt, const double* obs_verts,
                        const int32_t* obs_tris, int64_t nov, int64_t not_,
                        const float* confs, int64_t n, int8_t* out_valid) {
  // Precompute obstacle triangle corners + AABBs + mesh AABB.
  std::vector<Vec3> obs_c(not_ * 3);
  std::vector<double> obs_lo(not_ * 3), obs_hi(not_ * 3);
  double mesh_lo[3] = {1e300, 1e300, 1e300}, mesh_hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t t = 0; t < not_; ++t) {
    for (int k = 0; k < 3; ++k) {
      const double* v = obs_verts + obs_tris[t * 3 + k] * 3;
      obs_c[t * 3 + k] = {v[0], v[1], v[2]};
    }
    for (int ax = 0; ax < 3; ++ax) {
      double lo = 1e300, hi = -1e300;
      for (int k = 0; k < 3; ++k) {
        double c = comp(obs_c[t * 3 + k], ax);
        lo = std::fmin(lo, c);
        hi = std::fmax(hi, c);
      }
      obs_lo[t * 3 + ax] = lo;
      obs_hi[t * 3 + ax] = hi;
      mesh_lo[ax] = std::fmin(mesh_lo[ax], lo);
      mesh_hi[ax] = std::fmax(mesh_hi[ax], hi);
    }
  }

  // Acceleration structure over the static obstacle, built once per batch
  // (FCL builds its BVHModel once per mesh, `Utils.cu:119-130`).
  Bvh bvh;
  bvh.build(obs_lo.data(), obs_hi.data(), not_);

  std::vector<Vec3> rv(nrv);
  std::vector<Vec3> rc(nrt * 3);
  std::vector<double> rlo(nrt * 3), rhi(nrt * 3);

  for (int64_t i = 0; i < n; ++i) {
    const float* cf = confs + i * 6;
    double x = cf[0], y = cf[1], z = cf[2];
    double pitch = cf[3], yaw = cf[4], roll = cf[5];
    double ca = std::cos(yaw), sa = std::sin(yaw);
    double cb = std::cos(pitch), sb = std::sin(pitch);
    double cc = std::cos(roll), sc = std::sin(roll);
    double R[3][3] = {
        {ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc},
        {sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc},
        {-sb, cb * sc, cb * cc},
    };

    double rm_lo[3] = {1e300, 1e300, 1e300}, rm_hi[3] = {-1e300, -1e300, -1e300};
    for (int64_t vtx = 0; vtx < nrv; ++vtx) {
      const double* v = rob_verts + vtx * 3;
      Vec3 p = {R[0][0] * v[0] + R[0][1] * v[1] + R[0][2] * v[2] + x,
                R[1][0] * v[0] + R[1][1] * v[1] + R[1][2] * v[2] + y,
                R[2][0] * v[0] + R[2][1] * v[1] + R[2][2] * v[2] + z};
      rv[vtx] = p;
      rm_lo[0] = std::fmin(rm_lo[0], p.x); rm_hi[0] = std::fmax(rm_hi[0], p.x);
      rm_lo[1] = std::fmin(rm_lo[1], p.y); rm_hi[1] = std::fmax(rm_hi[1], p.y);
      rm_lo[2] = std::fmin(rm_lo[2], p.z); rm_hi[2] = std::fmax(rm_hi[2], p.z);
    }

    // Mesh-level AABB gate.
    bool gate = true;
    for (int ax = 0; ax < 3; ++ax)
      gate = gate && rm_lo[ax] <= mesh_hi[ax] && mesh_lo[ax] <= rm_hi[ax];
    if (!gate) {
      out_valid[i] = 1;
      continue;
    }

    // Posed robot triangle corners + AABBs.
    for (int64_t t = 0; t < nrt; ++t) {
      for (int k = 0; k < 3; ++k) rc[t * 3 + k] = rv[rob_tris[t * 3 + k]];
      for (int ax = 0; ax < 3; ++ax) {
        double lo = 1e300, hi = -1e300;
        for (int k = 0; k < 3; ++k) {
          double c = comp(rc[t * 3 + k], ax);
          lo = std::fmin(lo, c);
          hi = std::fmax(hi, c);
        }
        rlo[t * 3 + ax] = lo;
        rhi[t * 3 + ax] = hi;
      }
    }

    // Per posed robot triangle: obstacle-BVH traversal (box pruning is the
    // same strict-inequality test as the old linear scan; leaves run the
    // identical exact tri-tri predicate, so verdicts are unchanged).
    bool hit = false;
    int32_t stack[64];
    for (int64_t tr = 0; tr < nrt && !hit; ++tr) {
      const double* alo = &rlo[tr * 3];
      const double* ahi = &rhi[tr * 3];
      if (bvh.empty()) break;
      int sp = 0;
      stack[sp++] = 0;
      while (sp && !hit) {
        const BvhNode& node = bvh.nodes[stack[--sp]];
        if (!box_overlap(alo, ahi, node.lo, node.hi)) continue;
        if (node.right < 0) {
          for (int32_t s = node.start; s < node.start + node.count; ++s) {
            int32_t to = bvh.order[s];
            if (!box_overlap(alo, ahi, &obs_lo[to * 3], &obs_hi[to * 3]))
              continue;
            if (tri_tri_intersect(&rc[tr * 3], &obs_c[to * 3])) {
              hit = true;
              break;
            }
          }
        } else {
          int32_t me = (int32_t)(&node - bvh.nodes.data());
          stack[sp++] = node.right;
          stack[sp++] = me + 1;
        }
      }
    }
    out_valid[i] = hit ? 0 : 1;
  }
  return n;
}

}  // extern "C"
