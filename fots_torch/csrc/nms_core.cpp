// Locality-aware polygon NMS core (host side).
//
// TPU-native framework note: the per-pixel quad *decode* runs vectorized on
// device / in NumPy (fots/geometry.py:decode_quads_np); only the inherently
// sequential merge runs here.  This re-implements the observable behavior of
// the reference's nms/nms.h:116-215 + adaptor.cpp glue with an original
// convex-polygon clipper (Sutherland–Hodgman) instead of the vendored
// Clipper library:
//   - locality-aware first pass: each candidate (in row-major scan order)
//     tries to merge with the previously registered polygon, then with the
//     polygons registered at (y-1,x), (y-1,x-1), (y-1,x+1) in poly_map;
//   - weighted-corner merging with per-corner confidence accumulation
//     (int64 fixed-point coordinate accumulators, float probabilities,
//     matching the reference PolyMerger's arithmetic, nms.h:45-110);
//   - a standard greedy score-sorted NMS second pass (nms.h:116-146).
// Reference quirks reproduced for output parity: a candidate that merges
// with nothing is inserted twice (nms.h:208+211), and the (y-1,x+1) lookup
// is unchecked at the row edge (nms.h:194).
//
// The PyTorch port's own copy of native/nms_core.cpp (same algorithm, same
// arithmetic).  Built with g++ by fots_torch/kernels/build.py into
// build/fots_torch/ at first use and loaded via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Poly {
  long long x_[4];
  long long y_[4];
  float score;
  float probs[4];
  int px;
  int py;
};

// ---- convex polygon clipping (original implementation) ----

struct Pt {
  double x, y;
};

// A convex quad clipped by 4 half-planes gains at most one vertex per
// clip edge: <= 8 vertices.  Fixed stack buffers (cap 16 for slack) keep
// the hot path allocation-free — poly_iou runs ~2800x per image in the
// locality pass and heap churn dominated the std::vector version.
static double shoelace(const Pt* p, int n) {
  if (n < 3) return 0;
  double a = 0;
  for (int i = 0; i < n; i++) {
    int j = i + 1 == n ? 0 : i + 1;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * a;
}

// clip subject polygon by the half-plane on the inner side of edge a->b
// (inner = side of the clip polygon interior, given its orientation sign);
// writes into out, returns the new vertex count
static int clip_edge(const Pt* subject, int n, Pt a, Pt b, double orient,
                     Pt* out) {
  if (n == 0) return 0;
  const double ex = b.x - a.x, ey = b.y - a.y;
  int m = 0;
  double sp = (ex * (subject[n - 1].y - a.y) - ey * (subject[n - 1].x - a.x)) * orient;
  for (int i = 0; i < n; i++) {
    const Pt cur = subject[i];
    const Pt prev = subject[(i + n - 1) % n];
    const double sc = (ex * (cur.y - a.y) - ey * (cur.x - a.x)) * orient;
    const bool cin = sc >= 0, pin = sp >= 0;
    if (cin) {
      if (!pin) {
        double t = sp / (sp - sc);
        out[m++] = {prev.x + t * (cur.x - prev.x), prev.y + t * (cur.y - prev.y)};
      }
      out[m++] = cur;
    } else if (pin) {
      double t = sp / (sp - sc);
      out[m++] = {prev.x + t * (cur.x - prev.x), prev.y + t * (cur.y - prev.y)};
    }
    sp = sc;
  }
  return m;
}

static double poly_iou(const Poly& A, const Poly& B) {
  // exact early-out: disjoint axis-aligned bounds => IoU 0 (saves the
  // clipping work for the vast majority of candidate pairs)
  long long ax0 = A.x_[0], ax1 = A.x_[0], ay0 = A.y_[0], ay1 = A.y_[0];
  long long bx0 = B.x_[0], bx1 = B.x_[0], by0 = B.y_[0], by1 = B.y_[0];
  for (int i = 1; i < 4; i++) {
    ax0 = std::min(ax0, A.x_[i]); ax1 = std::max(ax1, A.x_[i]);
    ay0 = std::min(ay0, A.y_[i]); ay1 = std::max(ay1, A.y_[i]);
    bx0 = std::min(bx0, B.x_[i]); bx1 = std::max(bx1, B.x_[i]);
    by0 = std::min(by0, B.y_[i]); by1 = std::max(by1, B.y_[i]);
  }
  if (ax1 < bx0 || bx1 < ax0 || ay1 < by0 || by1 < ay0) return 0.0;

  Pt a[4], b[4];
  for (int i = 0; i < 4; i++) {
    a[i] = {double(A.x_[i]), double(A.y_[i])};
    b[i] = {double(B.x_[i]), double(B.y_[i])};
  }
  double area_a = shoelace(a, 4), area_b = shoelace(b, 4);
  double orient = (area_b >= 0) ? 1.0 : -1.0;
  Pt buf0[16], buf1[16];
  Pt* cur = buf0;
  Pt* nxt = buf1;
  for (int i = 0; i < 4; i++) cur[i] = a[i];
  int n = 4;
  for (int i = 0; i < 4 && n > 0; i++) {
    n = clip_edge(cur, n, b[i], b[(i + 1) % 4], orient, nxt);
    std::swap(cur, nxt);
  }
  double inter_area = std::fabs(shoelace(cur, n));
  double uni = std::fabs(area_a) + std::fabs(area_b) - inter_area;
  return inter_area / std::max(uni, 1.0);
}

// ---- weighted merger (arithmetic mirrors reference PolyMerger) ----

struct Merger {
  long long data[8];
  float score;
  float probs[4];
  Merger() : score(0) {
    std::memset(data, 0, sizeof(data));
    std::memset(probs, 0, sizeof(probs));
  }
  void add(const Poly& p) {
    // parity: the reference's `int64 data[j] += cInt * float` (nms.h:57-67)
    // converts the accumulator to f32, adds the f32 product, and truncates
    // back each time — reproduce that exact round-trip, NOT clean int64
    // accumulation (they differ by a few fixed-point units on chains)
    data[0] = (long long)((float)data[0] + (float)p.x_[0] * p.probs[0]);
    data[1] = (long long)((float)data[1] + (float)p.y_[0] * p.probs[3]);
    data[2] = (long long)((float)data[2] + (float)p.x_[1] * p.probs[0]);
    data[3] = (long long)((float)data[3] + (float)p.y_[1] * p.probs[1]);
    data[4] = (long long)((float)data[4] + (float)p.x_[2] * p.probs[2]);
    data[5] = (long long)((float)data[5] + (float)p.y_[2] * p.probs[1]);
    data[6] = (long long)((float)data[6] + (float)p.x_[3] * p.probs[2]);
    data[7] = (long long)((float)data[7] + (float)p.y_[3] * p.probs[3]);
    score += p.score;
    for (int i = 0; i < 4; i++) probs[i] += p.probs[i];
  }
  Poly get() const {
    Poly p;
    p.x_[0] = (long long)(data[0] / probs[0]);
    p.y_[0] = (long long)(data[1] / probs[3]);
    p.x_[1] = (long long)(data[2] / probs[0]);
    p.y_[1] = (long long)(data[3] / probs[1]);
    p.x_[2] = (long long)(data[4] / probs[2]);
    p.y_[2] = (long long)(data[5] / probs[1]);
    p.x_[3] = (long long)(data[6] / probs[2]);
    p.y_[3] = (long long)(data[7] / probs[3]);
    p.score = score;
    for (int i = 0; i < 4; i++) p.probs[i] = probs[i];
    p.px = 0;
    p.py = 0;
    return p;
  }
};

static bool should_merge(const Poly& a, const Poly& b, float th) {
  return poly_iou(a, b) > th;
}

static void merge_pair(Poly& target, const Poly& incoming, bool incoming_first) {
  Merger m;
  if (incoming_first) {
    m.add(incoming);
    m.add(target);
  } else {
    m.add(target);
    m.add(incoming);
  }
  target = m.get();
}

static std::vector<Poly> standard_nms(std::vector<Poly>& polys, float th) {
  size_t n = polys.size();
  if (n == 0) return {};
  std::vector<size_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::sort(idx.begin(), idx.end(),
            [&](size_t i, size_t j) { return polys[i].score > polys[j].score; });
  std::vector<size_t> keep;
  while (!idx.empty()) {
    size_t p = 0, cur = idx[0];
    keep.push_back(cur);
    for (size_t i = 1; i < idx.size(); i++) {
      if (!should_merge(polys[cur], polys[idx[i]], th)) {
        idx[p++] = idx[i];
      } else {
        merge_pair(polys[cur], polys[idx[i]], /*incoming_first=*/true);
      }
    }
    idx.resize(p);
  }
  std::vector<Poly> out;
  for (size_t k : keep) out.push_back(polys[k]);
  return out;
}

}  // namespace

extern "C" {

// quads: [n,8] int64 fixed-point (x0,y0,...,x3,y3); scores/probs per
// candidate in row-major scan order; returns the number of merged polys
// written (capped at max_out).
int fots_nms(const long long* quads, const float* scores, const float* probs,
             const int* xs, const int* ys, int n, int w, int h, float th1,
             float th2, long long* out_quads, float* out_scores, int max_out) {
  std::vector<int> poly_map((size_t)w * h, -1);
  std::vector<Poly> polys;
  polys.reserve(n * 2);

  for (int i = 0; i < n; i++) {
    Poly poly;
    for (int k = 0; k < 4; k++) {
      poly.x_[k] = quads[i * 8 + 2 * k];
      poly.y_[k] = quads[i * 8 + 2 * k + 1];
    }
    poly.score = scores[i];
    for (int k = 0; k < 4; k++) poly.probs[k] = probs[i * 4 + k];
    poly.px = xs[i];
    poly.py = ys[i];

    bool merged = false;
    if (!polys.empty()) {
      Poly& bpoly = polys.back();
      if (should_merge(poly, bpoly, th1)) {
        merge_pair(bpoly, poly, /*incoming_first=*/false);
        poly_map[(size_t)poly.py * w + poly.px] = (int)polys.size() - 1;
        merged = true;
      } else if (poly.py > 0) {
        int idx = poly_map[(size_t)(poly.py - 1) * w + poly.px];
        if (idx >= 0) {
          if (should_merge(poly, polys[idx], th1)) {
            merge_pair(polys[idx], poly, /*incoming_first=*/false);
            poly_map[(size_t)poly.py * w + poly.px] = idx;
            merged = true;
          }
          if (!merged && poly.px > 0) {
            int idx2 = poly_map[(size_t)(poly.py - 1) * w + poly.px - 1];
            if (idx2 >= 0 && should_merge(poly, polys[idx2], th1)) {
              merge_pair(polys[idx2], poly, false);
              poly_map[(size_t)poly.py * w + poly.px] = idx2;
              merged = true;
            }
          }
          if (!merged) {
            // parity: the reference reads (y-1, x+1) without a column
            // bound (nms.h:194); clamp only against the buffer end
            size_t off = (size_t)(poly.py - 1) * w + poly.px + 1;
            if (off < poly_map.size()) {
              int idx3 = poly_map[off];
              if (idx3 >= 0 && should_merge(poly, polys[idx3], th1)) {
                merge_pair(polys[idx3], poly, false);
                poly_map[(size_t)poly.py * w + poly.px] = idx3;
                merged = true;
              }
            }
          }
        }
      }
      if (!merged) {
        polys.push_back(poly);  // parity: double insert (nms.h:208+211)
      }
    }
    if (!merged) {
      polys.push_back(poly);
      poly_map[(size_t)poly.py * w + poly.px] = (int)polys.size() - 1;
    }
  }

  std::vector<Poly> out = standard_nms(polys, th2);
  int m = std::min((int)out.size(), max_out);
  for (int i = 0; i < m; i++) {
    for (int k = 0; k < 4; k++) {
      out_quads[i * 8 + 2 * k] = out[i].x_[k];
      out_quads[i * 8 + 2 * k + 1] = out[i].y_[k];
    }
    out_scores[i] = out[i].score;
  }
  return (int)out.size();
}

// Standalone rotated-IoU for testing / eval: quads as 8 doubles each.
double fots_quad_iou(const double* qa, const double* qb) {
  Poly A, B;
  for (int k = 0; k < 4; k++) {
    A.x_[k] = (long long)(qa[2 * k] * 10000.0);
    A.y_[k] = (long long)(qa[2 * k + 1] * 10000.0);
    B.x_[k] = (long long)(qb[2 * k] * 10000.0);
    B.y_[k] = (long long)(qb[2 * k + 1] * 10000.0);
  }
  return poly_iou(A, B);
}
}
