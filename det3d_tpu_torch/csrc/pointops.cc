// Native host-side geometry kernels for the data pipeline: the port's copy
// of det3d_tpu/csrc/pointops.cc, without its OpenMP pragmas.
//
// The reference implements these hot paths as numba JIT kernels inside
// DataLoader workers (det3d/core/sampler/preprocess.py box_collision_test
// :877, points_in_rbbox via box_np_ops :1100). Scalar loops over a C ABI,
// bound with ctypes (core/augment.py::pointops_lib), one thread a process:
// the data loader's workers are the parallelism axis, and the loader forks
// them, which libgomp does not survive. Conventions match core/augment.py:
// BEV corner = R(-theta) @ local + center. The numpy twins are
// core/augment.py's ``*_ref`` functions and ``intersection_area_corners``.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

struct Vec2 { double x, y; };

inline double cross(const Vec2& o, const Vec2& a, const Vec2& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Liang-Barsky clip of quad-P edges against quad Q; returns the shoelace
// contribution (same algorithm as core/geometry.rotated_intersection_area).
double clip_contrib(const Vec2* P, const Vec2* Q, bool open_side) {
  const double EPS = 1e-8;
  double total = 0.0;
  for (int i = 0; i < 4; ++i) {
    const Vec2& p1 = P[i];
    const Vec2& p2 = P[(i + 1) & 3];
    double dx = p2.x - p1.x, dy = p2.y - p1.y;
    double t_lo = 0.0, t_hi = 1.0;
    bool ok = true;
    for (int j = 0; j < 4; ++j) {
      double ex = Q[(j + 1) & 3].x - Q[j].x;
      double ey = Q[(j + 1) & 3].y - Q[j].y;
      double a = ex * (p1.y - Q[j].y) - ey * (p1.x - Q[j].x);
      double b = ex * dy - ey * dx;
      if (std::fabs(b) > EPS) {
        double tj = -a / b;
        if (b > 0) t_lo = std::max(t_lo, tj);
        else t_hi = std::min(t_hi, tj);
      } else if (open_side ? (a <= EPS) : (a < -EPS)) {
        ok = false;
        break;
      }
    }
    if (ok && t_lo < t_hi) {
      double x1 = p1.x + t_lo * dx, y1 = p1.y + t_lo * dy;
      double x2 = p1.x + t_hi * dx, y2 = p1.y + t_hi * dy;
      total += x1 * y2 - x2 * y1;
    }
  }
  return total;
}

void make_ccw(Vec2* c) {
  double area2 = cross(c[0], c[1], c[2]) + cross(c[0], c[2], c[3]);
  if (area2 < 0) std::swap(c[0], c[3]), std::swap(c[1], c[2]);
}

// boxes: [x, y, w, l, r]
void box_corners(const float* b, Vec2* out) {
  double c = std::cos((double)b[4]), s = std::sin((double)b[4]);
  double dx = b[2] / 2.0, dy = b[3] / 2.0;
  const double lx[4] = {-dx, -dx, dx, dx};
  const double ly[4] = {-dy, dy, dy, -dy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = lx[i] * c + ly[i] * s + b[0];
    out[i].y = -lx[i] * s + ly[i] * c + b[1];
  }
}

double inter_area(const Vec2* a_in, const Vec2* b_in) {
  Vec2 a[4], b[4];
  for (int i = 0; i < 4; ++i) { a[i] = a_in[i]; b[i] = b_in[i]; }
  make_ccw(a);
  make_ccw(b);
  double total = clip_contrib(a, b, false) + clip_contrib(b, a, true);
  return std::max(0.5 * total, 0.0);
}

}  // namespace

extern "C" {

// points (P, point_stride) float32; boxes (N, 7) [x y z w l h r] float32;
// out (P, N) uint8 row-major.
void points_in_rbbox(const float* points, int64_t n_points,
                     int64_t point_stride, const float* boxes,
                     int64_t n_boxes, uint8_t* out) {
  for (int64_t i = 0; i < n_points; ++i) {
    const float* p = points + i * point_stride;
    uint8_t* row = out + i * n_boxes;
    for (int64_t n = 0; n < n_boxes; ++n) {
      const float* b = boxes + n * 7;
      double dxp = p[0] - b[0], dyp = p[1] - b[1], dzp = p[2] - b[2];
      double c = std::cos((double)b[6]), s = std::sin((double)b[6]);
      double lx = dxp * c - dyp * s;
      double ly = dxp * s + dyp * c;
      row[n] = (std::fabs(lx) <= b[3] / 2.0 && std::fabs(ly) <= b[4] / 2.0 &&
                std::fabs(dzp) <= b[5] / 2.0)
                   ? 1
                   : 0;
    }
  }
}

// boxes_a (N, 5), boxes_b (K, 5) BEV [x y w l r]; out (N, K) uint8.
void box_collision(const float* boxes_a, int64_t n, const float* boxes_b,
                   int64_t k, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    Vec2 ca[4];
    box_corners(boxes_a + i * 5, ca);
    double minax = std::min(std::min(ca[0].x, ca[1].x),
                            std::min(ca[2].x, ca[3].x));
    double maxax = std::max(std::max(ca[0].x, ca[1].x),
                            std::max(ca[2].x, ca[3].x));
    double minay = std::min(std::min(ca[0].y, ca[1].y),
                            std::min(ca[2].y, ca[3].y));
    double maxay = std::max(std::max(ca[0].y, ca[1].y),
                            std::max(ca[2].y, ca[3].y));
    for (int64_t j = 0; j < k; ++j) {
      Vec2 cb[4];
      box_corners(boxes_b + j * 5, cb);
      // standup reject first (cheap)
      double minbx = std::min(std::min(cb[0].x, cb[1].x),
                              std::min(cb[2].x, cb[3].x));
      double maxbx = std::max(std::max(cb[0].x, cb[1].x),
                              std::max(cb[2].x, cb[3].x));
      double minby = std::min(std::min(cb[0].y, cb[1].y),
                              std::min(cb[2].y, cb[3].y));
      double maxby = std::max(std::max(cb[0].y, cb[1].y),
                              std::max(cb[2].y, cb[3].y));
      if (maxax < minbx || maxbx < minax || maxay < minby || maxby < minay) {
        out[i * k + j] = 0;
        continue;
      }
      out[i * k + j] = inter_area(ca, cb) > 1e-8 ? 1 : 0;
    }
  }
}

// paired rotated intersection areas: corners (N, 4, 2) x2 float64 -> (N,)
void intersection_area(const double* corners_a, const double* corners_b,
                       int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    Vec2 a[4], b[4];
    for (int j = 0; j < 4; ++j) {
      a[j] = {corners_a[i * 8 + j * 2], corners_a[i * 8 + j * 2 + 1]};
      b[j] = {corners_b[i * 8 + j * 2], corners_b[i * 8 + j * 2 + 1]};
    }
    out[i] = inter_area(a, b);
  }
}

}  // extern "C"
