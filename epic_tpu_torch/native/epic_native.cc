// epic_native — C++ helpers for epic_tpu_torch: the port's own copy of
// epic_tpu/native/epic_native.cc. Below this header the code is the same
// bytes up to the 3D streamline walker at the end, which is the port's own;
// only this header comment is rewritten.
//
// The relaxation sweeps run as CUDA kernels (csrc/); this library
// provides the host-side native pieces the reference implements in C++:
//
//   * float32 streamline extraction: the sequential, data-dependent
//     gradient-ascent walk (semantics of
//     the reference's libepic/src/harmonic/harmonic_path_cpu.cpp — bilinear
//     potential, unit-normalised central differences, 5-point stuck history,
//     <=2-point rejection), written fresh against that documented contract.
//   * legacy non-log SOR relaxation in float/double/long-double
//     (harmonic_legacy_cpu.cpp semantics: row-major in-place Gauss-Seidel,
//     omega relaxation, 10000-iteration floor) — the precision-collapse
//     baseline for the paper's comparison harness.
//   * a scalar float32 red-black log-space sweep, used as an independent
//     oracle for the solvers.
//   * (the port's own, at the end) the 3D walker of
//     epic_tpu_torch.path3d: trilinear potential, six central differences.
//
// Everything is a flat C ABI over caller-owned buffers (no structs, no
// allocation except the caller-provided path buffer), loaded via ctypes.
//
// Build: epic_tpu_torch.native (g++ -O3 -shared -fPIC -fopenmp, at first use).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrInvalidData = 2;
constexpr int kErrInvalidLocation = 10;
constexpr int kErrInvalidGradient = 12;
constexpr int kErrInvalidPath = 13;
// Not a reference code: the walk finished but out_xy could not hold it.
// *n_out carries the true point count so the caller can retry with an
// exact-size buffer.
constexpr int kErrTruncated = 100;

constexpr int kStuckHistory = 5;
constexpr float kObstacleLog = -1e6f;

// Interpolation corner selection.
enum class Interp : int { kReference = 0, kBilinear = 1 };

inline int cell_index(float v) {
  const float f = v + 0.5f;
  if (f < 0.0f) return -1;
  return static_cast<int>(f);
}

// Validity of a sample point: inside the map and not over a locked
// negative-potential (obstacle) cell. Goal cells (locked, u == 0) are valid.
inline bool location_ok(const float* u, const uint8_t* locked, int h, int w,
                        float x, float y) {
  const int xc = cell_index(x);
  const int yc = cell_index(y);
  if (xc < 0 || yc < 0 || xc >= w || yc >= h) return false;
  const int idx = yc * w + xc;
  return !(locked[idx] && u[idx] < 0.0f);
}

// Interpolated potential. Returns false if the location is invalid.
inline bool potential_at(const float* u, const uint8_t* locked, int h, int w,
                         float x, float y, Interp interp, float* out) {
  if (!location_ok(u, locked, h, w, x, y)) return false;
  int xl, yl;
  if (interp == Interp::kReference) {
    // Truncated +-0.5 corner pair; alpha/beta may exceed 1 (extrapolation),
    // faithfully to the reference's observable numerics.
    xl = static_cast<int>(x - 0.5f);
    yl = static_cast<int>(y - 0.5f);
    if (xl < 0) xl = 0;
    if (yl < 0) yl = 0;
  } else {
    xl = static_cast<int>(x);
    yl = static_cast<int>(y);
    if (xl > w - 2) xl = w - 2;
    if (yl > h - 2) yl = h - 2;
  }
  int xr, yb;
  if (interp == Interp::kReference) {
    xr = static_cast<int>(x + 0.5f);
    yb = static_cast<int>(y + 0.5f);
  } else {
    xr = xl + 1;
    yb = yl + 1;
  }
  const float alpha = x - static_cast<float>(xl);
  const float beta = y - static_cast<float>(yl);
  const float top = (1.0f - alpha) * u[yl * w + xl] + alpha * u[yl * w + xr];
  const float bot = (1.0f - alpha) * u[yb * w + xl] + alpha * u[yb * w + xr];
  *out = (1.0f - beta) * top + beta * bot;
  return true;
}

// Unit-normalised central-difference gradient; false on invalid samples or
// zero/non-finite norm.
inline bool gradient_at(const float* u, const uint8_t* locked, int h, int w,
                        float x, float y, float cd, Interp interp, float* gx,
                        float* gy) {
  float v0, v1, v2, v3;
  if (!potential_at(u, locked, h, w, x - cd, y, interp, &v0) ||
      !potential_at(u, locked, h, w, x + cd, y, interp, &v1) ||
      !potential_at(u, locked, h, w, x, y - cd, interp, &v2) ||
      !potential_at(u, locked, h, w, x, y + cd, interp, &v3)) {
    return false;
  }
  float px = (v1 - v0) / (2.0f * cd);
  float py = (v3 - v2) / (2.0f * cd);
  // Norm in double then one rounding: the reference's std::pow(px, 2)
  // promotes to f64 (harmonic_path_cpu.cpp:113); doing this in f32 walks a
  // different (1-ulp-off) streamline.
  const float norm = static_cast<float>(std::sqrt(
      static_cast<double>(px) * px + static_cast<double>(py) * py));
  if (norm == 0.0f || !std::isfinite(norm)) return false;
  *gx = px / norm;
  *gy = py / norm;
  return true;
}

inline bool is_stuck(const std::vector<float>& xs, const std::vector<float>& ys,
                     float step) {
  const int n = static_cast<int>(xs.size());
  if (n < 2) return false;
  const float x = xs[n - 1];
  const float y = ys[n - 1];
  const int lo = n - 1 - kStuckHistory < 0 ? 0 : n - 1 - kStuckHistory;
  for (int i = n - 2; i >= lo; --i) {
    const float dx = x - xs[i];
    const float dy = y - ys[i];
    // f64 distance, as the reference's std::pow promotes
    // (harmonic_path_cpu.cpp:139-143).
    if (std::sqrt(static_cast<double>(dx) * dx + static_cast<double>(dy) * dy) <
        step * 0.5f)
      return true;
  }
  return false;
}

template <typename T>
int sor_relax(T* u, const uint8_t* locked, int h, int w, T eps, T omega,
              unsigned int min_iters, unsigned int* iters_out) {
  if (u == nullptr || locked == nullptr || h < 3 || w < 3) {
    return kErrInvalidData;
  }
  T delta = eps + T(1);
  unsigned int iter = 0;
  while (delta >= eps || iter < min_iters) {
    delta = T(0);
    for (int y = 1; y < h - 1; ++y) {
      for (int x = 1; x < w - 1; ++x) {
        const int idx = y * w + x;
        if (locked[idx]) continue;
        const T prev = u[idx];
        u[idx] = (T(1) - omega) * u[idx] +
                 omega / T(4) *
                     (u[idx - w] + u[idx + w] + u[idx - 1] + u[idx + 1]);
        const T d = std::fabs(u[idx] - prev);
        if (d > delta) delta = d;
      }
    }
    ++iter;
  }
  if (iters_out != nullptr) *iters_out = iter;
  return kOk;
}

}  // namespace

extern "C" {

// Streamline extraction. out_xy must hold 2*capacity floats. Returns a
// result code; on success *n_out is the number of points written
// (truncated to capacity).
int epic_path2d_f32(const float* u, const uint8_t* locked, int h, int w,
                    float x, float y, float step, float cd, int max_points,
                    int interp_mode, float* out_xy, int capacity, int* n_out) {
  if (u == nullptr || locked == nullptr || out_xy == nullptr ||
      n_out == nullptr || h < 1 || w < 1) {
    return kErrInvalidData;
  }
  if (!location_ok(u, locked, h, w, x, y)) return kErrInvalidLocation;
  const Interp interp = static_cast<Interp>(interp_mode);

  std::vector<float> xs{x};
  std::vector<float> ys{y};
  int xc = cell_index(x);
  int yc = cell_index(y);
  while (!locked[yc * w + xc] && !is_stuck(xs, ys, step) &&
         static_cast<int>(xs.size()) < max_points) {
    float gx, gy;
    if (!gradient_at(u, locked, h, w, x, y, cd, interp, &gx, &gy)) {
      return kErrInvalidGradient;
    }
    x += gx * step;
    y += gy * step;
    xs.push_back(x);
    ys.push_back(y);
    xc = cell_index(x);
    yc = cell_index(y);
    if (xc < 0 || yc < 0 || xc >= w || yc >= h) return kErrInvalidGradient;
  }
  if (xs.size() <= 2) return kErrInvalidPath;

  const int full = static_cast<int>(xs.size());
  int n = full;
  if (n > capacity) n = capacity;
  for (int i = 0; i < n; ++i) {
    out_xy[2 * i] = xs[i];
    out_xy[2 * i + 1] = ys[i];
  }
  if (full > capacity) {
    *n_out = full;  // true count — caller retries with an exact buffer
    return kErrTruncated;
  }
  *n_out = n;
  return kOk;
}

// One scalar red-black log-space sweep (float32), parity and numerics as the
// reference CPU update; delta over updated cells.
int epic_sweep2d_f32(float* u, const uint8_t* locked, int h, int w,
                     int iteration, float* delta_out) {
  if (u == nullptr || locked == nullptr || h < 3 || w < 3) {
    return kErrInvalidData;
  }
  const float log4 = std::log(4.0f);
  float delta = 0.0f;
  // Red-black parity makes every update in a sweep independent (all four
  // neighbour reads are the opposite class), so row-parallelism is
  // bit-exact: disjoint writes, order-free max reduction.
#ifdef _OPENMP
#pragma omp parallel for reduction(max : delta) schedule(static)
#endif
  for (int y = 1; y < h - 1; ++y) {
    // Start column so that (y + x) % 2 != iteration % 2.
    const int x0 = 1 + ((y + iteration) % 2);
    for (int x = x0; x < w - 1; x += 2) {
      const int idx = y * w + x;
      if (locked[idx]) continue;
      const float prev = u[idx];
      const float a = u[idx - w];
      const float b = u[idx + w];
      const float c = u[idx - 1];
      const float d = u[idx + 1];
      float m = a > b ? a : b;
      if (c > m) m = c;
      if (d > m) m = d;
      const float s = std::exp(a - m) + std::exp(b - m) + std::exp(c - m) +
                      std::exp(d - m);
      u[idx] = m + std::log(s) - log4;
      const float dd = std::fabs(prev - u[idx]);
      if (dd > delta) delta = dd;
    }
  }
  if (delta_out != nullptr) *delta_out = delta;
  return kOk;
}

// Full log-space relaxation to convergence (float32): the exact protocol of
// the reference's harmonic_complete_cpu (harmonic_cpu.cpp:136-184) — one
// checked sweep, exit only when its delta < eps AND iteration >= max(h, w),
// otherwise stagger-1 plain sweeps before the next check. Iteration counts
// are therefore always == 1 (mod stagger) on convergence, matching the JAX
// solvers bit-for-bit in count and to float tolerance in field.
int epic_solve2d_f32(float* u, const uint8_t* locked, int h, int w, float eps,
                     unsigned int stagger, unsigned int max_iterations,
                     unsigned int* iters_out, float* delta_out,
                     int* converged_out) {
  if (u == nullptr || locked == nullptr || h < 3 || w < 3 || stagger == 0) {
    return kErrInvalidData;
  }
  const unsigned int m_max = static_cast<unsigned int>(h > w ? h : w);
  unsigned int iteration = 0;
  float delta = eps + 1.0f;
  bool converged = false;
  while (!converged && iteration < max_iterations) {
    int code = epic_sweep2d_f32(u, locked, h, w, static_cast<int>(iteration),
                                &delta);
    if (code != kOk) return code;
    ++iteration;
    converged = (delta < eps) && (iteration >= m_max);
    if (!converged) {
      for (unsigned int k = 0; k + 1 < stagger; ++k) {
        code = epic_sweep2d_f32(u, locked, h, w, static_cast<int>(iteration),
                                nullptr);
        if (code != kOk) return code;
        ++iteration;
      }
    }
  }
  if (iters_out != nullptr) *iters_out = iteration;
  if (delta_out != nullptr) *delta_out = delta;
  if (converged_out != nullptr) *converged_out = converged ? 1 : 0;
  return kOk;
}

// Legacy non-log SOR, three precisions (min_iters floor = 10000 in the
// reference; exposed as a parameter here).
int epic_sor2d_f32(float* u, const uint8_t* locked, int h, int w, float eps,
                   float omega, unsigned int min_iters, unsigned int* iters) {
  return sor_relax<float>(u, locked, h, w, eps, omega, min_iters, iters);
}

int epic_sor2d_f64(double* u, const uint8_t* locked, int h, int w, double eps,
                   double omega, unsigned int min_iters, unsigned int* iters) {
  return sor_relax<double>(u, locked, h, w, eps, omega, min_iters, iters);
}

int epic_sor2d_f80(long double* u, const uint8_t* locked, int h, int w,
                   long double eps, long double omega, unsigned int min_iters,
                   unsigned int* iters) {
  return sor_relax<long double>(u, locked, h, w, eps, omega, min_iters, iters);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The port's own addition: the 3D streamline walker. Everything above is the
// JAX package's source byte for byte; everything below is this port's.
//
// The rule of epic_tpu_torch.path3d.compute_path, point for point: trilinear
// potential over the 8 surrounding cell centres (corners floor(v) and
// floor(v) + 1, clamped to the volume, never extrapolating), unit-normalised
// central differences at cd_precision (sample points rounded once from the
// double difference, the norm in double and rounded once), float32 steps,
// the stuck test against the last 5 points in double, off-volume and
// <=2-point errors. u and locked are [d, h, w], row major.
// ---------------------------------------------------------------------------

namespace {

inline int64_t voxel(int h, int w, int z, int y, int x) {
  return (static_cast<int64_t>(z) * h + y) * w + x;
}

inline bool location_ok_3d(const float* u, const uint8_t* locked, int d, int h,
                           int w, float x, float y, float z) {
  const int xc = cell_index(x);
  const int yc = cell_index(y);
  const int zc = cell_index(z);
  if (xc < 0 || yc < 0 || zc < 0 || xc >= w || yc >= h || zc >= d) return false;
  const int64_t idx = voxel(h, w, zc, yc, xc);
  return !(locked[idx] && u[idx] < 0.0f);
}

// Trilinear potential: bilinear on the z0 plane, then on z0 + 1, then a
// lerp along z. Returns false if the location is invalid.
inline bool potential_3d(const float* u, const uint8_t* locked, int d, int h,
                         int w, float x, float y, float z, float* out) {
  if (!location_ok_3d(u, locked, d, h, w, x, y, z)) return false;
  int x0 = static_cast<int>(x);
  int y0 = static_cast<int>(y);
  int z0 = static_cast<int>(z);
  if (x0 > w - 2) x0 = w - 2;
  if (y0 > h - 2) y0 = h - 2;
  if (z0 > d - 2) z0 = d - 2;
  const float a = x - static_cast<float>(x0);
  const float b = y - static_cast<float>(y0);
  const float c = z - static_cast<float>(z0);
  const float* p0 = u + voxel(h, w, z0, y0, x0);
  const float* p1 = u + voxel(h, w, z0 + 1, y0, x0);
  const float p00 = (1.0f - a) * p0[0] + a * p0[1];
  const float p01 = (1.0f - a) * p0[w] + a * p0[w + 1];
  const float pz0 = (1.0f - b) * p00 + b * p01;
  const float p10 = (1.0f - a) * p1[0] + a * p1[1];
  const float p11 = (1.0f - a) * p1[w] + a * p1[w + 1];
  const float pz1 = (1.0f - b) * p10 + b * p11;
  *out = (1.0f - c) * pz0 + c * pz1;
  return true;
}

// The sample point v - cd or v + cd: the double difference rounded once to
// float32, as the NumPy walker computes it from Python floats.
inline float offset(float v, double cd) {
  return static_cast<float>(static_cast<double>(v) + cd);
}

inline bool gradient_3d(const float* u, const uint8_t* locked, int d, int h,
                        int w, float x, float y, float z, double cd, float* gx,
                        float* gy, float* gz) {
  float v[6];
  if (!potential_3d(u, locked, d, h, w, offset(x, -cd), y, z, &v[0]) ||
      !potential_3d(u, locked, d, h, w, offset(x, cd), y, z, &v[1]) ||
      !potential_3d(u, locked, d, h, w, x, offset(y, -cd), z, &v[2]) ||
      !potential_3d(u, locked, d, h, w, x, offset(y, cd), z, &v[3]) ||
      !potential_3d(u, locked, d, h, w, x, y, offset(z, -cd), &v[4]) ||
      !potential_3d(u, locked, d, h, w, x, y, offset(z, cd), &v[5])) {
    return false;
  }
  const float cd2 = 2.0f * static_cast<float>(cd);
  const float px = (v[1] - v[0]) / cd2;
  const float py = (v[3] - v[2]) / cd2;
  const float pz = (v[5] - v[4]) / cd2;
  const float norm = static_cast<float>(
      std::sqrt(static_cast<double>(px) * px + static_cast<double>(py) * py +
                static_cast<double>(pz) * pz));
  if (norm == 0.0f || !std::isfinite(norm)) return false;
  *gx = px / norm;
  *gy = py / norm;
  *gz = pz / norm;
  return true;
}

inline bool is_stuck_3d(const std::vector<float>& xyz, double step) {
  const int64_t n = static_cast<int64_t>(xyz.size()) / 3;
  if (n < 2) return false;
  const double x = xyz[3 * (n - 1)];
  const double y = xyz[3 * (n - 1) + 1];
  const double z = xyz[3 * (n - 1) + 2];
  const int64_t lo = n - 1 - kStuckHistory < 0 ? 0 : n - 1 - kStuckHistory;
  for (int64_t i = n - 2; i >= lo; --i) {
    const double dx = x - xyz[3 * i];
    const double dy = y - xyz[3 * i + 1];
    const double dz = z - xyz[3 * i + 2];
    if (std::sqrt(dx * dx + dy * dy + dz * dz) < step / 2.0) return true;
  }
  return false;
}

}  // namespace

extern "C" {

// 3D streamline extraction from (x, y, z). out_xyz must hold 3*capacity
// floats. Returns a result code; on success *n_out is the number of points
// written; a walk longer than capacity returns kErrTruncated with its true
// count in *n_out.
int epic_path3d_f32(const float* u, const uint8_t* locked, int d, int h, int w,
                    float x, float y, float z, double step, double cd,
                    int64_t max_points, float* out_xyz, int64_t capacity,
                    int64_t* n_out) {
  if (u == nullptr || locked == nullptr || out_xyz == nullptr ||
      n_out == nullptr || d < 2 || h < 2 || w < 2) {
    return kErrInvalidData;
  }
  if (!location_ok_3d(u, locked, d, h, w, x, y, z)) return kErrInvalidLocation;
  const float stepf = static_cast<float>(step);
  std::vector<float> xyz{x, y, z};
  int xc = cell_index(x);
  int yc = cell_index(y);
  int zc = cell_index(z);
  while (!locked[voxel(h, w, zc, yc, xc)] && !is_stuck_3d(xyz, step) &&
         static_cast<int64_t>(xyz.size()) / 3 < max_points) {
    float gx, gy, gz;
    if (!gradient_3d(u, locked, d, h, w, x, y, z, cd, &gx, &gy, &gz)) {
      return kErrInvalidGradient;
    }
    x += gx * stepf;
    y += gy * stepf;
    z += gz * stepf;
    xyz.push_back(x);
    xyz.push_back(y);
    xyz.push_back(z);
    xc = cell_index(x);
    yc = cell_index(y);
    zc = cell_index(z);
    if (xc < 0 || yc < 0 || zc < 0 || xc >= w || yc >= h || zc >= d) {
      return kErrInvalidGradient;
    }
  }
  const int64_t full = static_cast<int64_t>(xyz.size()) / 3;
  if (full <= 2) return kErrInvalidPath;
  const int64_t n = full > capacity ? capacity : full;
  for (int64_t i = 0; i < 3 * n; ++i) out_xyz[i] = xyz[i];
  *n_out = full;
  return full > capacity ? kErrTruncated : kOk;
}

}  // extern "C"
