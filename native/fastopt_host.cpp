// fastopt_host: native host-side runtime for fastoptsolver_tpu.
//
// The accelerator owns the solver math (JAX/XLA); this library owns the
// host-side data plane around it — the role BLAS/Fortran play under the
// reference's NumPy/SciPy stack (SURVEY.md §2 "Native components"), rebuilt
// as a standalone C++ runtime:
//
//   * batched Boston-like scenario generation (counter-based SplitMix64 →
//     Box–Muller, so any (seed, instance) pair is reproducible and
//     generation parallelizes embarrassingly across threads),
//   * per-instance column standardization,
//   * batched Gram precompute (Q = AᵀA, c = Aᵀb, bᵀb) so large sweeps can
//     stream ready-to-solve Gram tensors to the device while it solves the
//     previous batch (double-buffered loader in runtime/host.py).
//
// C ABI only — consumed from Python via ctypes (no pybind11 in this image).
//
// Statistical contract matches problems/generators.py:generate_scenario_batch:
// block1 (rooms, crime) ~ MVN([6, .2], .25·[[1,ρ1],[ρ1,1]]), block2 (tax,
// age) ~ MVN([300, 60], 100·[[1,ρ2],[ρ2,1]]), distance ~ N(4, 1),
// x_true = [5, 0, −.02, −.05, 1.5], b = A·x_true + N(0, noise²)
// (easy_boston_data.py:23-45 semantics; draws differ from NumPy's stream).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kFeatures = 5;
constexpr double kXTrue[kFeatures] = {5.0, 0.0, -0.02, -0.05, 1.5};

// SplitMix64: tiny counter-based PRNG; state = hash(seed, stream, counter).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t key;
  uint64_t ctr = 0;
  bool have_spare = false;
  double spare = 0.0;

  explicit Rng(uint64_t seed, uint64_t stream)
      : key(splitmix64(seed ^ splitmix64(stream))) {}

  inline double uniform() {  // (0, 1]
    uint64_t bits = splitmix64(key + 0xD1B54A32D192ED03ULL * (++ctr));
    return (static_cast<double>(bits >> 11) + 1.0) * 0x1.0p-53;
  }

  inline double normal() {  // Box–Muller
    if (have_spare) {
      have_spare = false;
      return spare;
    }
    double u1 = uniform(), u2 = uniform();
    double r = std::sqrt(-2.0 * std::log(u1));
    double theta = 6.283185307179586476925287 * u2;
    spare = r * std::sin(theta);
    have_spare = true;
    return r * std::cos(theta);
  }
};

void parallel_for(int n, const std::function<void(int, int)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(hw ? hw : 4);
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk;
    int hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// A_out: (batch, m, 5) row-major float32; b_out: (batch, m) float32.
// noise/rho1/rho2: per-instance (batch,) float32 arrays.
void fastopt_generate_scenarios(uint64_t seed, int batch, int m,
                                const float* noise, const float* rho1,
                                const float* rho2, float* A_out,
                                float* b_out) {
  parallel_for(batch, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Rng rng(seed, static_cast<uint64_t>(i));
      const double r1 = rho1[i], r2 = rho2[i], ns = noise[i];
      const double s1 = std::sqrt(0.25), s2 = std::sqrt(100.0);
      const double q1 = std::sqrt(1.0 - r1 * r1), q2 = std::sqrt(1.0 - r2 * r2);
      float* A = A_out + static_cast<int64_t>(i) * m * kFeatures;
      float* b = b_out + static_cast<int64_t>(i) * m;
      for (int row = 0; row < m; ++row) {
        double z0 = rng.normal(), z1 = rng.normal();
        double z2 = rng.normal(), z3 = rng.normal();
        double zd = rng.normal(), zn = rng.normal();
        double a0 = 6.0 + s1 * z0;
        double a1 = 0.2 + s1 * (r1 * z0 + q1 * z1);
        double a2 = 300.0 + s2 * z2;
        double a3 = 60.0 + s2 * (r2 * z2 + q2 * z3);
        double a4 = 4.0 + zd;
        float* Ar = A + row * kFeatures;
        Ar[0] = static_cast<float>(a0);
        Ar[1] = static_cast<float>(a1);
        Ar[2] = static_cast<float>(a2);
        Ar[3] = static_cast<float>(a3);
        Ar[4] = static_cast<float>(a4);
        double dot = a0 * kXTrue[0] + a1 * kXTrue[1] + a2 * kXTrue[2] +
                     a3 * kXTrue[3] + a4 * kXTrue[4];
        b[row] = static_cast<float>(dot + ns * zn);
      }
    }
  });
}

// In-place per-instance column standardization of (batch, m, n) float32.
void fastopt_standardize(float* A, int batch, int m, int n) {
  parallel_for(batch, [&](int lo, int hi) {
    std::vector<double> mean(n), var(n);
    for (int i = lo; i < hi; ++i) {
      float* Ai = A + static_cast<int64_t>(i) * m * n;
      std::fill(mean.begin(), mean.end(), 0.0);
      std::fill(var.begin(), var.end(), 0.0);
      for (int r = 0; r < m; ++r)
        for (int j = 0; j < n; ++j) mean[j] += Ai[r * n + j];
      for (int j = 0; j < n; ++j) mean[j] /= m;
      for (int r = 0; r < m; ++r)
        for (int j = 0; j < n; ++j) {
          double d = Ai[r * n + j] - mean[j];
          var[j] += d * d;
        }
      for (int j = 0; j < n; ++j)
        var[j] = var[j] > 0 ? std::sqrt(var[j] / m) : 1.0;
      for (int r = 0; r < m; ++r)
        for (int j = 0; j < n; ++j)
          Ai[r * n + j] =
              static_cast<float>((Ai[r * n + j] - mean[j]) / var[j]);
    }
  });
}

// Gram precompute: Q (batch, n, n), c (batch, n), btb (batch,), all float32;
// accumulation in double for accuracy (matches f32 XLA within rounding).
void fastopt_gram_batch(const float* A, const float* b, int batch, int m,
                        int n, float* Q, float* c, float* btb) {
  parallel_for(batch, [&](int lo, int hi) {
    std::vector<double> q(static_cast<size_t>(n) * n), cv(n);
    for (int i = lo; i < hi; ++i) {
      const float* Ai = A + static_cast<int64_t>(i) * m * n;
      const float* bi = b + static_cast<int64_t>(i) * m;
      std::fill(q.begin(), q.end(), 0.0);
      std::fill(cv.begin(), cv.end(), 0.0);
      double bb = 0.0;
      for (int r = 0; r < m; ++r) {
        const float* Ar = Ai + r * n;
        const double br = bi[r];
        bb += br * br;
        for (int j = 0; j < n; ++j) {
          const double aj = Ar[j];
          cv[j] += aj * br;
          for (int k = j; k < n; ++k) q[j * n + k] += aj * Ar[k];
        }
      }
      float* Qi = Q + static_cast<int64_t>(i) * n * n;
      float* ci = c + static_cast<int64_t>(i) * n;
      for (int j = 0; j < n; ++j) {
        ci[j] = static_cast<float>(cv[j]);
        for (int k = j; k < n; ++k) {
          float v = static_cast<float>(q[j * n + k]);
          Qi[j * n + k] = v;
          Qi[k * n + j] = v;
        }
      }
      btb[i] = static_cast<float>(bb);
    }
  });
}

int fastopt_version() { return 1; }

}  // extern "C"
