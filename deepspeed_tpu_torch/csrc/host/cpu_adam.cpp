// Fused multi-threaded CPU Adam for the port's host-update path (the JAX
// package's csrc/cpu_adam.cpp, plus a grad scale and the layer-streaming
// engine's bf16 grad landing; ref behavior:
// deepspeed/ops/adam/cpu_adam.cpp (DeepSpeedCPUAdam) — the reference's
// offload optimizer updates on the HOST with a SIMD/OMP C++ kernel, because
// the expression-chain formulation makes ~10 full passes over 16
// bytes/param of state while this fused loop makes one).
//
// Single pass per element: reads p,m,v,g (16 B), writes p,m,v (12 B) and
// optionally the bf16 compute image (2 B) — the bf16 emit here saves the
// separate cast pass AND its extra f32 read in the Python caller; a grad
// scale (the engines' 1/accumulation and clip factor) multiplies g in the
// same pass, as the callers' separate g *= scale would, rounding the same.
// Threaded over contiguous ranges with std::thread (no libgomp dep);
// memory-bandwidth-bound, so threads ~ #channels saturate.
//
// Math-parity contract with deepspeed_tpu_torch/ops/optim.py adam(): the
// caller passes inv_c1 = 1/(1-b1^t), inv_c2 = 1/(1-b2^t) (or 1.0 when
// bias correction is off) so step-count semantics live in one place.
// The multiply-by-reciprocal adds one rounding vs the device path's
// division — results agree to ~1 ulp, not bitwise; tests use tolerances.
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC -o libdstt_cpuadam.so
//        cpu_adam.cpp -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint16_t f32_to_bf16(float x) {
  uint32_t bits;
  std::memcpy(&bits, &x, 4);
  if ((bits & 0x7fffffffu) > 0x7f800000u) {        // NaN: keep quiet, no
    return (uint16_t)((bits >> 16) | 0x0040u);     // rounding ripple
  }
  uint32_t lsb = (bits >> 16) & 1u;                // round to nearest even
  bits += 0x7fffu + lsb;
  return (uint16_t)(bits >> 16);
}

struct AdamArgs {
  float *p, *m, *v;
  const float *g;
  int64_t n;
  float lr, b1, b2, eps, wd;
  int adamw;
  float inv_c1, inv_c2;
  uint16_t *out_bf16;  // optional: fresh compute image (nullptr = skip)
  float gscale;        // the grad is g * gscale (1: g itself, exactly)
};

void adam_range(const AdamArgs &a, int64_t lo, int64_t hi) {
  const float one_m_b1 = 1.0f - a.b1, one_m_b2 = 1.0f - a.b2;
  for (int64_t i = lo; i < hi; ++i) {
    float gi = a.g[i] * a.gscale;
    float pi = a.p[i];
    if (a.wd != 0.0f && !a.adamw) gi += a.wd * pi;   // L2 into the grad
    float mi = a.b1 * a.m[i] + one_m_b1 * gi;
    float vi = a.b2 * a.v[i] + one_m_b2 * gi * gi;
    a.m[i] = mi;
    a.v[i] = vi;
    float u = (mi * a.inv_c1) / (std::sqrt(vi * a.inv_c2) + a.eps);
    if (a.wd != 0.0f && a.adamw) u += a.wd * pi;     // decoupled decay
    pi -= a.lr * u;
    a.p[i] = pi;
    if (a.out_bf16) a.out_bf16[i] = f32_to_bf16(pi);
  }
}

}  // namespace

extern "C" {

void dstt_cpu_adam(float *p, float *m, float *v, const float *g, int64_t n,
                    float lr, float b1, float b2, float eps, float wd,
                    int adamw, float inv_c1, float inv_c2,
                    uint16_t *out_bf16, int n_threads, float gscale) {
  AdamArgs a{p, m, v, g, n, lr, b1, b2, eps, wd, adamw,
             inv_c1, inv_c2, out_bf16, gscale};
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 4096) {   // small leaf: threads cost more
    adam_range(a, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([a, lo, hi] { adam_range(a, lo, hi); });
  }
  for (auto &t : ts) t.join();
}

// Standalone f32 -> bf16 emit (one pass), for paths that only need the
// compute-image conversion without an optimizer update.
void dstt_f32_to_bf16(const float *src, uint16_t *dst, int64_t n,
                       int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = f32_to_bf16(src[i]);
  };
  if (n < (int64_t)n_threads * 8192) {
    run(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(run, lo, hi);
  }
  for (auto &t : ts) t.join();
}

// Gradient landing for the layer-streaming engine, one pass: acc = (first ?
// 0 : acc) + f32(g), with g bf16 bit patterns (the widening is exact), and
// the sum of squares of the new acc in double, per thread in order, so the
// result does not depend on timing.  Returns that sum.
double dstt_accum_bf16(float *acc, const uint16_t *g, int64_t n, int first,
                       int n_threads) {
  auto run = [&](int64_t lo, int64_t hi) {
    double ssq = 0.0;
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t bits = (uint32_t)g[i] << 16;
      float gi;
      std::memcpy(&gi, &bits, 4);
      float x = first ? gi : acc[i] + gi;
      acc[i] = x;
      ssq += (double)x * (double)x;
    }
    return ssq;
  };
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 8192) return run(0, n);
  std::vector<std::thread> ts;
  std::vector<double> part(n_threads, 0.0);
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&, t, lo, hi] { part[t] = run(lo, hi); });
  }
  for (auto &t : ts) t.join();
  double ssq = 0.0;
  for (double x : part) ssq += x;
  return ssq;
}

}  // extern "C"
