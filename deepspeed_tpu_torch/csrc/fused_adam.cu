// Fused Adam/AdamW update for Hopper (sm_90a).
//
// Replaces deepspeed_tpu/ops/adam_pallas.py::_adam_kernel (the Pallas TPU
// kernel behind adam_update_flat / fused_adam).  One pass over one flat
// leaf: reads g (f32 or bf16), m, v (f32) and p (f32 or bf16), writes the
// update u = -lr * (m c1 / (sqrt(v c2) + eps) + wd p) and the new m, v (f32),
// where c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) come in as f32 scalars computed on
// the host.
//
// Bound on the H100: ~11 flops per element over 24-28 bytes, far below the
// 295 flop/byte ridge, so the bytes bound it (a 525 M-element leaf moves
// ~14 GB, ~4 ms at 3.35 TB/s).  A grid-stride loop keeps every load
// coalesced; each operation is rounded on its own (no FMA contraction), in
// the order of the plain version, so the two round alike.  A multi-tensor
// launch over all leaves is later work.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace dstt {

template <typename G, typename P>
__global__ void __launch_bounds__(256)
fused_adam_kernel(const G* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ v, const P* __restrict__ p, float* __restrict__ u,
                  float* __restrict__ mo, float* __restrict__ vo, long long n, float b1,
                  float omb1, float b2, float omb2, float eps, float wd, float c1, float c2,
                  float lr) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float gi = to_f<G>(g[i]);
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(omb2, gi), gi));
    mo[i] = mi;
    vo[i] = vi;
    float upd = __fdiv_rn(__fmul_rn(mi, c1), __fadd_rn(__fsqrt_rn(__fmul_rn(vi, c2)), eps));
    if (wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(wd, to_f<P>(p[i])));
    u[i] = __fmul_rn(-lr, upd);
  }
}

template <typename G, typename P>
cudaError_t launch_adam(const void* g, const void* m, const void* v, const void* p, void* u,
                        void* mo, void* vo, long long n, float b1, float omb1, float b2,
                        float omb2, float eps, float wd, float c1, float c2, float lr,
                        cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  fused_adam_kernel<G, P><<<blocks, kThreads, 0, stream>>>(
      static_cast<const G*>(g), static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const P*>(p), static_cast<float*>(u), static_cast<float*>(mo),
      static_cast<float*>(vo), n, b1, omb1, b2, omb2, eps, wd, c1, c2, lr);
  return cudaGetLastError();
}

}  // namespace dstt

// g_dtype / p_dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t.
extern "C" int dstt_fused_adam(const void* g, const void* m, const void* v, const void* p,
                               void* u, void* mo, void* vo, long long n, float b1, float omb1,
                               float b2, float omb2, float eps, float wd, float c1, float c2,
                               float lr, int g_dtype, int p_dtype, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DSTT_ADAM(G, P)                                                                     \
  return dstt::launch_adam<G, P>(g, m, v, p, u, mo, vo, n, b1, omb1, b2, omb2, eps, wd, c1, \
                                 c2, lr, s)
  if (g_dtype == 0 && p_dtype == 0) DSTT_ADAM(float, float);
  if (g_dtype == 0 && p_dtype == 1) DSTT_ADAM(float, __nv_bfloat16);
  if (g_dtype == 1 && p_dtype == 0) DSTT_ADAM(__nv_bfloat16, float);
  if (g_dtype == 1 && p_dtype == 1) DSTT_ADAM(__nv_bfloat16, __nv_bfloat16);
#undef DSTT_ADAM
  return cudaErrorInvalidValue;
}
