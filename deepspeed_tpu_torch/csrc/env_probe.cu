// The environment report's probe kernel for Hopper (sm_90a).
//
// Replaces the inner kernel ``k`` of deepspeed_tpu/env_report.py::
// _probe_pallas: out = 2 * x over one (8, 128) f32 tile.  Its work is
// nothing; what it shows is that the toolchain built the library, the
// library loaded, and the card ran a launch from it.  Its time is one
// memory round trip and the launch, so it is laid out as the elementwise
// kernels PyTorch launches: ceil(n / 4) threads in blocks of 128, each with
// one 16-byte load and one 16-byte store, all in flight at once.  A base of
// x or out off 16 bytes (a view such as x[1:]) takes four scalar pairs a
// thread for the whole call, the n % 4 tail scalar pairs; 2 * x is exact,
// so the result is bit-equal to the plain version's either way.
#include <cstdint>

#include <cuda_runtime.h>

namespace dstt {

constexpr int kProbeThreads = 128;

__global__ void __launch_bounds__(kProbeThreads)
env_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int vec) {
  const long long i = 4LL * ((long long)blockIdx.x * kProbeThreads + threadIdx.x);
  if (vec && i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<float4*>(out + i) = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z,
                                                      2.0f * v.w);
    return;
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < n) v[j] = x[i + j];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < n) out[i + j] = 2.0f * v[j];
}

}  // namespace dstt

// x, out: n contiguous f32.  Returns the launch's cudaError_t.
extern "C" int dstt_env_probe(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long threads = (n + 3LL) / 4;
  const unsigned blocks = (unsigned)((threads + dstt::kProbeThreads - 1) / dstt::kProbeThreads);
  dstt::env_probe_kernel<<<blocks, dstt::kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, vec);
  return cudaGetLastError();
}
