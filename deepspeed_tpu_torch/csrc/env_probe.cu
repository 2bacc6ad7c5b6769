// The environment report's probe kernel for Hopper (sm_90a).
//
// Replaces the inner kernel ``k`` of deepspeed_tpu/env_report.py::
// _probe_pallas: out = 2 * x over one (8, 128) f32 tile.  Its work is
// nothing; what it shows is that the toolchain built the library, the
// library loaded, and the card ran a launch from it.  One block walks the
// tile.
#include <cuda_runtime.h>

namespace dstt {

__global__ void __launch_bounds__(256)
env_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = 2.0f * x[i];
}

}  // namespace dstt

// x, out: n contiguous f32.  Returns the launch's cudaError_t.
extern "C" int dstt_env_probe(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  dstt::env_probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}
