// Symmetric int8 group quantization for Hopper (sm_90a).
//
// Replaces deepspeed_tpu/ops/quant.py::_quant_kernel (the Pallas TPU kernel
// behind quantize_pallas and quantize_blockwise_pallas).  x is viewed as
// [n_groups, group_size] rows (f32 or bf16); each row gets
//   amax  = max |x|
//   scale = amax / 127 (an IEEE f32 division), 1.0 where that is 0
//   q     = clamp(rint(x / scale), -127, 127)   (half to even)
// written as int8 codes [n_groups, group_size] and f32 scales [n_groups].
// A row holding a NaN gets a NaN scale, and every NaN quotient (a NaN, or
// inf / inf in a row whose amax is inf) gets code 0, as the plain version
// (ops/quant_cuda.py::quantize_rows_reference) maps it.
//
// Bound on the H100: ~3 operations per element over 3 (bf16) or 5 (f32)
// bytes, so the bytes bound it (the stacked 8B FFN leaf, 1.88e9 bf16
// elements, moves 5.7 GB: ~1.7 ms at 3.35 TB/s).  One warp per group in a
// grid-stride loop: the warp reads its row once for the max (lanes on
// neighbouring elements), reduces with shuffles, and reads it again from L1
// to write the codes, so x never leaves the card as an f32 copy.  The
// division and rounding are the plain version's operations, in its order
// (no reciprocal, no fast math), so codes and scales are bit-equal to it.
// Offsets and group counts are 64-bit: a stacked leaf has more elements
// than an int holds.  Vector loads and several rows per warp are later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace dstt {

constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     long long n_groups, long long group_size) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_block = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps_per_block;
  for (long long g = (long long)blockIdx.x * warps_per_block + (threadIdx.x >> 5); g < n_groups;
       g += stride) {
    const T* xg = x + g * group_size;
    float amax = 0.f;
    bool has_nan = false;
#pragma unroll 4
    for (long long i = lane; i < group_size; i += 32) {
      const float v = to_f<T>(xg[i]);
      has_nan |= v != v;
      amax = fmaxf(amax, fabsf(v));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    // fmaxf drops NaN; the plain version's max keeps it
    float s = __any_sync(0xffffffffu, has_nan) ? __int_as_float(0x7fc00000)
                                                : __fdiv_rn(amax, 127.0f);
    if (s == 0.f) s = 1.0f;
    int8_t* qg = q + g * group_size;
#pragma unroll 4
    for (long long i = lane; i < group_size; i += 32) {
      const float r = rintf(__fdiv_rn(to_f<T>(xg[i]), s));
      qg[i] = static_cast<int8_t>(r != r ? 0.f : fminf(fmaxf(r, -127.f), 127.f));
    }
    if (lane == 0) scale[g] = s;
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* scale, long long n_groups,
                            long long group_size, cudaStream_t stream) {
  constexpr long long kWarps = kQuantThreads / 32;
  const long long want = (n_groups + kWarps - 1) / kWarps;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  quantize_int8_kernel<T><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), n_groups,
      group_size);
  return cudaGetLastError();
}

}  // namespace dstt

// x [n_groups, group_size] contiguous, dtype 0 = float32, 1 = bfloat16;
// q int8 of the same shape; scale f32 [n_groups].  Returns the launch's
// cudaError_t.
extern "C" int dstt_quantize_int8(const void* x, void* q, void* scale, long long n_groups,
                                  long long group_size, int dtype, void* stream) {
  if (n_groups <= 0 || group_size <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dstt::launch_quantize<float>(x, q, scale, n_groups, group_size, s);
  if (dtype == 1)
    return dstt::launch_quantize<__nv_bfloat16>(x, q, scale, n_groups, group_size, s);
  return cudaErrorInvalidValue;
}
