// float <-> storage type conversions shared by the port's kernels
// (float32, bfloat16 and float16 storage, float32 arithmetic), and the
// element types of the tensor-core bodies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dstt {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to nearest even; a value past 65504 becomes inf, as astype does
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// the 16-bit element types of the tensor-core bodies: bfloat16 and float16
template <typename E>
constexpr bool kIsHalf = std::is_same<E, __half>::value;

// two f32 values rounded to E (round to nearest even), packed as one
// 32-bit register (lo in the low half): cvt.rn.bf16x2.f32 / cvt.rn.f16x2.f32
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<E>) {
    __half2 p = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
  } else {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
  }
}

// a packed pair of E as two f32 values (exact)
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (kIsHalf<E>)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

}  // namespace dstt
