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
// (ops/quant_cuda.py::quantize_rows_reference) maps it.  Codes and scales
// are bit-equal to it: the scale is its IEEE division (no fast math), and
// a code is its rint(x / scale) with the IEEE division, or, in the vector
// body, a multiply by the group's correctly rounded reciprocal where that
// provably rounds to the same integer (encode8 states the proof).
//
// Bound on the H100: ~3 operations per element over 3 (bf16) or 5 (f32)
// bytes, so the bytes bound it (the stacked 8B FFN leaf, 1.88e9 bf16
// elements, moves 5.7 GB: ~1.7 ms at 3.35 TB/s).  The IEEE division, its
// rint and its float-to-int conversion run ~20 instructions an element,
// two of them on the SMs' narrow conversion and special-function pipes,
// which can bind the kernel by instruction throughput instead; the
// reciprocal's code takes ~6 on the full-width pipes, so the kernel stays
// bound by bytes while its loads stay in flight.  Two bodies behind one
// entry, named by the caller from the shape (ops/quant_cuda.py::
// quant_body):
//  - the vector body, for groups whose size is a multiple of 8 with x on a
//    16-byte boundary: a thread owns 8 consecutive elements (one 16-byte
//    load, two for f32), so 16 threads cover a 128-group and a warp takes
//    two groups at once; the values stay in registers between the max and
//    the codes (x is read once), the max meets over the group's lanes with
//    __shfl_xor_sync on the bits of |x| (for non-negative floats their
//    order as integers, with every NaN above inf, so a NaN wins as the
//    plain max keeps it), each thread writes its 8 codes as one 8-byte
//    store and one lane per group the scale.  A persistent grid-stride loop
//    starts the loads of kInFlight groups per thread before any arithmetic.
//    Groups past 256 elements (the wire codec's 4096) take one warp each
//    and two sweeps of 16-byte chunks, the second from L1/L2;
//  - the scalar body (one warp per group, one element per lane) for any
//    other group size or a misaligned x.
// The same per-row device functions serve the fused K/V write
// (dstt_quantize_write_kv): each new K and V row of a layer is quantised
// and written straight into its int8-resident page slot, one launch per
// layer in place of two quantize launches and the plain scatter of codes
// and scales.  Offsets and group counts are 64-bit: a stacked leaf has more
// elements than an int holds.
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

// ------------------------------------------------------------ vector body
namespace q8 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kInFlight = 4;       // groups (or chunks) per thread loaded ahead
constexpr int kWarps = kQuantThreads / 32;

// 16-byte words in a chunk of 8 elements
template <typename T>
struct Words {
  static constexpr int n = (int)sizeof(T) / 2;
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, uint4 (&w)[Words<T>::n]) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < Words<T>::n; ++i) w[i] = __ldg(s + i);
}

template <typename T>
__device__ __forceinline__ void zero8(uint4 (&w)[Words<T>::n]) {
#pragma unroll
  for (int i = 0; i < Words<T>::n; ++i) w[i] = make_uint4(0u, 0u, 0u, 0u);
}

// bf16 -> f32 is a shift of the bits (exact); element 2i sits in the low half
__device__ __forceinline__ void unpack8(const uint4 (&w)[1], float (&v)[8]) {
  const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack8(const uint4 (&w)[2], float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[4 * i] = __uint_as_float(w[i].x);
    v[4 * i + 1] = __uint_as_float(w[i].y);
    v[4 * i + 2] = __uint_as_float(w[i].z);
    v[4 * i + 3] = __uint_as_float(w[i].w);
  }
}

// the bits of max |v|: for non-negative floats the integer order is the
// float order, and every NaN lies above inf
__device__ __forceinline__ uint32_t amax_bits(const float (&v)[8]) {
  uint32_t m = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = max(m, __float_as_uint(v[i]) & 0x7fffffffu);
  return m;
}

// A group's divisor: the scale s, and r = RN(1 / s) for the fast path of
// encode8, taken where s is a normal number of at least 2^-100 (every s of a
// group with a finite amax past 127 * 2^-100, a zero group's 1.0 included)
struct Divisor {
  float s, r;
  bool fast;
};

// meets the bits over the TPG lanes of a group (aligned within the warp;
// every lane of the warp must call it) and turns them into the divisor
template <int TPG>
__device__ __forceinline__ Divisor divisor_of(uint32_t m) {
#pragma unroll
  for (int off = TPG / 2; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFull, m, off));
  float s = m > 0x7f800000u ? __int_as_float(0x7fc00000) : __fdiv_rn(__uint_as_float(m), 127.0f);
  if (s == 0.f) s = 1.0f;
  return {s, __frcp_rn(s), s >= 0x1p-100f && s <= 3.40282347e38f};
}

// the plain version's code: rint(x / s) with the IEEE division, clamped,
// NaN to 0
__device__ __forceinline__ uint32_t code(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  const float c = r != r ? 0.f : fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(c)) & 0xffu;
}

// The codes of 8 elements of a group, as one 8-byte word.
//
// Fast path, bit-equal to code(): q = RN(x * r), r = RN(1 / s).  Then
// q = (x / s)(1 + e1)(1 + e2) with |e1|, |e2| <= 2^-24, and |x / s| <=
// amax / s = 127 / (1 + e3) < 127.00001 (s = RN(amax / 127) normal), so
// |q - x / s| < 127.00001 * (2^-23 + 2^-48) < 2^-16, and with |RN(x / s) -
// x / s| <= 2^-18 (half an ulp below 128), |q - RN(x / s)| < 2^-15.  Where q
// lies further than that from every half-integer, q and RN(x / s) lie
// between the same two half-integers and round to the same integer, within
// +-127 (no clamp), and x and s are finite (no NaN).  A chunk holding a q
// within 2^-14 of a half-integer (about one in 2^11) takes the exact path.
// rint(q) is t - 1.5 * 2^23 for t = RN(q + 1.5 * 2^23) (the grid of
// [2^23, 2^24) is the integers, ties to even), and t's low byte is the code
// in two's complement.  The intrinsics keep each operation rounded on its
// own (no contraction into an FMA).
__device__ __forceinline__ uint2 encode8(const float (&v)[8], const Divisor& d) {
  if (d.fast) {
    constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
    uint32_t b[8];
    bool near_half = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float q = __fmul_rn(v[i], d.r);
      const float t = __fadd_rn(q, kMagic);
      near_half |= fabsf(__fsub_rn(q, __fsub_rn(t, kMagic))) >= 0.5f - 0x1p-14f;
      b[i] = __float_as_uint(t);
    }
    if (!near_half)
      return make_uint2(
          __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410),
          __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7], 0x0040), 0x5410));
  }
  const float s = d.s;
  uint2 o;
  o.x = code(v[0], s) | code(v[1], s) << 8 | code(v[2], s) << 16 | code(v[3], s) << 24;
  o.y = code(v[4], s) | code(v[5], s) << 8 | code(v[6], s) << 16 | code(v[7], s) << 24;
  return o;
}

// Groups of at most 8 * TPG elements, TPG lanes a group (32 / TPG groups a
// warp at a time), one 8-element chunk a lane; lanes past the group's
// chunks carry zeros and store nothing.
template <typename T, int TPG>
__global__ void __launch_bounds__(kQuantThreads)
quantize_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                    long long n_groups, int group_size) {
  constexpr int kGpw = 32 / TPG;
  const int lane = threadIdx.x & 31, j = lane % TPG;
  const bool col = j < (group_size >> 3);
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * kWarps * kGpw;
  // base is the same on every lane of a warp, so the shuffles see them all
  for (long long base = warp * kGpw + lane / TPG; base - lane / TPG < n_groups;
       base += step * kInFlight) {
    uint4 w[kInFlight][Words<T>::n];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long g = base + u * step;
      if (col && g < n_groups)
        load8<T>(x + g * group_size + j * 8, w[u]);
      else
        zero8<T>(w[u]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long g = base + u * step;
      if (g - lane / TPG >= n_groups) break;  // the same on the whole warp
      float v[8];
      unpack8(w[u], v);
      const Divisor dv = divisor_of<TPG>(amax_bits(v));
      if (g < n_groups) {
        if (col) *reinterpret_cast<uint2*>(q + g * group_size + j * 8) = encode8(v, dv);
        if (j == 0) scale[g] = dv.s;
      }
    }
  }
}

// Groups past 256 elements: one warp a group, a sweep for the max and a
// second for the codes (the group's chunks are in L1/L2 by then)
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_vec_wide_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, long long n_groups, int group_size) {
  const int lane = threadIdx.x & 31, nchunk = group_size >> 3;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); g < n_groups;
       g += step) {
    const T* xg = x + g * group_size;
    uint32_t m = 0u;
    for (int c0 = lane; c0 < nchunk; c0 += 32 * kInFlight) {
      uint4 w[kInFlight][Words<T>::n];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (c0 + 32 * u < nchunk)
          load8<T>(xg + (c0 + 32 * u) * 8, w[u]);
        else
          zero8<T>(w[u]);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        float v[8];
        unpack8(w[u], v);
        m = max(m, amax_bits(v));
      }
    }
    const Divisor dv = divisor_of<32>(m);
    int8_t* qg = q + g * group_size;
    for (int c0 = lane; c0 < nchunk; c0 += 32 * kInFlight) {
      uint4 w[kInFlight][Words<T>::n];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (c0 + 32 * u < nchunk) load8<T>(xg + (c0 + 32 * u) * 8, w[u]);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (c0 + 32 * u < nchunk) {
          float v[8];
          unpack8(w[u], v);
          *reinterpret_cast<uint2*>(qg + (c0 + 32 * u) * 8) = encode8(v, dv);
        }
      }
    }
    if (lane == 0) scale[g] = dv.s;
  }
}

// The blocks of `kernel` the card holds at once: the persistent grid is one
// wave of them, so no block runs in a second, partial wave.  Asked once per
// kernel (the card's SM count and the kernel's occupancy do not change).
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kQuantThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// One item set a warp where the work is small (latency: a single step), a
// persistent wave of resident blocks where it is large
inline int grid_for(long long items, long long per_block, int resident) {
  const long long want = (items + per_block - 1) / per_block;
  return (int)(want < resident ? want : resident);
}

template <typename T, int TPG>
cudaError_t launch_vec(const void* x, void* q, void* scale, long long n_groups, int gsz,
                       cudaStream_t stream) {
  static const int resident = resident_blocks(quantize_vec_kernel<T, TPG>);
  const int blocks = grid_for(n_groups, (long long)kWarps * (32 / TPG), resident);
  quantize_vec_kernel<T, TPG><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), n_groups,
      gsz);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(const void* x, void* q, void* scale, long long n_groups, int gsz,
                         cudaStream_t stream) {
  const int nchunk = gsz >> 3;
  if (nchunk <= 1) return launch_vec<T, 1>(x, q, scale, n_groups, gsz, stream);
  if (nchunk <= 2) return launch_vec<T, 2>(x, q, scale, n_groups, gsz, stream);
  if (nchunk <= 4) return launch_vec<T, 4>(x, q, scale, n_groups, gsz, stream);
  if (nchunk <= 8) return launch_vec<T, 8>(x, q, scale, n_groups, gsz, stream);
  if (nchunk <= 16) return launch_vec<T, 16>(x, q, scale, n_groups, gsz, stream);
  if (nchunk <= 32) return launch_vec<T, 32>(x, q, scale, n_groups, gsz, stream);
  static const int resident = resident_blocks(quantize_vec_wide_kernel<T>);
  quantize_vec_wide_kernel<T><<<grid_for(n_groups, kWarps, resident), kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), n_groups,
      gsz);
  return cudaGetLastError();
}

// ----------------------------------------------------- fused K/V write
// One row a (plane, b, c, kv head): plane 0 is K, 1 is V; D = 8 * TPG.  Row
// c of b lands at position pos = start[b] + c (start null: 0, the prompt
// mode), in page table[b, pos / ps], slot pos % ps, of the plane's codes
// [KV, P, ps, D] and scales [KV, P, ps, 1]; a position at or past mp * ps is
// dropped.  Rows c >= T (the prompt's padded tail of its last page) quantise
// zeros: codes 0, scale 1.0.
struct WriteArgs {
  const int* table;
  const int* start;
  int8_t *codes_k, *codes_v;
  float *scales_k, *scales_v;
  int B, T, C, KV, P, ps, mp;
};

template <typename T, int TPG>
__global__ void __launch_bounds__(kQuantThreads)
quantize_write_kv_kernel(const T* __restrict__ nk, const T* __restrict__ nv, WriteArgs a) {
  constexpr int kRpw = 32 / TPG, D = 8 * TPG;
  const int lane = threadIdx.x & 31, j = lane % TPG;
  const int per_plane = a.B * a.C * a.KV, rows = 2 * per_plane;
  const int cap = a.mp * a.ps;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int step = gridDim.x * kWarps * kRpw;
  for (int base = warp * kRpw + lane / TPG; base - lane / TPG < rows; base += step * kInFlight) {
    // the rows' values and starts are loaded together, then the table
    // entries (which need the starts): two dependent round trips a step
    uint4 w[kInFlight][Words<T>::n];
    int h[kInFlight], b[kInFlight], pos[kInFlight];
    long long dst[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = base + u * step;
      zero8<T>(w[u]);
      h[u] = b[u] = 0;
      pos[u] = -1;
      if (r >= rows) continue;
      const int plane = r >= per_plane, rr = r - plane * per_plane;
      const int bc = rr / a.KV, c = bc % a.C;
      h[u] = rr % a.KV;
      b[u] = bc / a.C;
      if (c < a.T)
        load8<T>((plane ? nv : nk) + (((long long)b[u] * a.T + c) * a.KV + h[u]) * D + j * 8,
                 w[u]);
      pos[u] = (a.start ? a.start[b[u]] : 0) + c;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      dst[u] = -1;
      if (pos[u] >= 0 && pos[u] < cap)
        dst[u] = ((long long)h[u] * a.P + a.table[b[u] * a.mp + pos[u] / a.ps]) * a.ps +
                 pos[u] % a.ps;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (base - lane / TPG + u * step >= rows) break;  // the same on the warp
      float v[8];
      unpack8(w[u], v);
      const Divisor dv = divisor_of<TPG>(amax_bits(v));
      if (dst[u] >= 0) {
        const bool is_v = base + u * step >= per_plane;
        *reinterpret_cast<uint2*>((is_v ? a.codes_v : a.codes_k) + dst[u] * D + j * 8) =
            encode8(v, dv);
        if (j == 0) (is_v ? a.scales_v : a.scales_k)[dst[u]] = dv.s;
      }
    }
  }
}

template <typename T, int TPG>
cudaError_t launch_write(const void* nk, const void* nv, const WriteArgs& a,
                         cudaStream_t stream) {
  static const int resident = resident_blocks(quantize_write_kv_kernel<T, TPG>);
  const long long rows = 2LL * a.B * a.C * a.KV;
  const int blocks = grid_for(rows, (long long)kWarps * (32 / TPG), resident);
  quantize_write_kv_kernel<T, TPG><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(nk), static_cast<const T*>(nv), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_write(const void* nk, const void* nv, const WriteArgs& a, int D,
                           cudaStream_t stream) {
  switch (D) {
    case 16: return launch_write<T, 2>(nk, nv, a, stream);
    case 32: return launch_write<T, 4>(nk, nv, a, stream);
    case 64: return launch_write<T, 8>(nk, nv, a, stream);
    case 128: return launch_write<T, 16>(nk, nv, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace q8
}  // namespace dstt

// x [n_groups, group_size] contiguous, dtype 0 = float32, 1 = bfloat16;
// q int8 of the same shape; scale f32 [n_groups].  body 1 = the vector
// body (group_size % 8 == 0, x 16-byte and q 8-byte aligned), 0 = the
// scalar body.  Returns the launch's cudaError_t.
extern "C" int dstt_quantize_int8(const void* x, void* q, void* scale, long long n_groups,
                                  long long group_size, int dtype, int body, void* stream) {
  if (n_groups <= 0 || group_size <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (body == 1) {
    if (group_size % 8 || group_size > 0x7fffffffLL || !dstt::q8::aligned(x, 16) ||
        !dstt::q8::aligned(q, 8))
      return cudaErrorInvalidValue;
    if (dtype == 0)
      return dstt::q8::dispatch_vec<float>(x, q, scale, n_groups, (int)group_size, s);
    if (dtype == 1)
      return dstt::q8::dispatch_vec<bf16>(x, q, scale, n_groups, (int)group_size, s);
    return cudaErrorInvalidValue;
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dstt::launch_quantize<float>(x, q, scale, n_groups, group_size, s);
  if (dtype == 1) return dstt::launch_quantize<bf16>(x, q, scale, n_groups, group_size, s);
  return cudaErrorInvalidValue;
}

// The fused K/V write of one layer: new_k, new_v [B, T, KV, D] contiguous
// (dtype 0 = float32, 1 = bfloat16; 16-byte aligned), table [B, mp] and
// start [B] int32 (start null: the prompt mode, from position 0, C rows a
// sequence of which rows T.. pad), codes kq / vq int8 [KV, P, ps, D] and
// scales ks / vs f32 [KV, P, ps, 1], written in place.  C rows of each
// sequence are written (C = T outside the prompt mode); D is 16, 32, 64 or
// 128 (the paged kernels' head dims).  Returns the launch's cudaError_t.
extern "C" int dstt_quantize_write_kv(const void* new_k, const void* new_v, const void* table,
                                      const void* start, void* kq, void* ks, void* vq, void* vs,
                                      int B, int T, int C, int KV, int D, int P, int ps, int mp,
                                      int dtype, void* stream) {
  using dstt::q8::aligned;
  if (B <= 0 || T <= 0 || C < T || KV <= 0 || P <= 0 || ps <= 0 || mp <= 0 ||
      2LL * B * C * KV > (1LL << 30) || (long long)mp * ps > 0x7fffffffLL ||
      (start == nullptr && C > mp * ps) || (start != nullptr && C != T) ||
      !aligned(new_k, 16) || !aligned(new_v, 16) || !aligned(kq, 8) || !aligned(vq, 8))
    return cudaErrorInvalidValue;
  const dstt::q8::WriteArgs a{static_cast<const int*>(table),
                              static_cast<const int*>(start),
                              static_cast<int8_t*>(kq),
                              static_cast<int8_t*>(vq),
                              static_cast<float*>(ks),
                              static_cast<float*>(vs),
                              B, T, C, KV, P, ps, mp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dstt::q8::dispatch_write<float>(new_k, new_v, a, D, s);
  if (dtype == 1) return dstt::q8::dispatch_write<__nv_bfloat16>(new_k, new_v, a, D, s);
  return cudaErrorInvalidValue;
}
