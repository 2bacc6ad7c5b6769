// Split-key paged attention for Hopper (sm_90a): the port of the v1 arm for
// float32 and head_dim 16 / 32 (a bf16 q with head_dim 64 or 128 takes the
// Hopper body of paged_attention.cu, paged_attention_sm90.cuh).
//
// Replaces deepspeed_tpu/inference/kernels.py::_chunk_kernel (behind
// paged_chunk_attention and paged_decode_attention, the
// kernels.paged_attention = pallas_v1 arm).  The Pallas v1 grid walks the
// page axis in order, one page per grid step, carrying m / l / acc in VMEM
// scratch.  Hopper blocks run in no order, so the key axis is split instead:
//
//   kernel 1 (paged_attention_kernel<..., SPLIT = true>): grid (b*KV, row
//     tile, split); each block sweeps the live keys of its split (up to the
//     row's frontier, table clamped to mp*ps as the dense kernel does) and
//     writes its unnormalised partial (m, l, acc); a split wholly past the
//     frontier writes m = -1e30, l = 0;
//   kernel 2 (paged_combine_kernel): m* = max m_i, l = sum l_i e^(m_i - m*),
//     o = sum acc_i e^(m_i - m*) / l, and l = 0 gives zeros.
//
// Bound on the H100: the same bytes as the dense kernel (every live K/V byte
// once; the partials are small beside them at decode), so bound by bytes.
// The split spreads a decode step's B*KV (b, kv head) pairs over nsplit times
// as many blocks, which is what the dense kernel lacks at small batch.
#include "paged_attention.cuh"

namespace dstt {

// One block per (b*KV, flattened row f) of the output, one thread per d.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc, T* __restrict__ out,
                                     int nsplit, int C, int H, int KV, int D) {
  const int G = H / KV, CG = C * G;
  const int bk = blockIdx.x / CG, f = blockIdx.x % CG, d = threadIdx.x;
  const int b = bk / KV, kvh = bk % KV, c = f / G, h = kvh * G + f % G;
  const long long row0 = (long long)bk * nsplit * CG + f;
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[row0 + (long long)s * CG]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long r = row0 + (long long)s * CG;
    const float w = expf(part_m[r] - mx);
    l += part_l[r] * w;
    a += part_acc[r * D + d] * w;
  }
  out[(((long long)b * C + c) * H + h) * D + d] = from_f<T>(l == 0.f ? 0.f : a / l);
}

}  // namespace dstt

// Kernel 1.  dtype: 0 = float32, 1 = bfloat16.  part_m, part_l [B*KV*nsplit*
// C*G] and part_acc [B*KV*nsplit*C*G, D] float32 scratch; split_keys key
// positions per split, nsplit * split_keys >= mp * ps.
extern "C" int dstt_paged_split(const void* q, const void* kp, const void* vp,
                                const void* table, const void* start, void* part_m,
                                void* part_l, void* part_acc, int B, int C, int H, int KV,
                                int D, int P, int ps, int mp, int split_keys, int nsplit,
                                float scale, int dtype, void* stream) {
  if (!dstt::paged_shape_ok(B, C, H, KV, ps, mp) || split_keys <= 0 || nsplit <= 0 ||
      (long long)split_keys * nsplit < (long long)mp * ps || nsplit > 65535)
    return cudaErrorInvalidValue;
  const dstt::PagedArgs a{q, table, start, nullptr, static_cast<float*>(part_m),
                          static_cast<float*>(part_l), static_cast<float*>(part_acc),
                          B, C, H, KV, P, ps, mp, split_keys, nsplit, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dstt::DenseKV<float> kv{static_cast<const float*>(kp), static_cast<const float*>(vp)};
    return dstt::dispatch_paged<float, dstt::DenseKV<float>, true>(a, D, kv, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const dstt::DenseKV<bf16> kv{static_cast<const bf16*>(kp), static_cast<const bf16*>(vp)};
    return dstt::dispatch_paged<bf16, dstt::DenseKV<bf16>, true>(a, D, kv, s);
  }
  return cudaErrorInvalidValue;
}

// Kernel 2: out [B, C, H, D] in dtype from the partials of kernel 1.
extern "C" int dstt_paged_combine(const void* part_m, const void* part_l, const void* part_acc,
                                  void* out, int B, int C, int H, int KV, int D, int nsplit,
                                  int dtype, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || nsplit <= 0 || D <= 0 || D > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * KV * C * (H / KV);
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const float* pa = static_cast<const float*>(part_acc);
  if (dtype == 0)
    dstt::paged_combine_kernel<float><<<(unsigned)rows, D, 0, s>>>(
        pm, pl, pa, static_cast<float*>(out), nsplit, C, H, KV, D);
  else if (dtype == 1)
    dstt::paged_combine_kernel<__nv_bfloat16><<<(unsigned)rows, D, 0, s>>>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(out), nsplit, C, H, KV, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
