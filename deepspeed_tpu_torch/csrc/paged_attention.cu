// Paged attention for Hopper (sm_90a): decode (C = 1) and chunked prefill
// over dense pages.
//
// Replaces deepspeed_tpu/inference/kernels.py::_chunk_v2_kernel (behind
// paged_chunk_attention_v2 and paged_decode_attention_v2).  The block
// (paged_attention.cuh) is shared with the int8 (B7) and split-key (B8)
// kernels; this file instantiates it over dense pages with one block per
// (b*KV, row tile) sweeping every live key.
//
// Bound on the H100: decode reads every live K/V byte once for 4 flops per
// element pair, far below the 295 flop/byte ridge, so it is bound by bytes
// (live KV bytes / 3.35 TB/s).  This version gathers rows with plain loads,
// one block per (b, kv_head) at decode, so small batches leave SMs idle; the
// split-key grid of paged_attention_split.cu and cp.async/TMA page staging
// are the ways out.
#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int dstt_paged_attention(const void* q, const void* kp, const void* vp,
                                    const void* table, const void* start, void* out, int B,
                                    int C, int H, int KV, int D, int P, int ps, int mp,
                                    float scale, int dtype, void* stream) {
  if (!dstt::paged_shape_ok(B, C, H, KV, ps, mp)) return cudaErrorInvalidValue;
  const dstt::PagedArgs a{q, table, start, out, nullptr, nullptr, nullptr,
                          B, C, H, KV, P, ps, mp, 0, 1, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dstt::DenseKV<float> kv{static_cast<const float*>(kp), static_cast<const float*>(vp)};
    return dstt::dispatch_paged<float, dstt::DenseKV<float>, false>(a, D, kv, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const dstt::DenseKV<bf16> kv{static_cast<const bf16*>(kp), static_cast<const bf16*>(vp)};
    return dstt::dispatch_paged<bf16, dstt::DenseKV<bf16>, false>(a, D, kv, s);
  }
  return cudaErrorInvalidValue;
}
