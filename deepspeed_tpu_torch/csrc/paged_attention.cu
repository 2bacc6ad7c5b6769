// Paged attention for Hopper (sm_90a): decode (C = 1) and chunked prefill
// over dense pages.
//
// Replaces deepspeed_tpu/inference/kernels.py::_chunk_v2_kernel (behind
// paged_chunk_attention_v2 and paged_decode_attention_v2), and for a bf16 q
// with head_dim 64 or 128 the v1 _chunk_kernel too (the pallas_v1 arm, B8,
// which computes the same function; only its page walk differs).  Two bodies
// behind one entry; the caller names the body by dtype and head dim (the
// `body` argument), never by retrying:
//  - the Hopper body (paged_attention_sm90.cuh) for a bfloat16 q, or a
//    float16 q over bf16 pages (an fp16 model's paged generator), with
//    head_dim 64 or 128, every Llama-3-8B path: decode split over spans of
//    pages with the partials merged by the last block in the same launch,
//    chunked prefill on wgmma over pages staged by cp.async;
//  - the scalar block (paged_attention.cuh, shared with B7 and B8) for
//    float32 and head_dim 16 / 32: one block per (b*KV, row tile) sweeping
//    every live key on the FMA units.
//
// Bound on the H100: decode reads every live K/V byte once for 4 flops per
// element pair, far below the 295 flop/byte ridge, so it is bound by bytes
// (live KV bytes / 3.35 TB/s); chunked prefill at C = 256 is bound by the
// tensor cores' operations.
#include "paged_attention.cuh"
#include "paged_attention_sm90.cuh"

// dtype (of q and out): 0 = float32 over float32 pages, 1 = bfloat16 over
// bfloat16 pages, 2 = float16 over bfloat16 pages (the JAX kernel reads q
// and the pages as f32 and writes the output in q's dtype; an fp16 q meets
// the bf16 cache of an fp16 model); body: 0 = the scalar block, 1 = the
// Hopper body (dtype 1 or 2, D 64 or 128), which at decode with more than one
// span of span_pages pages needs counters [B * KV] int32 (zeros, left zeros)
// and part (f32 partials, paged_attention_sm90.cuh).  Returns the launch's
// cudaError_t.
extern "C" int dstt_paged_attention(const void* q, const void* kp, const void* vp,
                                    const void* table, const void* start, void* out, int B,
                                    int C, int H, int KV, int D, int P, int ps, int mp,
                                    float scale, int dtype, int body, void* counters, void* part,
                                    int span_pages, void* stream) {
  if (!dstt::paged_shape_ok(B, C, H, KV, ps, mp)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (body == 1) {
    if ((dtype != 1 && dtype != 2) || span_pages <= 0) return cudaErrorInvalidValue;
    const dstt::paged90::Sm90Args a{q, table, start, out, static_cast<int*>(counters),
                                    static_cast<float*>(part), B, C, H, KV, D, P, ps, mp,
                                    span_pages, scale};
    const dstt::paged90::DenseSrc src{static_cast<const bf16*>(kp), static_cast<const bf16*>(vp)};
    if (dtype == 2) return dstt::paged90::launch<dstt::paged90::DenseSrc, __half>(a, src, s);
    return dstt::paged90::launch(a, src, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
  const dstt::PagedArgs a{q, table, start, out, nullptr, nullptr, nullptr,
                          B, C, H, KV, P, ps, mp, 0, 1, scale};
  if (dtype == 0) {
    const dstt::DenseKV<float> kv{static_cast<const float*>(kp), static_cast<const float*>(vp)};
    return dstt::dispatch_paged<float, dstt::DenseKV<float>, false>(a, D, kv, s);
  }
  if (dtype == 1) {
    const dstt::DenseKV<bf16> kv{static_cast<const bf16*>(kp), static_cast<const bf16*>(vp)};
    return dstt::dispatch_paged<bf16, dstt::DenseKV<bf16>, false>(a, D, kv, s);
  }
  if (dtype == 2) {
    const dstt::DenseKV<bf16> kv{static_cast<const bf16*>(kp), static_cast<const bf16*>(vp)};
    return dstt::dispatch_paged<__half, dstt::DenseKV<bf16>, false>(a, D, kv, s);
  }
  return cudaErrorInvalidValue;
}
