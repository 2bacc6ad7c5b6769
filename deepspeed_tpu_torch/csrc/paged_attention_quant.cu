// Int8-resident paged attention for Hopper (sm_90a): decode (C = 1) and
// chunked prefill over int8 K/V codes with one f32 scale per token row.
//
// Replaces deepspeed_tpu/inference/kernels.py::_chunk_v2_quant_kernel
// (behind paged_chunk_attention_v2_quant and paged_decode_attention_v2_quant).
// It computes what that kernel computes: K = f32(code) * f32(scale) per
// token row, V likewise; the causal mask kpos <= start + r / G, the online
// softmax in f32, zeros for an empty row (start = -1).  Two bodies, named by
// the caller as for the dense kernel (paged_attention.cu):
//  - the Hopper body (paged_attention_sm90.cuh) for a bfloat16 q with
//    head_dim 64 or 128: decode on the CUDA cores in f32 over spans of
//    staged codes (K and V dequantised as f32(code) * scale); chunks on
//    wgmma over the codes converted to bf16 (exact), the scales moved out of
//    the products (S = (q . code) * ks, P' = P * vs before P'.V);
//  - the scalar block (paged_attention.cuh with the Int8KV loader) for a
//    float32 q and head_dim 16 / 32.
// Only the int8 codes and the scales cross device memory.
//
// Bound on the H100: decode is bound by bytes, (D + 4) bytes per live token
// row and head for K and again for V (codes plus the f32 scale), about 0.52x
// of the dense kernel's 2*D bytes at bf16, D = 128; over 3.35 TB/s.
#include "paged_attention.cuh"
#include "paged_attention_sm90.cuh"

// dtype (of q and out): 0 = float32, 1 = bfloat16.  kq/vq int8 [KV, P, ps,
// D], ks/vs float32 [KV, P, ps, 1].  body, counters, part and span_pages as
// for dstt_paged_attention.  Returns the launch's cudaError_t.
extern "C" int dstt_paged_attention_quant(const void* q, const void* kq, const void* ks,
                                          const void* vq, const void* vs, const void* table,
                                          const void* start, void* out, int B, int C, int H,
                                          int KV, int D, int P, int ps, int mp, float scale,
                                          int dtype, int body, void* counters, void* part,
                                          int span_pages, void* stream) {
  if (!dstt::paged_shape_ok(B, C, H, KV, ps, mp)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || span_pages <= 0 ||
        ((reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) & 3) != 0)
      return cudaErrorInvalidValue;
    const dstt::paged90::Sm90Args a{q, table, start, out, static_cast<int*>(counters),
                                    static_cast<float*>(part), B, C, H, KV, D, P, ps, mp,
                                    span_pages, scale};
    const dstt::paged90::QuantSrc src{static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
                                      static_cast<const int8_t*>(vq), static_cast<const float*>(vs)};
    return dstt::paged90::launch(a, src, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
  const dstt::PagedArgs a{q, table, start, out, nullptr, nullptr, nullptr,
                          B, C, H, KV, P, ps, mp, 0, 1, scale};
  const dstt::Int8KV kv{static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
                        static_cast<const int8_t*>(vq), static_cast<const float*>(vs)};
  if (dtype == 0) return dstt::dispatch_paged<float, dstt::Int8KV, false>(a, D, kv, s);
  if (dtype == 1) return dstt::dispatch_paged<__nv_bfloat16, dstt::Int8KV, false>(a, D, kv, s);
  return cudaErrorInvalidValue;
}
