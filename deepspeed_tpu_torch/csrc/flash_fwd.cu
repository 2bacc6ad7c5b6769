// Flash attention forward for Hopper (sm_90a): two bodies behind one entry.
//
// Replaces deepspeed_tpu/ops/attention_pallas.py::_fwd_kernel (the Pallas
// TPU kernel behind flash_attention_tpu).  q [B, T, H, D] and k, v
// [B, S, KV, D] are read in their model layout (no transposes); query head h
// reads kv head h / (H / KV), so K/V are never repeated in memory.  Writes
// o [B, T, H, D] in q's dtype and lse [B, H, T] f32 (m + log l, read by the
// backward kernels in flash_bwd.cu).  Optional packed segment ids seg [B, T]
// int32 (null = none; they need T == S): a row sees only keys of its own
// segment, and a tile whose every entry is masked adds nothing (p = 0).
//
// Bound on the H100: at the prefill and training shapes (T = 1k to 2k,
// D = 128) the work is ~4 T^2 H D / 2 flops over ~(2 T H + 2 T KV) D bytes,
// far above the 295 flop/byte ridge, so it is bound by operations, and only
// the tensor cores reach the card's 989 TFLOP/s (bf16 and fp16 alike).
//
// The caller picks the body by dtype and head dim (the `body` argument),
// never by retrying:
//  - the tensor-core body (flash_fwd_sm90.cuh) for bfloat16 or float16 with
//    D 64 or 128, the Llama paths (q, k, v 16-byte aligned, as TMA needs: the
//    wrapper copies a view that is not): TMA loads of K/V tiles into a ring
//    of shared-memory stages on mbarriers, a producer warpgroup and two
//    consumer warpgroups running wgmma for both products, the online
//    softmax on the accumulator fragment;
//  - the scalar body below for everything else (float32, bf16 or fp16 D 16
//    or 32: the tiny models and the f32 identity runs): one block of 256 threads
//    per (b*h, 64 query rows) sweeps key tiles of 32 with an f32 online
//    softmax (attention_tile.cuh) on the FMA units from shared memory.
// Both stop a causal sweep at the diagonal, mask ragged tails of T and S in
// the kernel (any T works), give zeros for a row that sees no key, and cast
// p through v's dtype before P.V, as the TPU kernel does.
#include "attention_tile.cuh"
#include "flash_fwd_sm90.cuh"

namespace dstt {

constexpr int kFlashBM = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
                 int T_, int S, int H, int KV, float scale, int causal) {
  constexpr int BM = kFlashBM;
  extern __shared__ __align__(16) char smem[];
  Tile<BM, D> t(smem);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BM;

  for (int idx = threadIdx.x; idx < BM * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int tq = q0 + r;
    t.q[r * (D + 1) + d] =
        tq < T_ ? to_f<T>(q[(((long long)b * T_ + tq) * H + h) * D + d]) : 0.f;
  }
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    t.qpos[r] = q0 + r < T_ ? q0 + r : -1;
    if (seg) t.qseg[r] = q0 + r < T_ ? seg[(long long)b * T_ + q0 + r] : -1;
  }
  float acc[BM / 16][D / 16];
  tile_init(t, acc);

  // causal: key j is seen by row i only when j <= i, so the sweep stops at
  // the tile's last row
  const int n_end = causal ? min(S, q0 + BM) : S;
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();  // previous tile fully consumed
    for (int n = threadIdx.x; n < kBN; n += kThreads) {
      const int s = n0 + n;
      t.kpos[n] = s < S ? s : kNoPos;
      t.koff[n] = s < S ? (((long long)b * S + s) * KV + kvh) * D : -1;
      if (seg) t.kseg[n] = s < S ? seg[(long long)b * S + s] : -2;
    }
    __syncthreads();
    tile_load_kv(t, k, v);
    __syncthreads();
    tile_scores(t, scale, causal != 0, seg != nullptr);
    __syncthreads();
    tile_softmax<BM, D, true, T>(t);
    __syncthreads();
    tile_pv(t, acc);
  }
  __syncthreads();
  tile_store(t, acc, o, [&](int r) -> long long {
    const int tq = q0 + r;
    return tq < T_ ? (((long long)b * T_ + tq) * H + h) * D : -1;
  });
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int tq = q0 + r;
    if (tq < T_) {
      const float l = t.l[r];
      lse[((long long)b * H + h) * T_ + tq] = t.m[r] + logf(l == 0.f ? 1.f : l);
    }
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const int* seg, void* o,
                         void* lse, int B, int T_, int S, int H, int KV, float scale,
                         int causal, cudaStream_t stream) {
  const size_t smem = TileSmem<kFlashBM, D>::bytes;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T_ + kFlashBM - 1) / kFlashBM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
      static_cast<T*>(o), static_cast<float*>(lse), T_, S, H, KV, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v, const int* seg, void* o,
                           void* lse, int B, int T_, int S, int H, int KV, int D, float scale,
                           int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, seg, o, lse, B, T_, S, H, KV, scale, causal, s);
    case 32: return launch_flash<T, 32>(q, k, v, seg, o, lse, B, T_, S, H, KV, scale, causal, s);
    case 64: return launch_flash<T, 64>(q, k, v, seg, o, lse, B, T_, S, H, KV, scale, causal, s);
    case 128:
      return launch_flash<T, 128>(q, k, v, seg, o, lse, B, T_, S, H, KV, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dstt

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; seg: [B, T] int32 or null
// (needs T == S); body: 0 = the scalar body, 1 = the tensor-core body
// (bfloat16 or float16, D 64 or 128, q/k/v 16-byte aligned).  Returns the
// launch's cudaError_t.
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                              void* o, void* lse, int B, int T, int S, int H, int KV, int D,
                              float scale, int causal, int dtype, int body, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || (seg && T != S))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  if (body == 1) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    if ((dtype != 1 && dtype != 2) || (addr & 15) != 0) return cudaErrorInvalidValue;
    if (dtype == 2) {
      if (D == 64)
        return dstt::sm90::launch<64, __half>(q, k, v, sg, o, lse, B, T, S, H, KV, scale, causal,
                                              s);
      if (D == 128)
        return dstt::sm90::launch<128, __half>(q, k, v, sg, o, lse, B, T, S, H, KV, scale,
                                               causal, s);
      return cudaErrorInvalidValue;
    }
    if (D == 64)
      return dstt::sm90::launch<64, __nv_bfloat16>(q, k, v, sg, o, lse, B, T, S, H, KV, scale,
                                                   causal, s);
    if (D == 128)
      return dstt::sm90::launch<128, __nv_bfloat16>(q, k, v, sg, o, lse, B, T, S, H, KV, scale,
                                                    causal, s);
    return cudaErrorInvalidValue;
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dstt::dispatch_flash<float>(q, k, v, sg, o, lse, B, T, S, H, KV, D, scale, causal, s);
  if (dtype == 1)
    return dstt::dispatch_flash<__nv_bfloat16>(q, k, v, sg, o, lse, B, T, S, H, KV, D, scale,
                                               causal, s);
  if (dtype == 2)
    return dstt::dispatch_flash<__half>(q, k, v, sg, o, lse, B, T, S, H, KV, D, scale, causal, s);
  return cudaErrorInvalidValue;
}
