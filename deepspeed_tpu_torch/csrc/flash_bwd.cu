// Flash attention backward for Hopper (sm_90a): dQ and dK/dV, two bodies
// behind each entry.
//
// Replaces deepspeed_tpu/ops/attention_pallas.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels behind the custom VJP of
// flash_attention_tpu).  Both recompute p = exp(s * scale - lse) from the
// lse [B, H, T] f32 that flash_fwd.cu writes, with s masked to -1e30 where
// the key is past S, the row past T, the key above the diagonal (causal) or
// in another segment (seg [B, T] int32, null = none, needs T == S).
// delta [B, H, T] f32 = rowsum(O * dO), a plain reduction outside the
// Pallas kernels in the JAX package, is formed by the dQ kernel here (both
// bodies, in one order: the four threads of a row each sum f32(o) * f32(do)
// over a D/4-column slice, the sums met as (s0 + s1) + (s2 + s3) over lane
// bits 0 and 1) and written for every row below T; dK/dV reads it, launched
// after dQ on the same stream.  q, O and dO are [B, T, H, D], k and v
// [B, S, KV, D], all in their model layout; query head h reads kv head
// h / (H / KV), so K/V are never repeated in memory.
//
// Bound on the H100: at the training shapes (T ~ 2k, D = 128) the work is
// ~5 products of 2 T^2 H D / 2 flops over O(T H D) bytes, far above the
// 295 flop/byte ridge, so it is bound by operations, and only the tensor
// cores reach the card's 989 TFLOP/s (bf16 and fp16 alike).
//
// The caller picks the body by dtype and head dim (the `body` argument),
// never by retrying:
//  - the tensor-core bodies (flash_bwd_sm90.cuh) for bfloat16 or float16
//    with D 64 or 128, the Llama paths (q, k, v, dO 16-byte aligned, as TMA
//    needs: the wrapper copies a view that is not);
//  - the scalar bodies below for everything else (float32, bf16 or fp16 D 16
//    or 32), every product on the f32 FMA units from shared memory:
//
// flash_bwd_dq: one block of 256 threads per (b*h, tile of 64 query rows)
// forms its rows' delta, then sweeps the key tiles of 32 up to the causal
// frontier, with q, dO, lse and delta resident in shared memory:
//   ds = p * (dO . V^T - delta) * scale;  dQ += ds . K
// ds is rounded to K's dtype before the product, as the TPU kernel does.
//
// flash_bwd_dkv: one block per (b*kv head, tile of 64 keys) keeps its K/V
// rows resident and loops over the G query heads of its group and over the
// query tiles of 32 at or past the tile's first key (causal):
//   dV += p^T . dO;  dK += ds^T . Q    (all f32, dO and Q entered as f32)
// so the GQA head-sum happens in the block's registers, in a fixed order,
// with no atomics: the counterpart of the Pallas grid's inner (G * nq)
// sweep.
#include "attention_tile.cuh"
#include "flash_bwd_sm90.cuh"

namespace dstt {

constexpr int kDqBM = 64;    // query rows per dq block
constexpr int kDkvBN = 64;   // keys per dkv block
constexpr int kDkvBM = 32;   // query rows per dkv tile

template <int D>
struct DqSmem {
  static constexpr int kRows = kDqBM * (D + 1);
  static constexpr int kKeys = kBN * (D + 1);
  static constexpr int kDs = kDqBM * (kBN + 1);
  static constexpr size_t bytes =
      sizeof(float) * (2 * kRows + 2 * kKeys + kDs + 2 * kDqBM) +
      sizeof(int) * 2 * (kDqBM + kBN);
};

template <int D>
struct DkvSmem {
  static constexpr int kKeys = kDkvBN * (D + 1);
  static constexpr int kRows = kDkvBM * (D + 1);
  static constexpr int kP = kDkvBN * (kDkvBM + 1);
  static constexpr size_t bytes =
      sizeof(float) * (2 * kKeys + 2 * kRows + 2 * kP + 2 * kDkvBM) +
      sizeof(int) * 2 * (kDkvBM + kDkvBN);
};

// Whether (query at qp in segment qs, key at kp in segment ks) is live.
__device__ __forceinline__ bool live(int qp, int kp, int qs, int ks, bool causal, bool seg) {
  return qp >= 0 && kp != kNoPos && (!causal || kp <= qp) && (!seg || qs == ks);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    const int* __restrict__ seg, T* __restrict__ dq, int T_, int S, int H, int KV,
                    float scale, int causal) {
  constexpr int BM = kDqBM, RPT = BM / 16;
  using Sm = DqSmem<D>;
  extern __shared__ __align__(16) char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + Sm::kRows;
  float* sK = sDO + Sm::kRows;
  float* sV = sK + Sm::kKeys;
  float* sDS = sV + Sm::kKeys;
  float* sLse = sDS + Sm::kDs;
  float* sDelta = sLse + BM;
  int* sQpos = reinterpret_cast<int*>(sDelta + BM);
  int* sQseg = sQpos + BM;
  int* sKpos = sQseg + BM;
  int* sKseg = sKpos + kBN;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool has_seg = seg != nullptr;

  for (int idx = threadIdx.x; idx < BM * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int tq = q0 + r;
    const long long off = (((long long)b * T_ + tq) * H + h) * D + d;
    sQ[r * (D + 1) + d] = tq < T_ ? to_f<T>(q[off]) : 0.f;
    sDO[r * (D + 1) + d] = tq < T_ ? to_f<T>(dout[off]) : 0.f;
  }
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int tq = q0 + r;
    const bool in = tq < T_;
    const long long row = ((long long)b * H + h) * T_ + tq;
    sQpos[r] = in ? tq : -1;
    sQseg[r] = has_seg && in ? seg[(long long)b * T_ + tq] : -1;
    sLse[r] = in ? lse[row] : 0.f;
  }
  __syncthreads();  // sDO is in
  {
    // delta of row threadIdx.x / 4 (0 past T): the row's four threads each
    // sum a D/4-column slice, met over lane bits 0 and 1, as the
    // tensor-core body does
    static_assert(kThreads == 4 * BM, "four threads a row");
    const int r = threadIdx.x / 4, qc = threadIdx.x % 4;
    const int tq = q0 + r;
    float sum = 0.f;
    if (tq < T_) {
      const T* orow = o + (((long long)b * T_ + tq) * H + h) * D + qc * (D / 4);
      const float* drow = sDO + r * (D + 1) + qc * (D / 4);
#pragma unroll 8
      for (int d = 0; d < D / 4; ++d) sum = fmaf(to_f<T>(orow[d]), drow[d], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (qc == 0) {
      sDelta[r] = sum;
      if (tq < T_) delta[((long long)b * H + h) * T_ + tq] = sum;
    }
  }
  float acc[BM / 16][D / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int n_end = causal ? min(S, q0 + BM) : S;
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kBN * D; idx += kThreads) {
      const int n = idx / D, d = idx % D;
      const int s = n0 + n;
      const long long off = (((long long)b * S + s) * KV + kvh) * D + d;
      sK[n * (D + 1) + d] = s < S ? to_f<T>(k[off]) : 0.f;
      sV[n * (D + 1) + d] = s < S ? to_f<T>(v[off]) : 0.f;
    }
    for (int n = threadIdx.x; n < kBN; n += kThreads) {
      const int s = n0 + n;
      sKpos[n] = s < S ? s : kNoPos;
      sKseg[n] = has_seg && s < S ? seg[(long long)b * S + s] : -2;
    }
    __syncthreads();
    // rows ty*RPT + i against keys tx and tx + 16: q.k and dO.v together
    float sc[RPT][2], dv[RPT][2];
#pragma unroll
    for (int i = 0; i < RPT; ++i) sc[i][0] = sc[i][1] = dv[i][0] = dv[i][1] = 0.f;
    const float* k0 = sK + tx * (D + 1);
    const float* k1 = sK + (tx + 16) * (D + 1);
    const float* v0 = sV + tx * (D + 1);
    const float* v1 = sV + (tx + 16) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a0 = k0[d], a1 = k1[d], b0 = v0[d], b1 = v1[d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty * RPT + i;
        const float qv = sQ[r * (D + 1) + d], ov = sDO[r * (D + 1) + d];
        sc[i][0] = fmaf(qv, a0, sc[i][0]);
        sc[i][1] = fmaf(qv, a1, sc[i][1]);
        dv[i][0] = fmaf(ov, b0, dv[i][0]);
        dv[i][1] = fmaf(ov, b1, dv[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const bool ok = live(sQpos[r], sKpos[c], sQseg[r], sKseg[c], causal != 0, has_seg);
        const float s = ok ? sc[i][j] * scale : kNegInf;
        const float p = expf(s - sLse[r]);
        const float ds = p * (dv[i][j] - sDelta[r]) * scale;
        sDS[r * (kBN + 1) + c] = to_f<T>(from_f<T>(ds));  // ds in K's dtype
      }
    }
    __syncthreads();
    // dQ rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int n = 0; n < kBN; ++n) {
      float kk[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) kk[j] = sK[n * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const float ds = sDS[(ty + 16 * i) * (kBN + 1) + n];
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int tq = q0 + ty + 16 * i;
    if (tq >= T_) continue;
    const long long off = (((long long)b * T_ + tq) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq[off + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     T* __restrict__ dk, T* __restrict__ dvo, int T_, int S, int H, int KV,
                     float scale, int causal) {
  constexpr int BN = kDkvBN, BM = kDkvBM, RPT = BN / 16;
  using Sm = DkvSmem<D>;
  extern __shared__ __align__(16) char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + Sm::kKeys;
  float* sQ = sV + Sm::kKeys;
  float* sDO = sQ + Sm::kRows;
  float* sP = sDO + Sm::kRows;
  float* sDS = sP + Sm::kP;
  float* sLse = sDS + Sm::kP;
  float* sDelta = sLse + BM;
  int* sQpos = reinterpret_cast<int*>(sDelta + BM);
  int* sQseg = sQpos + BM;
  int* sKpos = sQseg + BM;
  int* sKseg = sKpos + BN;

  const int bk = blockIdx.x;
  const int b = bk / KV, kvh = bk % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool has_seg = seg != nullptr;

  for (int idx = threadIdx.x; idx < BN * D; idx += kThreads) {
    const int n = idx / D, d = idx % D;
    const int s = k0 + n;
    const long long off = (((long long)b * S + s) * KV + kvh) * D + d;
    sK[n * (D + 1) + d] = s < S ? to_f<T>(k[off]) : 0.f;
    sV[n * (D + 1) + d] = s < S ? to_f<T>(v[off]) : 0.f;
  }
  for (int n = threadIdx.x; n < BN; n += kThreads) {
    const int s = k0 + n;
    sKpos[n] = s < S ? s : kNoPos;
    sKseg[n] = has_seg && s < S ? seg[(long long)b * S + s] : -2;
  }
  float ak[BN / 16][D / 16], av[BN / 16][D / 16];
#pragma unroll
  for (int i = 0; i < BN / 16; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) ak[i][j] = av[i][j] = 0.f;

  // causal: a query row r sees key k0 only when r >= k0
  const int m_start = causal ? (k0 / BM) * BM : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int m0 = m_start; m0 < T_; m0 += BM) {
      __syncthreads();  // previous tile fully consumed (and K/V loaded)
      for (int idx = threadIdx.x; idx < BM * D; idx += kThreads) {
        const int r = idx / D, d = idx % D;
        const int tq = m0 + r;
        const long long off = (((long long)b * T_ + tq) * H + h) * D + d;
        sQ[r * (D + 1) + d] = tq < T_ ? to_f<T>(q[off]) : 0.f;
        sDO[r * (D + 1) + d] = tq < T_ ? to_f<T>(dout[off]) : 0.f;
      }
      for (int r = threadIdx.x; r < BM; r += kThreads) {
        const int tq = m0 + r;
        const bool in = tq < T_;
        const long long row = ((long long)b * H + h) * T_ + tq;
        sQpos[r] = in ? tq : -1;
        sQseg[r] = has_seg && in ? seg[(long long)b * T_ + tq] : -1;
        sLse[r] = in ? lse[row] : 0.f;
        sDelta[r] = in ? delta[row] : 0.f;
      }
      __syncthreads();
      // keys ty*RPT + i against query rows tx and tx + 16
      float sc[RPT][2], dov[RPT][2];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sc[i][0] = sc[i][1] = dov[i][0] = dov[i][1] = 0.f;
      const float* q0p = sQ + tx * (D + 1);
      const float* q1p = sQ + (tx + 16) * (D + 1);
      const float* o0p = sDO + tx * (D + 1);
      const float* o1p = sDO + (tx + 16) * (D + 1);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float a0 = q0p[d], a1 = q1p[d], b0 = o0p[d], b1 = o1p[d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int n = ty * RPT + i;
          const float kv = sK[n * (D + 1) + d], vv = sV[n * (D + 1) + d];
          sc[i][0] = fmaf(a0, kv, sc[i][0]);
          sc[i][1] = fmaf(a1, kv, sc[i][1]);
          dov[i][0] = fmaf(b0, vv, dov[i][0]);
          dov[i][1] = fmaf(b1, vv, dov[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = ty * RPT + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = tx + 16 * j;
          const bool ok = live(sQpos[r], sKpos[n], sQseg[r], sKseg[n], causal != 0, has_seg);
          const float s = ok ? sc[i][j] * scale : kNegInf;
          const float p = expf(s - sLse[r]);
          sP[n * (BM + 1) + r] = p;
          sDS[n * (BM + 1) + r] = p * (dov[i][j] - sDelta[r]) * scale;
        }
      }
      __syncthreads();
      // dV, dK rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < BM; ++r) {
        float oo[D / 16], qq[D / 16];
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          oo[j] = sDO[r * (D + 1) + tx + 16 * j];
          qq[j] = sQ[r * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < BN / 16; ++i) {
          const float p = sP[(ty + 16 * i) * (BM + 1) + r];
          const float ds = sDS[(ty + 16 * i) * (BM + 1) + r];
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            av[i][j] = fmaf(p, oo[j], av[i][j]);
            ak[i][j] = fmaf(ds, qq[j], ak[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BN / 16; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
    const long long off = (((long long)b * S + s) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(ak[i][j]);
      dvo[off + tx + 16 * j] = from_f<T>(av[i][j]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout, *lse;
  float* delta;  // written by dQ, read by dK/dV
  const int* seg;
  void *dq, *dk, *dv;
  int B, T, S, H, KV;
  float scale;
  int causal;
};

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = DqSmem<D>::bytes;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.T + kDqBM - 1) / kDqBM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), a.delta, a.seg, static_cast<T*>(a.dq), a.T, a.S, a.H,
      a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = DkvSmem<D>::bytes;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.KV, (a.S + kDkvBN - 1) / kDkvBN);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse), a.delta, a.seg,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.T, a.S, a.H, a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DKV, typename T>
cudaError_t dispatch_bwd(const BwdArgs& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return DKV ? launch_dkv<T, 16>(a, s) : launch_dq<T, 16>(a, s);
    case 32: return DKV ? launch_dkv<T, 32>(a, s) : launch_dq<T, 32>(a, s);
    case 64: return DKV ? launch_dkv<T, 64>(a, s) : launch_dq<T, 64>(a, s);
    case 128: return DKV ? launch_dkv<T, 128>(a, s) : launch_dq<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV, int D, typename E>
cudaError_t launch_sm90(const BwdArgs& a, cudaStream_t s) {
  const float* lse = static_cast<const float*>(a.lse);
  if (DKV)
    return sm90::launch_bwd_dkv<D, E>(a.q, a.k, a.v, a.dout, lse, a.delta, a.seg, a.dk, a.dv,
                                      a.B, a.T, a.S, a.H, a.KV, a.scale, a.causal, s);
  return sm90::launch_bwd_dq<D, E>(a.q, a.k, a.v, a.o, a.dout, lse, a.delta, a.seg, a.dq, a.B,
                                   a.T, a.S, a.H, a.KV, a.scale, a.causal, s);
}

template <bool DKV, typename E>
cudaError_t dispatch_sm90(const BwdArgs& a, int D, cudaStream_t s) {
  if (D == 64) return launch_sm90<DKV, 64, E>(a, s);
  if (D == 128) return launch_sm90<DKV, 128, E>(a, s);
  return cudaErrorInvalidValue;
}

template <bool DKV>
int run_bwd(const BwdArgs& a, int D, int dtype, int body, void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.S <= 0 || a.KV <= 0 || a.H % a.KV != 0 ||
      (a.seg && a.T != a.S))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    // (o is null for dK/dV)
    const uintptr_t addr = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                           reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
                           reinterpret_cast<uintptr_t>(a.dout);
    if ((addr & 15) != 0) return cudaErrorInvalidValue;
    if (dtype == 1) return dispatch_sm90<DKV, __nv_bfloat16>(a, D, s);
    if (dtype == 2) return dispatch_sm90<DKV, __half>(a, D, s);
    return cudaErrorInvalidValue;
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_bwd<DKV, float>(a, D, s);
  if (dtype == 1) return dispatch_bwd<DKV, __nv_bfloat16>(a, D, s);
  if (dtype == 2) return dispatch_bwd<DKV, __half>(a, D, s);
  return cudaErrorInvalidValue;
}

}  // namespace dstt

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; lse, delta: [B, H, T] f32
// (delta written by dq for every row below T, read by dkv); seg: [B, T]
// int32 or null (needs T == S); body: 0 = the scalar body, 1 = the
// tensor-core body (bfloat16 or float16, D 64 or 128, q/k/v/o/dout 16-byte
// aligned).  Each returns the launch's cudaError_t.
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* delta, const void* seg,
                                 void* dq, int B, int T, int S, int H, int KV, int D, float scale,
                                 int causal, int dtype, int body, void* stream) {
  const dstt::BwdArgs a{q, k, v, o, dout, lse, static_cast<float*>(delta),
                        static_cast<const int*>(seg), dq, nullptr, nullptr, B, T, S, H, KV,
                        scale, causal};
  return dstt::run_bwd<false>(a, D, dtype, body, stream);
}

extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* seg, void* dk, void* dv, int B, int T, int S,
                                  int H, int KV, int D, float scale, int causal, int dtype,
                                  int body, void* stream) {
  const dstt::BwdArgs a{q, k, v, nullptr, dout, lse,
                        static_cast<float*>(const_cast<void*>(delta)),
                        static_cast<const int*>(seg), nullptr, dk, dv, B, T, S, H, KV, scale,
                        causal};
  return dstt::run_bwd<true>(a, D, dtype, body, stream);
}
