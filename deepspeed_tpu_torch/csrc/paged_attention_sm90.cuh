// Paged attention for Hopper (sm_90a): the body that paged_attention.cu (B5,
// bf16 pages) and paged_attention_quant.cu (B7, int8 codes with one f32
// scale per token row) run for a bfloat16 q with head_dim 64 or 128, every
// Llama-3-8B path, and B5 too for a float16 q over bf16 pages (the fp16
// model's paged generator; TQ, q's and the output's type).  f32 and
// head_dim 16 / 32 keep the scalar block of paged_attention.cuh.
//
// Replaces deepspeed_tpu/inference/kernels.py::_chunk_v2_kernel and
// ::_chunk_v2_quant_kernel.  The contract is theirs: q [B, C, H, D] at
// positions start[b] + c over one layer's pages [KV, P, ps, D] through the
// table [B, mp]; flattened row r of a kv head's C*G rows is query position
// r / G of head kvh*G + r % G (GQA read in place) and sees the keys
// kpos <= start + r / G; a row with no key (start = -1) gives zeros; the
// sweep stops at the frontier start + c_last + 1, clamped to mp * ps, so a
// table slot past it (stale: another row's page or the trash page) is never
// dereferenced; B7 reads K and V as f32(code) * scale.
//
// Pages are staged with cp.async, 16 bytes a thread, each key row addressed
// through the table, into rings of shared-memory tiles; keys past the
// frontier are zero-filled, never read.  (TMA boxes of one page would need
// ps to be a multiple of 8 for the 1024-byte-aligned 128-byte swizzle; row
// copies take any page size, and the wrapper encodes no tensor map.)
//
// Decode (C*G <= 16 rows, bound by bytes: every live K/V byte read once):
// one block of 128 threads per (span of whole pages, b * KV + kvh): 128
// keys or more, and at most 64 spans, so 8 rows of up to 1024 keys fill the
// card twice over with 128-key spans.  The block reads its G query rows
// once, stages its span in tiles of 32 keys through a ring of 4 slots and
// does the f32 math on the CUDA cores, every K/V byte shared by the kv
// head's query rows; the rows' count is bucketed at compile time (4, 8,
// 16) so its loops carry no branch on it.  It writes its partial
// (m, l, acc); the last block of a (b, kv head) to finish (a counter per
// (b, kv head) that it sets back to 0) merges the partials in span order, so
// one launch gives the output.  Spans past a row's frontier exit at once,
// and a row whose keys fit one span is written by that span's block alone.
//
// Chunked prefill (C*G > 16 rows, bound by operations): one block of two
// warpgroups per item of 128 flattened rows of one (b, kv head); the item
// walks key tiles of 64 up to its last row's frontier through a ring of 3
// stages.  S = Q K^T is wgmma m64n64k16 from shared memory (Q and K K-major,
// 128-byte swizzle), the online softmax runs in f32 on the accumulator
// fragment, and O += P V is wgmma with P as the register A operand, split
// into bf16 hi + lo (two products) so P keeps ~2^-16 of its f32 value, and V
// read MN-major through the transpose bit.  B7 stages the codes and scales,
// converts the codes to bf16 in shared memory (exact: |code| <= 127) and
// moves the scales out of the products: S[r, n] = (q . code_n) * ks_n, and
// P'[r, n] = P[r, n] * vs_n before the split.
//
// A float16 q meets bf16 pages as the JAX kernel has them meet: both read as
// f32 (q is an exact f32 value of 11 significant bits).  Decode does its
// math in f32 on the CUDA cores anyway.  Chunked prefill needs one operand
// type for Q K^T: each fp16 q is split, once per item in shared memory,
// into bf16 hi + lo, which hold its 11 bits exactly (fp16's exponent range
// lies inside bf16's), so Q K^T = Q_hi K^T + Q_lo K^T is the f32 product up
// to the order of the sums, at twice the Q K^T product work.  The output
// is written in q's type.
#pragma once

#include "dtype.cuh"
#include "sm90_common.cuh"

namespace dstt {
namespace paged90 {

using bf16 = __nv_bfloat16;
using sm90::smem_u32;

constexpr float kMasked = -1e30f;   // masked score on the CUDA-core path

// ------------------------------------------------------------ primitives

// 16 bytes global -> shared; valid = false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (a row's scale); valid = false fills zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) { return dstt::pack2<bf16>(a, b); }
// x0, x1 as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi) (exact in f32)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2(x0, x1);
  const float2 hf = unpack2<bf16>(hi);
  lo = pack2(x0 - hf.x, x1 - hf.y);
}

// byte offset of 16-byte chunk j of row n in a K-major operand tile of
// `rows` rows stored as D/64 halves of [rows][64] bf16 (128-byte rows,
// 128-byte swizzle: chunk c of row n sits at chunk c ^ (n & 7))
__device__ __forceinline__ uint32_t sw128(int rows, int n, int j) {
  const int half = j >> 3, c = j & 7;
  return (uint32_t)(half * rows * 128 + n * 128 + ((c ^ (n & 7)) << 4));
}

// ------------------------------------------------------------ K/V sources

// Dense bf16 pages [KV, P, ps, D].
struct DenseSrc {
  static constexpr bool kQuant = false;
  const bf16* k;
  const bf16* v;
};

// int8 codes [KV, P, ps, D] with one f32 scale per token row [KV, P, ps, 1].
struct QuantSrc {
  static constexpr bool kQuant = true;
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
};

// the page row (kvh, table[b][pos / ps], pos % ps) as a row index into the
// pool; pos must lie below the frontier
__device__ __forceinline__ long long page_row(const int* row_table, int kvh, int P, int ps,
                                              int pos) {
  return ((long long)kvh * P + row_table[pos / ps]) * ps + pos % ps;
}

// ------------------------------------------------------------ decode

constexpr int kDecThreads = 128;
constexpr int kDecRows = 16;    // C * G rows at most
constexpr int kDecTile = 32;    // keys per ring slot
constexpr int kDecStages = 4;   // ring slots
constexpr int kMaxSpans = 64;   // spans of one (b, kv head) at most

// Shared memory of a decode block, in bytes: f32 q rows, the ring of K and V
// rows (each padded by 16 bytes, so a warp's 16-byte reads of 32 rows fall
// in distinct banks), the rows' scales (B7), and the score tile.
template <int D, bool kQuant>
struct DecLayout {
  static constexpr int kRowData = kQuant ? D : 2 * D;   // bytes of a key row
  static constexpr int kRow = kRowData + 16;
  static constexpr int kChunks = kRowData / 16;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kDecRows * D * 4;
  static constexpr int kV = kK + kDecStages * kDecTile * kRow;
  static constexpr int kKs = kV + kDecStages * kDecTile * kRow;
  static constexpr int kVs = kKs + kDecStages * kDecTile * 4;
  static constexpr int kP = kVs + kDecStages * kDecTile * 4;
  static constexpr int kM = kP + kDecRows * (kDecTile + 1) * 4;
  static constexpr int kL = kM + kDecRows * 4;
  static constexpr int kAlpha = kL + kDecRows * 4;
  static constexpr int kLast = kAlpha + kDecRows * 4;
  static constexpr int bytes = kLast + 16;
};

// 8 bf16 or 16 int8 values of a staged row as f32
template <bool kQuant>
__device__ __forceinline__ void unpack16(const unsigned char* p, float* x);
template <>
__device__ __forceinline__ void unpack16<false>(const unsigned char* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void unpack16<true>(const unsigned char* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char4 c = *reinterpret_cast<const char4*>(&w[i]);
    x[4 * i] = static_cast<float>(c.x);
    x[4 * i + 1] = static_cast<float>(c.y);
    x[4 * i + 2] = static_cast<float>(c.z);
    x[4 * i + 3] = static_cast<float>(c.w);
  }
}

// Partials of span s of (b, kv head) bk: m and l at [bk][s][kDecRows], acc
// at [bk][s][kDecRows][D], in part (f32, 2 * n + n * D floats for n =
// B * KV * nspan * kDecRows).  kR (4, 8 or 16) is the rows' bucket: rows
// R..kR-1 carry zeros through branch-free loops, so the compiler keeps
// every shared-memory load of a loop in flight at once.
template <int D, int kR, typename Src, typename TQ>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_sm90(const TQ* __restrict__ q, Src src, const int* __restrict__ table,
                  const int* __restrict__ start, TQ* __restrict__ out, int* __restrict__ counters,
                  float* __restrict__ part, int B, int C, int H, int KV, int P, int ps, int mp,
                  int span_pages, float scale) {
  constexpr bool kQuant = Src::kQuant;
  using L = DecLayout<D, kQuant>;
  constexpr int kGroups = kDecThreads / D;   // row groups of the P.V phase
  constexpr int kRT = kR / kGroups;          // rows per thread there
  constexpr int kRW = kR / 4;                // rows per warp in the scores and softmax
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem + L::kQ);
  unsigned char* s_k = smem + L::kK;
  unsigned char* s_v = smem + L::kV;
  float* s_ks = reinterpret_cast<float*>(smem + L::kKs);
  float* s_vs = reinterpret_cast<float*>(smem + L::kVs);
  float* s_p = reinterpret_cast<float*>(smem + L::kP);
  float* s_m = reinterpret_cast<float*>(smem + L::kM);
  float* s_l = reinterpret_cast<float*>(smem + L::kL);
  float* s_alpha = reinterpret_cast<float*>(smem + L::kAlpha);
  int* s_last = reinterpret_cast<int*>(smem + L::kLast);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int span = blockIdx.x, nspan = gridDim.x;
  const int bk = blockIdx.y, b = bk / KV, kvh = bk % KV;
  const int G = H / KV, R = C * G;
  const int st = start[b];
  // every row's keys lie below the last row's frontier, clamped to mp * ps
  const int live = min(st + C, mp * ps);
  const int span_keys = span_pages * ps;
  const int k_lo = span * span_keys;
  const int k_hi = min(live, k_lo + span_keys);
  const int* row_table = table + (long long)b * mp;
  const int d = tid % D, rg = tid / D;
  // the spans that hold keys; a span past them has nothing to do (span 0 of
  // an empty row writes its zeros)
  const int n_live = live > 0 ? min(nspan, (live + span_keys - 1) / span_keys) : 0;
  if (span >= max(n_live, 1)) return;
  float acc[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) acc[i] = 0.f;

  if (k_lo < k_hi) {
    for (int idx = tid; idx < kR * D; idx += kDecThreads) {
      const int r = idx / D, dd = idx % D;
      const int c = r / G, h = kvh * G + r % G;
      s_q[r * D + dd] =
          r < R ? to_f<TQ>(q[(((long long)b * C + c) * H + h) * D + dd]) : 0.f;
    }
    if (tid < kR) {
      s_m[tid] = kMasked;
      s_l[tid] = 0.f;
    }
    const int n_tiles = (k_hi - k_lo + kDecTile - 1) / kDecTile;
    const unsigned char* kbase = reinterpret_cast<const unsigned char*>(src.k);
    const unsigned char* vbase = reinterpret_cast<const unsigned char*>(src.v);
    // a tile's copies: first every table read of this thread (in flight
    // together), then the copies, which wait on them
    auto issue = [&](int t) {
      constexpr int kIter = kDecTile * L::kChunks / kDecThreads;
      const int slot = t % kDecStages, n0 = k_lo + t * kDecTile;
      long long rows[kIter];
#pragma unroll
      for (int i = 0; i < kIter; ++i) {
        const int pos = n0 + (tid + i * kDecThreads) / L::kChunks;
        rows[i] = pos < k_hi ? page_row(row_table, kvh, P, ps, pos) : -1;
      }
#pragma unroll
      for (int i = 0; i < kIter; ++i) {
        const int idx = tid + i * kDecThreads;
        const int n = idx / L::kChunks, j = idx % L::kChunks;
        const bool valid = rows[i] >= 0;
        const long long row = valid ? rows[i] : 0;
        const long long off = row * L::kRowData + 16 * j;
        const int soff = (slot * kDecTile + n) * L::kRow + 16 * j;
        cp_async16(s_k + soff, kbase + off, valid);
        cp_async16(s_v + soff, vbase + off, valid);
        if constexpr (kQuant) {
          if (j == 0) {
            cp_async4(s_ks + slot * kDecTile + n, src.ks + row, valid);
            cp_async4(s_vs + slot * kDecTile + n, src.vs + row, valid);
          }
        }
      }
    };
#pragma unroll
    for (int t = 0; t < kDecStages - 1; ++t) {
      if (t < n_tiles) issue(t);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kDecStages - 2>();
      __syncthreads();   // tile t is in for every thread; slot t - 1 is free
      if (t + kDecStages - 1 < n_tiles) issue(t + kDecStages - 1);
      cp_async_commit();
      const int slot = t % kDecStages, n0 = k_lo + t * kDecTile;

      // scores: thread (warp, lane) takes key `lane` against rows warp,
      // warp + 4, ...; q rows are read as broadcasts, each chunk's products
      // summed in a short chain of their own
      {
        constexpr int kPer = kQuant ? 16 : 8;
        const unsigned char* krow = s_k + (slot * kDecTile + lane) * L::kRow;
        float dot[kRW];
#pragma unroll
        for (int i = 0; i < kRW; ++i) dot[i] = 0.f;
#pragma unroll
        for (int j = 0; j < L::kChunks; ++j) {
          float x[kPer];
          unpack16<kQuant>(krow + 16 * j, x);
#pragma unroll
          for (int i = 0; i < kRW; ++i) {
            const float4* qr = reinterpret_cast<const float4*>(s_q + (warp + 4 * i) * D + j * kPer);
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < kPer / 4; ++e) {
              const float4 qv = qr[e];
              part = fmaf(qv.x, x[4 * e], part);
              part = fmaf(qv.y, x[4 * e + 1], part);
              part = fmaf(qv.z, x[4 * e + 2], part);
              part = fmaf(qv.w, x[4 * e + 3], part);
            }
            dot[i] += part;
          }
        }
        const int pos = n0 + lane;
        float ks = 1.f;
        if constexpr (kQuant) ks = s_ks[slot * kDecTile + lane];
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const int r = warp + 4 * i;
          const bool valid = r < R && pos < k_hi && pos <= st + r / G;
          s_p[r * (kDecTile + 1) + lane] = valid ? dot[i] * ks * scale : kMasked;
        }
      }
      __syncthreads();
      // online softmax: warp w owns rows w, w + 4, ...; lane = key
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        const int r = warp + 4 * i;
        const float x = s_p[r * (kDecTile + 1) + lane];
        const float m_old = s_m[r];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float p = x > kMasked * 0.5f ? expf(x - m_new) : 0.f;
        const float sum = warp_sum(p);
        s_p[r * (kDecTile + 1) + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          s_m[r] = m_new;
          s_l[r] = s_l[r] * alpha + sum;
          s_alpha[r] = alpha;
        }
      }
      __syncthreads();
      // P.V: thread owns column d of rows rg, rg + kGroups, ...
#pragma unroll
      for (int i = 0; i < kRT; ++i) acc[i] *= s_alpha[rg + kGroups * i];
      const unsigned char* vslot = s_v + slot * kDecTile * L::kRow;
#pragma unroll 8
      for (int n = 0; n < kDecTile; ++n) {
        float vx;
        if constexpr (kQuant)
          vx = static_cast<float>(reinterpret_cast<const int8_t*>(vslot + n * L::kRow)[d]) *
               s_vs[slot * kDecTile + n];
        else
          vx = __bfloat162float(reinterpret_cast<const bf16*>(vslot + n * L::kRow)[d]);
#pragma unroll
        for (int i = 0; i < kRT; ++i)
          acc[i] = fmaf(s_p[(rg + kGroups * i) * (kDecTile + 1) + n], vx, acc[i]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // s_m, s_l final for every thread

    if (n_live == 1) {  // the only span with keys: normalise and store
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int r = rg + kGroups * i;
        if (r >= R) continue;
        const int c = r / G, h = kvh * G + r % G;
        const float l = s_l[r];
        out[(((long long)b * C + c) * H + h) * D + d] = from_f<TQ>(l == 0.f ? 0.f : acc[i] / l);
      }
      return;
    }
    const long long prow = ((long long)bk * nspan + span) * kDecRows;
    const long long n_all = (long long)B * KV * nspan * kDecRows;
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int r = rg + kGroups * i;
      if (r < R) part[2 * n_all + (prow + r) * D + d] = acc[i];
    }
    if (tid < R) {
      part[prow + tid] = s_m[tid];
      part[n_all + prow + tid] = s_l[tid];
    }
  } else {  // no key at all (an empty row): zeros
    for (int idx = tid; idx < R * D; idx += kDecThreads) {
      const int r = idx / D, dd = idx % D;
      const int c = r / G, h = kvh * G + r % G;
      out[(((long long)b * C + c) * H + h) * D + dd] = from_f<TQ>(0.f);
    }
    return;
  }

  // the last of this (b, kv head)'s n_live blocks to get here merges their
  // partials, in span order, and sets the counter back to 0
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(counters + bk, 1) == n_live - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  const long long n_all = (long long)B * KV * nspan * kDecRows;
  const long long row0 = (long long)bk * nspan * kDecRows;
  // each thread merges its column d of its rows, a batch of spans at a
  // time: every load of a batch in flight together, then an online rescale
  constexpr int kBatch = kRT >= 32 ? 1 : 32 / kRT;
  float mx[kRT], l[kRT], a[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    mx[i] = kMasked;
    l[i] = 0.f;
    a[i] = 0.f;
  }
  for (int s0 = 0; s0 < n_live; s0 += kBatch) {
    float bm[kBatch][kRT], bl[kBatch][kRT], ba[kBatch][kRT];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const bool in = s0 + k < n_live;
        const long long pr = row0 + (s0 + k) * kDecRows + rg + kGroups * i;
        bm[k][i] = in ? __ldcg(part + pr) : kMasked;
        bl[k][i] = in ? __ldcg(part + n_all + pr) : 0.f;
        ba[k][i] = in ? __ldcg(part + 2 * n_all + pr * D + d) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      float nm = mx[i];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) nm = fmaxf(nm, bm[k][i]);
      const float sc = expf(mx[i] - nm);
      l[i] *= sc;
      a[i] *= sc;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float w = expf(bm[k][i] - nm);
        l[i] = fmaf(bl[k][i], w, l[i]);
        a[i] = fmaf(ba[k][i], w, a[i]);
      }
      mx[i] = nm;
    }
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int r = rg + kGroups * i;
    if (r >= R) continue;
    const int c = r / G, h = kvh * G + r % G;
    out[(((long long)b * C + c) * H + h) * D + d] = from_f<TQ>(l[i] == 0.f ? 0.f : a[i] / l[i]);
  }
  if (tid == 0) counters[bk] = 0;
}

// ------------------------------------------------------------ chunked prefill

constexpr int kChThreads = 256;   // two consumer warpgroups of 64 rows
constexpr int kChRows = 128;      // flattened rows per item
constexpr int kChTile = 64;       // keys per stage
constexpr int kChStages = 3;      // ring stages

// Shared memory of a chunk block, in bytes from a 1024-aligned base: Q and
// the K/V operand tiles (bf16, 128-byte swizzle); dense pages are staged
// straight into a ring of operand tiles, int8 codes into a ring of raw
// tiles (with their scales) that is converted into one operand tile.  With
// a float16 q (kSplitQ) Q arrives as fp16 and becomes its bf16 hi part in
// place, the lo part in a second tile of the same layout.
template <int D, bool kQuant, bool kSplitQ = false>
struct ChLayout {
  static constexpr int kOpStages = kQuant ? 1 : kChStages;
  static constexpr int kQ = 0;
  static constexpr int kHalfQ = kChRows * 128;     // bytes of one 64-column half
  static constexpr int kHalfKV = kChTile * 128;
  static constexpr int kTileKV = kChTile * D * 2;  // one K (or V) operand tile
  static constexpr int kQLo = kQ + kChRows * D * 2;
  static constexpr int kK = kQLo + (kSplitQ ? kChRows * D * 2 : 0);
  static constexpr int kV = kK + kOpStages * kTileKV;
  static constexpr int kRawK = kV + kOpStages * kTileKV;
  static constexpr int kRaw = kChTile * D;         // one raw code tile
  static constexpr int kRawV = kRawK + (kQuant ? kChStages * kRaw : 0);
  static constexpr int kKs = kRawV + (kQuant ? kChStages * kRaw : 0);
  static constexpr int kVs = kKs + (kQuant ? kChStages * kChTile * 4 : 0);
  static constexpr int bytes = kVs + (kQuant ? kChStages * kChTile * 4 : 0);
};

// sc (+)= Q K^T over D (accumulate = false: sc = Q K^T)
template <int D>
__device__ __forceinline__ void wgmma_qk(float (&sc)[kChTile / 2], uint32_t q_base,
                                         uint32_t k_base, bool accumulate) {
  using L = ChLayout<D, false>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_n64(
        sc, sm90::desc_sw128(q_base + (kk / 4) * L::kHalfQ + (kk % 4) * 32, 16, 1024),
        sm90::desc_sw128(k_base + (kk / 4) * L::kHalfKV + (kk % 4) * 32, 16, 1024),
        accumulate || kk > 0);
}

template <int D, typename Src, typename TQ>
__global__ void __launch_bounds__(kChThreads, 1)
paged_chunk_sm90(const TQ* __restrict__ q, Src src, const int* __restrict__ table,
                 const int* __restrict__ start, TQ* __restrict__ out, int B, int C, int H,
                 int KV, int P, int ps, int mp, float scale) {
  constexpr bool kQuant = Src::kQuant;
  constexpr bool kSplitQ = kIsHalf<TQ>;
  static_assert(!(kQuant && kSplitQ), "B7 takes a float32 or bfloat16 q");
  using L = ChLayout<D, kQuant, kSplitQ>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const int tid = threadIdx.x;
  const int G = H / KV, CG = C * G;
  const int n_rb = (CG + kChRows - 1) / kChRows;
  // the item's rows: the last row blocks (the most keys) first
  const int bk = blockIdx.x % (B * KV);
  const int rb = n_rb - 1 - blockIdx.x / (B * KV);
  const int b = bk / KV, kvh = bk % KV, r0 = rb * kChRows;
  const int st = start[b];
  const int c_last = (min(r0 + kChRows, CG) - 1) / G;
  const int k_hi = min(st + c_last + 1, mp * ps);
  const int n_tiles = k_hi > 0 ? (k_hi + kChTile - 1) / kChTile : 0;
  const int* row_table = table + (long long)b * mp;

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, qc = lane % 4;
  int row[2], qpos[2];
  row[0] = r0 + wg * 64 + warp * 16 + lane / 4;
  row[1] = row[0] + 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = st + min(row[r], CG - 1) / G;
  const int wg_qpos = st + min(r0 + wg * 64, CG - 1) / G;   // this warpgroup's first row

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    const unsigned char* kbase = reinterpret_cast<const unsigned char*>(src.k);
    const unsigned char* vbase = reinterpret_cast<const unsigned char*>(src.v);
    // Q rows (zeros past C*G): 16-byte chunks into the swizzled halves
    auto issue_q = [&]() {
      for (int idx = tid; idx < kChRows * D / 8; idx += kChThreads) {
        const int n = idx / (D / 8), j = idx % (D / 8);
        const int f = r0 + n;
        const bool valid = f < CG;
        const int c = valid ? f / G : 0, h = kvh * G + (valid ? f % G : 0);
        cp_async16(smem + L::kQ + sw128(kChRows, n, j),
                   q + (((long long)b * C + c) * H + h) * D + 8 * j, valid);
      }
    };
    // a tile's copies: first every table read of this thread (in flight
    // together), then the copies, which wait on them
    auto issue = [&](int t) {
      const int slot = t % kChStages, n0 = t * kChTile;
      constexpr int kPerRow = kQuant ? D / 16 : D / 8;   // 16-byte chunks of a row
      constexpr int kIter = kChTile * kPerRow / kChThreads;
      long long rows[kIter];
#pragma unroll
      for (int i = 0; i < kIter; ++i) {
        const int pos = n0 + (tid + i * kChThreads) / kPerRow;
        rows[i] = pos < k_hi ? page_row(row_table, kvh, P, ps, pos) : -1;
      }
      if constexpr (!kQuant) {
#pragma unroll
        for (int i = 0; i < kIter; ++i) {
          const int idx = tid + i * kChThreads;
          const int n = idx / kPerRow, j = idx % kPerRow;
          const bool valid = rows[i] >= 0;
          const long long off = (valid ? rows[i] : 0) * (2 * D) + 16 * j;
          const uint32_t so = slot * L::kTileKV + sw128(kChTile, n, j);
          cp_async16(smem + L::kK + so, kbase + off, valid);
          cp_async16(smem + L::kV + so, vbase + off, valid);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kIter; ++i) {
          const int idx = tid + i * kChThreads;
          const int n = idx / kPerRow, j = idx % kPerRow;
          const bool valid = rows[i] >= 0;
          const long long row = valid ? rows[i] : 0;
          const int so = slot * L::kRaw + n * D + 16 * j;
          cp_async16(smem + L::kRawK + so, kbase + row * D + 16 * j, valid);
          cp_async16(smem + L::kRawV + so, vbase + row * D + 16 * j, valid);
          if (j == 0) {
            cp_async4(smem + L::kKs + (slot * kChTile + n) * 4, src.ks + row, valid);
            cp_async4(smem + L::kVs + (slot * kChTile + n) * 4, src.vs + row, valid);
          }
        }
      }
    };
    // int8 codes of ring slot `slot` -> bf16 operand tiles (exact)
    auto convert = [&](int slot) {
      for (int idx = tid; idx < kChTile * D / 8; idx += kChThreads) {
        const int n = idx / (D / 8), j = idx % (D / 8);
        const int so = slot * L::kRaw + n * D + 8 * j;
        const uint32_t dst = sw128(kChTile, n, j);
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const uint2 u = *reinterpret_cast<const uint2*>(smem + (kv ? L::kRawV : L::kRawK) + so);
          const char4 a = *reinterpret_cast<const char4*>(&u.x);
          const char4 c = *reinterpret_cast<const char4*>(&u.y);
          uint4 o;
          o.x = pack2(a.x, a.y);
          o.y = pack2(a.z, a.w);
          o.z = pack2(c.x, c.y);
          o.w = pack2(c.z, c.w);
          *reinterpret_cast<uint4*>(smem + (kv ? L::kV : L::kK) + dst) = o;
        }
      }
    };

    // fp16 Q rows -> bf16 hi in place and lo beside it (exact: see above)
    auto split_q = [&]() {
      for (int idx = tid; idx < kChRows * D / 8; idx += kChThreads) {
        const uint32_t off = sw128(kChRows, idx / (D / 8), idx % (D / 8));
        uint4* hi = reinterpret_cast<uint4*>(smem + L::kQ + off);
        const uint4 u = *hi;
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        uint32_t h[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack2<TQ>(w[i]);
          split2(f.x, f.y, h[i], lo[i]);
        }
        *hi = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(smem + L::kQLo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    };

    const float scale_log2 = scale * sm90::kLog2e;
    const uint32_t q_base = smem_u32(smem + L::kQ) + wg * 64 * 128;
    const uint32_t q_lo_base = smem_u32(smem + L::kQLo) + wg * 64 * 128;
    float sc[kChTile / 2];
    uint32_t pa_hi[kChTile / 16][4], pa_lo[kChTile / 16][4];

#pragma unroll
    for (int t = 0; t < kChStages - 1; ++t) {
      if (t == 0) issue_q();
      if (t < n_tiles) issue(t);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kChStages - 2>();
      fence_async_smem();
      __syncthreads();   // tile t is in; every warpgroup is done with tile t - 1
      const int slot = t % kChStages, n0 = t * kChTile;
      if constexpr (kSplitQ) {
        if (t == 0) {
          split_q();
          fence_async_smem();
          __syncthreads();
        }
      }
      int op = slot;
      if constexpr (kQuant) {
        convert(slot);
        fence_async_smem();
        __syncthreads();
        op = 0;
      }
      if (t + kChStages - 1 < n_tiles) issue(t + kChStages - 1);
      cp_async_commit();

      const uint32_t k_base = smem_u32(smem + L::kK + op * L::kTileKV);
      const uint32_t v_base = smem_u32(smem + L::kV + op * L::kTileKV);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      wgmma_qk<D>(sc, q_base, k_base, false);
      if constexpr (kSplitQ) wgmma_qk<D>(sc, q_lo_base, k_base, true);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // fragment: register i is row (i >> 1) & 1, column 8 (i >> 2) + 2 qc + (i & 1)
      if constexpr (kQuant) {
        const float* ks = reinterpret_cast<const float*>(smem + L::kKs) + slot * kChTile;
#pragma unroll
        for (int i = 0; i < kChTile / 2; ++i) sc[i] *= ks[8 * (i >> 2) + 2 * qc + (i & 1)];
      }
      // the mask, only where the tile crosses the frontier or a row's position
      if (n0 + kChTile > k_hi || n0 + kChTile - 1 > wg_qpos) {
#pragma unroll
        for (int i = 0; i < kChTile / 2; ++i) {
          const int col = n0 + 8 * (i >> 2) + 2 * qc + (i & 1);
          if (col >= k_hi || col > qpos[(i >> 1) & 1]) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]}, alpha[2], ms[2];
#pragma unroll
      for (int i = 0; i < kChTile / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no live key yet keeps m = -inf; its p = exp2(-inf) = 0
        ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
        alpha[r] = sm90::ex2(m[r] * scale_log2 - ms[r]);
        m[r] = mx[r];
      }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kChTile / 2; ++i) {
        sc[i] = sm90::ex2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
        rsum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
      if constexpr (kQuant) {
        const float* vs = reinterpret_cast<const float*>(smem + L::kVs) + slot * kChTile;
#pragma unroll
        for (int i = 0; i < kChTile / 2; ++i) sc[i] *= vs[8 * (i >> 2) + 2 * qc + (i & 1)];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kChTile / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split2(sc[kk * 8 + 2 * j], sc[kk * 8 + 2 * j + 1], pa_hi[kk][j], pa_lo[kk][j]);

      sm90::fence_regs(acc);
      sm90::fence_regs(pa_hi);
      sm90::fence_regs(pa_lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChTile / 16; ++kk) {
        const uint64_t dv = sm90::desc_sw128(v_base + kk * 16 * 128, L::kHalfKV, 1024);
        sm90::wgmma_pv<D>(acc, pa_hi[kk], dv);
        sm90::wgmma_pv<D>(acc, pa_lo[kk], dv);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa_hi);
      sm90::fence_regs(pa_lo);
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= CG) continue;
    const int c = row[r] / G, h = kvh * G + row[r] % G;
    TQ* orow = out + (((long long)b * C + c) * H + h) * D + 2 * qc;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a0 = l[r] == 0.f ? 0.f : acc[4 * j + 2 * r] / l[r];
      const float a1 = l[r] == 0.f ? 0.f : acc[4 * j + 2 * r + 1] / l[r];
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = dstt::pack2<TQ>(a0, a1);
    }
  }
}

// ------------------------------------------------------------ host side

// Host-side arguments of one launch of the Hopper body.  counters [B * KV]
// int32 (zeros, and left zeros) and part (f32, see paged_decode_sm90) are
// needed by decode with more than one span.
struct Sm90Args {
  const void* q;
  const void* table;
  const void* start;
  void* out;
  int* counters;
  float* part;
  int B, C, H, KV, D, P, ps, mp, span_pages;
  float scale;
};

template <int D, typename Src, typename TQ>
cudaError_t launch_d(const Sm90Args& a, Src src, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const TQ* q = static_cast<const TQ*>(a.q);
  const int* table = static_cast<const int*>(a.table);
  const int* start = static_cast<const int*>(a.start);
  TQ* out = static_cast<TQ*>(a.out);
  if (a.C * G <= kDecRows) {
    const int nspan = (a.mp + a.span_pages - 1) / a.span_pages;
    if (nspan > kMaxSpans || (nspan > 1 && (a.counters == nullptr || a.part == nullptr)))
      return cudaErrorInvalidValue;
    const int smem = DecLayout<D, Src::kQuant>::bytes;
    const int R = a.C * G;
    auto kern = R <= 4   ? paged_decode_sm90<D, 4, Src, TQ>
                : R <= 8 ? paged_decode_sm90<D, 8, Src, TQ>
                         : paged_decode_sm90<D, 16, Src, TQ>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(nspan, a.B * a.KV), kDecThreads, smem, stream>>>(
        q, src, table, start, out, a.counters, a.part, a.B, a.C, a.H, a.KV, a.P, a.ps, a.mp,
        a.span_pages, a.scale);
    return cudaGetLastError();
  }
  // + room to align the base
  const int smem = ChLayout<D, Src::kQuant, kIsHalf<TQ>>::bytes + 1024;
  auto kern = paged_chunk_sm90<D, Src, TQ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)a.B * a.KV * ((a.C * G + kChRows - 1) / kChRows);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)items, kChThreads, smem, stream>>>(q, src, table, start, out, a.B, a.C, a.H,
                                                      a.KV, a.P, a.ps, a.mp, a.scale);
  return cudaGetLastError();
}

// q (and the output) of type TQ, bf16 or (dense pages only) fp16, with
// head_dim 64 or 128; every pointer the body stages from is 16-byte aligned
// (scales 4-byte), as cp.async needs
template <typename Src, typename TQ = bf16>
cudaError_t launch(const Sm90Args& a, Src src, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(src.k) |
                         reinterpret_cast<uintptr_t>(src.v);
  if ((addr & 15) != 0) return cudaErrorInvalidValue;
  if (a.D == 64) return launch_d<64, Src, TQ>(a, src, stream);
  if (a.D == 128) return launch_d<128, Src, TQ>(a, src, stream);
  return cudaErrorInvalidValue;
}

}  // namespace paged90
}  // namespace dstt
