// Shared tile routines for the two attention kernels (flash_fwd.cu and
// paged_attention.cu): one thread block owns BM query rows and sweeps the
// keys in tiles of kBN = 32 with an f32 online softmax (m, l, acc).
//
// Layout in shared memory, all f32:
//   sQ [BM][D+1]   query rows (the +1 pad keeps the column walk of the
//                  score loop free of bank conflicts)
//   sK [kBN][D+1]  key rows of the current tile
//   sV [kBN][D]    value rows of the current tile (read along d)
//   sP [BM][kBN+1] scores, then probabilities
//   sM, sL, sAlpha [BM] running max, running sum, this tile's rescale
//   sKoff [kBN]    element offset of each key slot's row in K and V
//                  (-1 for a slot past the live range)
//   sQpos [BM], sKpos [kBN] token positions for the causal mask
//   sQseg [BM], sKseg [kBN] packed-sequence segment ids (flash forward)
//
// 256 threads = 16 (tx) x 16 (ty).  Scores: thread (tx, ty) computes rows
// ty*BM/16 .. +BM/16 against keys tx and tx+16.  Softmax: warp w owns rows
// w, w+8, ...; lane = key.  P.V: thread owns rows ty + 16 i and head
// columns tx + 16 j, so D must be a multiple of 16.
#pragma once

#include <stdint.h>

#include "dtype.cuh"

namespace dstt {

constexpr int kBN = 32;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;     // masked score (NEG_INF of the reference)
constexpr int kNoPos = 0x7fffffff;    // key slot past the live range

template <int BM, int D>
struct TileSmem {
  static constexpr int kQ = BM * (D + 1);
  static constexpr int kK = kBN * (D + 1);
  static constexpr int kV = kBN * D;
  static constexpr int kP = BM * (kBN + 1);
  static constexpr size_t bytes = sizeof(long long) * kBN +
      sizeof(float) * (kQ + kK + kV + kP + 3 * BM) + sizeof(int) * 2 * (BM + kBN);
};

template <int BM, int D>
struct Tile {
  long long* koff;
  float* q;
  float* k;
  float* v;
  float* p;
  float* m;
  float* l;
  float* alpha;
  int* qpos;
  int* kpos;
  int* qseg;
  int* kseg;

  __device__ explicit Tile(char* base) {
    using S = TileSmem<BM, D>;
    koff = reinterpret_cast<long long*>(base);
    q = reinterpret_cast<float*>(koff + kBN);
    k = q + S::kQ;
    v = k + S::kK;
    p = v + S::kV;
    m = p + S::kP;
    l = m + BM;
    alpha = l + BM;
    qpos = reinterpret_cast<int*>(alpha + BM);
    kpos = qpos + BM;
    qseg = kpos + kBN;
    kseg = qseg + BM;
  }
};

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

// Scores of the current tile: s = (q . k) * scale where the key is live,
// kpos <= qpos (causal) and, with seg, the key's segment id is the row's;
// kNegInf elsewhere.
template <int BM, int D>
__device__ __forceinline__ void tile_scores(const Tile<BM, D>& t, float scale, bool causal,
                                            bool seg = false) {
  constexpr int RPT = BM / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) s[i][0] = s[i][1] = 0.f;
  const float* k0 = t.k + tx * (D + 1);
  const float* k1 = t.k + (tx + 16) * (D + 1);
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float a = k0[d], b = k1[d];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float qv = t.q[(ty * RPT + i) * (D + 1) + d];
      s[i][0] = fmaf(qv, a, s[i][0]);
      s[i][1] = fmaf(qv, b, s[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int qp = t.qpos[r];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j;
      const int kp = t.kpos[c];
      const bool ok = kp != kNoPos && (!causal || kp <= qp) &&
                      (!seg || t.qseg[r] == t.kseg[c]);
      t.p[r * (kBN + 1) + c] = ok ? s[i][j] * scale : kNegInf;
    }
  }
}

// Online-softmax update of one tile; leaves the probabilities in t.p (cast
// through V's dtype first when ROUND_P, as the flash kernel does before its
// P.V product) and each row's rescale factor in t.alpha.
template <int BM, int D, bool ROUND_P, typename T>
__device__ __forceinline__ void tile_softmax(const Tile<BM, D>& t) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const float s = t.p[r * (kBN + 1) + lane];
    const float m_old = t.m[r];
    const float m_new = fmaxf(m_old, warp_max(s));
    float pr = s > kNegInf / 2 ? expf(s - m_new) : 0.f;
    const float sum = warp_sum(pr);
    if (ROUND_P) pr = to_f<T>(from_f<T>(pr));
    t.p[r * (kBN + 1) + lane] = pr;
    if (lane == 0) {
      const float a = expf(m_old - m_new);
      t.alpha[r] = a;
      t.l[r] = t.l[r] * a + sum;
      t.m[r] = m_new;
    }
  }
}

// acc = acc * alpha + P . V for the rows and columns this thread owns.
template <int BM, int D>
__device__ __forceinline__ void tile_pv(const Tile<BM, D>& t, float (&acc)[BM / 16][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const float a = t.alpha[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] *= a;
  }
#pragma unroll 4
  for (int n = 0; n < kBN; ++n) {
    float vv[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) vv[j] = t.v[n * D + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const float pr = t.p[(ty + 16 * i) * (kBN + 1) + n];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pr, vv[j], acc[i][j]);
    }
  }
}

template <int BM, int D>
__device__ __forceinline__ void tile_init(const Tile<BM, D>& t, float (&acc)[BM / 16][D / 16]) {
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
}

// Loads the kBN key/value rows named by t.koff into the tile (zeros for a
// slot past the live range).  The caller fills koff and kpos, then syncs.
template <int BM, int D, typename T>
__device__ __forceinline__ void tile_load_kv(const Tile<BM, D>& t, const T* __restrict__ k,
                                             const T* __restrict__ v) {
  for (int idx = threadIdx.x; idx < kBN * D; idx += kThreads) {
    const int n = idx / D, d = idx % D;
    const long long off = t.koff[n];
    float kv = 0.f, vv = 0.f;
    if (off >= 0) {
      kv = to_f<T>(k[off + d]);
      vv = to_f<T>(v[off + d]);
    }
    t.k[n * (D + 1) + d] = kv;
    t.v[n * D + d] = vv;
  }
}

// Writes acc / l for the rows this thread owns (zeros for a row that saw no
// live key).  out_off(r) is the element offset of row r's output, or -1 for a
// padding row that is not written.
template <int BM, int D, typename T, typename OffFn>
__device__ __forceinline__ void tile_store(const Tile<BM, D>& t, const float (&acc)[BM / 16][D / 16],
                                           T* __restrict__ out, OffFn out_off) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = ty + 16 * i;
    const long long off = out_off(r);
    if (off < 0) continue;
    const float l = t.l[r];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[off + tx + 16 * j] = from_f<T>(l == 0.f ? 0.f : acc[i][j] / l);
  }
}

}  // namespace dstt
