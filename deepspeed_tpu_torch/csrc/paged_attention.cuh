// Scalar paged attention block shared by the three paged kernels of the
// port:
//   paged_attention.cu        B5, dense pages (_chunk_v2_kernel), for
//                             float32 and head_dim 16 / 32
//   paged_attention_quant.cu  B7, int8 codes x per-row f32 scales
//                             (_chunk_v2_quant_kernel), for a float32 q and
//                             head_dim 16 / 32
//   paged_attention_split.cu  B8, dense pages over a split key axis plus a
//                             combine pass (_chunk_kernel, the v1 arm)
// A bfloat16 q with head_dim 64 or 128 takes B5's and B7's Hopper body
// (paged_attention_sm90.cuh) instead.
//
// q [B, C, H, D] sits at positions start[b] + c; one layer's pages
// [KV, P, ps, D] (codes, with scales [KV, P, ps, 1], for B7); table [B, mp]
// int32 maps a row's page slot to a physical page.  Each query attends
// causally (kpos <= qpos) over the keys its row's pages hold; a row with no
// such key (start = -1, an empty decode row) gives zeros.
//
// The TPU ran one program per (b, kv_head) with all C*G rows in VMEM.  Here
// the grid is (b*KV, tile of BM flattened rows[, key split]), row r of the
// C*G rows being query position r / G of head kvh*G + r % G, so a C = 256,
// G = 4 chunk spreads over many blocks.  Each block reads the table itself
// and walks only the key positions < start + (last row's c) + 1 (clamped to
// mp*ps): table entries past that frontier may be stale or point at the
// trash page and are never dereferenced.  K and V land in shared memory in
// f32 and the online softmax is f32 (attention_tile.cuh), as in the TPU
// kernels.
#pragma once

#include "attention_tile.cuh"

namespace dstt {

// Dense K/V pages in the storage type T.
template <typename T>
struct DenseKV {
  const T* k;
  const T* v;

  template <int BM, int D>
  __device__ __forceinline__ void load(const Tile<BM, D>& t) const {
    tile_load_kv(t, k, v);
  }
};

// int8 codes with one f32 scale per token row (the kv_tier codec): each
// thread reads 4 codes of K and of V with one 4-byte load and the row's two
// scales once for them, and writes code * scale in f32 to the tile, the
// dequantisation of _chunk_v2_quant_kernel (f32(code) * scale, in f32).
struct Int8KV {
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;

  template <int BM, int D>
  __device__ __forceinline__ void load(const Tile<BM, D>& t) const {
    constexpr int V4 = D / 4;
    for (int idx = threadIdx.x; idx < kBN * V4; idx += kThreads) {
      const int n = idx / V4, d = (idx % V4) * 4;
      const long long off = t.koff[n];
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (off >= 0) {
        const char4 kc = *reinterpret_cast<const char4*>(k + off + d);
        const char4 vc = *reinterpret_cast<const char4*>(v + off + d);
        const float sk = ks[off / D], sv = vs[off / D];
        kx[0] = static_cast<float>(kc.x) * sk;
        kx[1] = static_cast<float>(kc.y) * sk;
        kx[2] = static_cast<float>(kc.z) * sk;
        kx[3] = static_cast<float>(kc.w) * sk;
        vx[0] = static_cast<float>(vc.x) * sv;
        vx[1] = static_cast<float>(vc.y) * sv;
        vx[2] = static_cast<float>(vc.z) * sv;
        vx[3] = static_cast<float>(vc.w) * sv;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        t.k[n * (D + 1) + d + e] = kx[e];
        t.v[n * D + d + e] = vx[e];
      }
    }
  }
};

// Without SPLIT a block sweeps every live key and writes the normalised
// output.  With SPLIT, blockIdx.z picks the keys [z * split_keys, (z + 1) *
// split_keys) of the live range and the block writes its unnormalised
// partial (m, l, acc) at row ((b*KV + kvh) * nsplit + z) * C*G + f of
// part_m / part_l / part_acc; a split wholly past the frontier writes
// m = kNegInf, l = 0, acc = 0.
template <typename T, int BM, int D, typename KVSrc, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, KVSrc kv, const int* __restrict__ table,
                       const int* __restrict__ start, T* __restrict__ out,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int C, int H, int KV, int P, int ps,
                       int mp, int split_keys, float scale) {
  extern __shared__ __align__(16) char smem[];
  Tile<BM, D> t(smem);
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int CG = C * G;
  const int r0 = blockIdx.y * BM;
  const int st = start[b];

  for (int idx = threadIdx.x; idx < BM * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int f = r0 + r;
    float x = 0.f;
    if (f < CG) {
      const int c = f / G, h = kvh * G + f % G;
      x = to_f<T>(q[(((long long)b * C + c) * H + h) * D + d]);
    }
    t.q[r * (D + 1) + d] = x;
  }
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int f = r0 + r;
    t.qpos[r] = f < CG ? st + f / G : -1;
  }
  float acc[BM / 16][D / 16];
  tile_init(t, acc);

  // live key positions for this block: 0 .. start + c_last
  const int c_last = (min(r0 + BM, CG) - 1) / G;
  const int live = min(st + c_last + 1, mp * ps);
  const int k_lo = SPLIT ? blockIdx.z * split_keys : 0;
  const int k_hi = SPLIT ? min(live, k_lo + split_keys) : live;
  const int* row_table = table + (long long)b * mp;
  for (int n0 = k_lo; n0 < k_hi; n0 += kBN) {
    __syncthreads();  // previous tile fully consumed
    for (int n = threadIdx.x; n < kBN; n += kThreads) {
      const int pos = n0 + n;
      if (pos < k_hi) {
        const int page = row_table[pos / ps];
        t.kpos[n] = pos;
        t.koff[n] = (((long long)kvh * P + page) * ps + pos % ps) * D;
      } else {
        t.kpos[n] = kNoPos;
        t.koff[n] = -1;
      }
    }
    __syncthreads();
    kv.load(t);
    __syncthreads();
    tile_scores(t, scale, true);
    __syncthreads();
    tile_softmax<BM, D, false, T>(t);
    __syncthreads();
    tile_pv(t, acc);
  }
  __syncthreads();
  if (SPLIT) {
    const long long prow = ((long long)blockIdx.x * gridDim.z + blockIdx.z) * CG + r0;
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      if (r0 + r < CG) {
        part_m[prow + r] = t.m[r];
        part_l[prow + r] = t.l[r];
      }
    }
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int r = ty + 16 * i;
      if (r0 + r >= CG) continue;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) part_acc[(prow + r) * D + tx + 16 * j] = acc[i][j];
    }
    return;
  }
  tile_store(t, acc, out, [&](int r) -> long long {
    const int f = r0 + r;
    if (f >= CG) return -1;
    const int c = f / G, h = kvh * G + f % G;
    return (((long long)b * C + c) * H + h) * D;
  });
}

// Host-side arguments of one paged launch.
struct PagedArgs {
  const void* q;
  const void* table;
  const void* start;
  void* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, C, H, KV, P, ps, mp, split_keys, nsplit;
  float scale;
};

template <typename T, int BM, int D, typename KVSrc, bool SPLIT>
cudaError_t launch_paged(const PagedArgs& a, KVSrc kv, cudaStream_t stream) {
  const size_t smem = TileSmem<BM, D>::bytes;
  auto kern = paged_attention_kernel<T, BM, D, KVSrc, SPLIT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int CG = a.C * (a.H / a.KV);
  dim3 grid(a.B * a.KV, (CG + BM - 1) / BM, SPLIT ? a.nsplit : 1);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), kv, static_cast<const int*>(a.table),
      static_cast<const int*>(a.start), static_cast<T*>(a.out), a.part_m, a.part_l, a.part_acc,
      a.C, a.H, a.KV, a.P, a.ps, a.mp, a.split_keys, a.scale);
  return cudaGetLastError();
}

// Row tile: 16 rows when the C*G rows fit (decode), 64 otherwise.
template <typename T, int D, typename KVSrc, bool SPLIT>
cudaError_t dispatch_rows(const PagedArgs& a, KVSrc kv, cudaStream_t s) {
  if (a.C * (a.H / a.KV) <= 16) return launch_paged<T, 16, D, KVSrc, SPLIT>(a, kv, s);
  return launch_paged<T, 64, D, KVSrc, SPLIT>(a, kv, s);
}

template <typename T, typename KVSrc, bool SPLIT>
cudaError_t dispatch_paged(const PagedArgs& a, int D, KVSrc kv, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_rows<T, 16, KVSrc, SPLIT>(a, kv, s);
    case 32: return dispatch_rows<T, 32, KVSrc, SPLIT>(a, kv, s);
    case 64: return dispatch_rows<T, 64, KVSrc, SPLIT>(a, kv, s);
    case 128: return dispatch_rows<T, 128, KVSrc, SPLIT>(a, kv, s);
    default: return cudaErrorInvalidValue;
  }
}

inline bool paged_shape_ok(int B, int C, int H, int KV, int ps, int mp) {
  return B > 0 && C > 0 && KV > 0 && H % KV == 0 && ps > 0 && mp > 0;
}

}  // namespace dstt
