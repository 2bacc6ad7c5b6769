// Flash attention forward for Hopper tensor cores (sm_90a): the body that
// csrc/flash_fwd.cu runs for bfloat16 or float16 q/k/v with head_dim 64 or
// 128 (one instantiation per element type E).
//
// Replaces deepspeed_tpu/ops/attention_pallas.py::_fwd_kernel for the
// shapes of the Llama paths (bf16 or fp16, D = 128).  It computes what the
// scalar body of flash_fwd.cu computes: o [B, T, H, D] in E and lse
// [B, H, T] f32 (natural log, m + log l), causal or not, GQA read in place
// (query head h reads kv head h / (H / KV)), optional packed segment ids
// [B, T], ragged T and S, p rounded to E before P.V, zeros for a row that
// sees no key.  The same wgmma runs both types (.f32.bf16.bf16 or
// .f32.f16.f16); fp16's top of 65504 cannot bite here: p lies in [0, 1]
// and |o| <= max |v|.
//
// Bound on the H100: at the prefill and training shapes (T = 1k to 2k,
// D = 128) the two products are ~4 T^2 H D / 2 flops over O(T H D) bytes,
// far above the card's 295 flop/byte ridge, so the kernel is bound by the
// tensor cores' 989 TFLOP/s, and whatever keeps them idle (loads, softmax,
// barriers) is what it loses.  The design:
//
//  - Blocks of 384 threads work on items of (b * h, 128 query rows),
//    heaviest causal items first; without segment ids a block stays on its
//    SM and takes item after item, so the next item's loads overlap the
//    last one's final products and stores.  Warpgroup 2 is the producer:
//    one thread keeps a ring of two stages of K and V tiles of 128 keys
//    full by TMA, each stage completed on its own mbarriers, and loads Q
//    once per item.  q, k and v are read through 4-d tensor maps in their
//    model layout [B, rows, heads, D], one box per 64-column half of D at
//    128-byte swizzle, so nothing is transposed or repeated in memory; rows
//    past T or S arrive as zeros.
//  - Warpgroups 0 and 1 are consumers, 64 query rows each (setmaxnreg
//    moves registers from the producer to them).  S = Q K^T is one chain of
//    wgmma m64n128k16 from shared memory (K is K-major as loaded); the
//    online softmax runs on the f32 accumulator fragment (a row lives in the
//    four threads of a quad), with the scale folded into exp2; P is rounded
//    to E in registers and is the register A operand of O += P V, wgmma
//    m64nDk16 with V read MN-major through the descriptor's transpose bit.
//    Each consumer warp releases a stage on a second mbarrier once its
//    P V is done.  (Issuing one tile's Q K^T with the last tile's P V, and
//    making the two warpgroups take turns at the tensor cores, measured no
//    faster on the H100 at these shapes; PERF.md has the numbers.)
//  - Key tiles above the diagonal are never loaded.  With segment ids (a
//    second instantiation, so the plain causal sweep carries none of it) the
//    producer's whole warp stages each tile's key ids and their range in
//    shared memory and skips a tile whose ids all lie outside the range of
//    the item's rows' ids (it would add nothing).  Only a tile that crosses
//    the diagonal or S, or where a thread's rows and the tile's keys do not
//    all share one id, takes the element mask; a masked score is -inf, and a
//    row whose every key so far is masked keeps m = -inf and gets p = 0.
#pragma once

#include "sm90_common.cuh"

namespace dstt {
namespace sm90 {

constexpr int kBM = 128;        // query rows per block (two consumers of 64)
constexpr int kBN = 128;        // keys per stage
constexpr int kStages = 2;  // D = 128: Q 32 KB + 2 x (K + V) 64 KB = 160 KB
constexpr int kThreads = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumerWarps = 8;
constexpr float kEmptyLse = -1e30f;  // lse of a row that sees no key

template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  // every [rows][64] half of 2-byte elements (bf16 or fp16): rows of 128
  // bytes, swizzled by TMA (128B mode); each half is a multiple of 1024
  // bytes, so all stay 1024-aligned
  uint16_t q[kHalves][kBM * 64];
  uint16_t k[kStages][kHalves][kBN * 64];
  uint16_t v[kStages][kHalves][kBN * 64];
  // per stage: the key tile it holds (-1: the sweep is over) and, with
  // segment ids, the keys' ids and their range
  int tile[kStages];
  int2 krange[kStages];
  int kseg[kStages][kBN];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

// S's accumulator fragment turns into P's A operand in place (the fragment
// layouts are in sm90_common.cuh).
template <int D, bool kSeg, typename E>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const int* __restrict__ seg,
                      E* __restrict__ o, float* __restrict__ lse, int B, int T,
                      int S, int H, int KV, float scale, int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  constexpr uint32_t kHalfQ = kBM * 128, kHalfKV = kBN * 128;  // bytes of one 64-col half
  const int n_q = (T + kBM - 1) / kBM;
  const int items = n_q * B * H;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, kConsumerWarps);
    for (int i = 0; i < kStages; ++i) {
      // TMA bytes, and with segment ids the producer warp's staged ids
      mbar_init(&s.k_full[i], kSeg ? 1 + 32 : 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full; with segment ids
    // its whole first warp, which also stages each tile's ids
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 256 + (kSeg ? 32 : 1)) {
      const int lane = threadIdx.x % 32;
      int slot = 0;
      for (int k = 0;; ++k) {
        const int w = item_index(k, items);
        if (w < 0) break;
        const Item item = item_at<kBM, kBN>(w, n_q, B * H, H, S, causal);
        const int b = item.b, kvh = item.h / (H / KV);
        // the range of the tile's rows' segment ids; a key tile whose ids
        // lie outside it holds no key any row sees and is skipped
        int qlo = INT_MAX, qhi = INT_MIN;
        if (kSeg) {
          for (int r = item.q0 + lane; r < min(item.q0 + kBM, T); r += 32) {
            const int id = seg[(long long)b * T + r];
            qlo = min(qlo, id);
            qhi = max(qhi, id);
          }
          qlo = warp_min(qlo);
          qhi = warp_max(qhi);
        }
        mbar_wait(&s.q_empty, (k & 1) ^ 1);  // the last item's Q is done with
        if (lane == 0) {
          mbar_expect_tx(&s.q_full, kBM * D * 2);
          for (int hf = 0; hf < D / 64; ++hf)
            tma_load_4d(s.q[hf], &map_q, &s.q_full, hf * 64, item.h, item.q0, b);
        }
        for (int it = 0; it < item.n_tiles; ++it) {
          const int n0 = it * kBN;
          int ks[kBN / 32];
          int klo = INT_MAX, khi = INT_MIN;
          if (kSeg) {
#pragma unroll
            for (int i = 0; i < kBN / 32; ++i) {
              const int c = n0 + lane + 32 * i;
              ks[i] = c < S ? seg[(long long)b * S + c] : INT_MIN;
              if (c < S) {
                klo = min(klo, ks[i]);
                khi = max(khi, ks[i]);
              }
            }
            klo = warp_min(klo);
            khi = warp_max(khi);
            if (khi < qlo || klo > qhi) continue;
          }
          const int st = slot % kStages;
          mbar_wait(&s.empty[st], ((slot / kStages) & 1) ^ 1);
          if (kSeg) {
#pragma unroll
            for (int i = 0; i < kBN / 32; ++i) s.kseg[st][lane + 32 * i] = ks[i];
          }
          if (lane == 0) {
            if (kSeg) {
              s.tile[st] = it;
              s.krange[st] = make_int2(klo, khi);
            }
            mbar_expect_tx(&s.k_full[st], kBN * D * 2);
            for (int hf = 0; hf < D / 64; ++hf)
              tma_load_4d(s.k[st][hf], &map_k, &s.k_full[st], hf * 64, kvh, n0, b);
            mbar_expect_tx(&s.v_full[st], kBN * D * 2);
            for (int hf = 0; hf < D / 64; ++hf)
              tma_load_4d(s.v[st][hf], &map_v, &s.v_full[st], hf * 64, kvh, n0, b);
          }
          if (kSeg) {
            __syncwarp();
            mbar_arrive(&s.k_full[st]);  // the warp's shared-memory writes are in
          }
          ++slot;
        }
        if (kSeg) {
          // the item's end marker: one more slot whose tile is -1; its V
          // barrier completes too, so every stage's barriers keep counting
          // slots in step
          const int st = slot % kStages;
          mbar_wait(&s.empty[st], ((slot / kStages) & 1) ^ 1);
          if (lane == 0) {
            s.tile[st] = -1;
            mbar_arrive(&s.v_full[st]);
            mbar_arrive(&s.k_full[st]);
          }
          __syncwarp();
          mbar_arrive(&s.k_full[st]);
          ++slot;
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int qc = lane % 4;
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_base = smem_u32(&s.q[0][0]) + wg * 64 * 128;
    float acc[D / 2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    int row[2] = {0, 0}, qseg[2] = {0, 0};
    int wg_row0 = 0;

    // S = Q K^T of the tile in stage `st` (unscaled), 64 x 128 for this
    // warpgroup; K is K-major as loaded, the k16 slices 32 bytes apart
    // inside a 128-byte row
    auto issue_qk = [&](float (&sc)[kBN / 2], int st) {
      const uint32_t k_base = smem_u32(&s.k[st][0][0]);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128<E>(sc, desc_sw128(q_base + (kk / 4) * kHalfQ + (kk % 4) * 32, 16, 1024),
                      desc_sw128(k_base + (kk / 4) * kHalfKV + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // O += P V of the tile in stage `st`, V MN-major: the two 64-column
    // halves of D are LBO apart, each group of 8 keys SBO = 1024 bytes apart
    auto issue_pv = [&](const uint32_t (&pa)[kBN / 16][4], int st) {
      const uint32_t v_base = smem_u32(&s.v[st][0][0]);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<D, E>(acc, pa[kk], desc_sw128(v_base + kk * 16 * 128, kHalfKV, 1024));
      wgmma_commit();
    };
    // the element mask, only where a tile crosses the diagonal or S (TMA
    // fills keys past S with zeros: score 0, not -inf) or where this
    // thread's rows and the tile's keys do not all share one segment id;
    // then the online softmax on the fragment: a row's 128 scores sit in 32
    // registers of each of the four threads of a quad.  Leaves p (f32) in
    // sc and the row's rescale factor in alpha.
    auto softmax = [&](float (&sc)[kBN / 2], float (&alpha)[2], int st, int n0) {
      bool mixed = false, row_out[2] = {false, false};
      if (kSeg) {
        const int2 kr = s.krange[st];
        mixed = kr.x != kr.y;
#pragma unroll
        for (int r = 0; r < 2; ++r) row_out[r] = !mixed && qseg[r] != kr.x;
      }
      if (n0 + kBN > S || (causal && n0 + kBN - 1 > wg_row0) || mixed || row_out[0] ||
          row_out[1]) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int c = (i >> 2) * 8 + 2 * qc + (i & 1);
          bool dead = n0 + c >= S || (causal && n0 + c > row[r]) || row_out[r];
          if (kSeg && mixed) dead = dead || s.kseg[st][c] != qseg[r];
          if (dead) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no live key yet keeps m = -inf; its p = exp2(-inf) = 0
        ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
        alpha[r] = ex2(m[r] * scale_log2 - ms[r]);
        m[r] = mx[r];
      }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -ms[r]));
        rsum[r] += sc[i];
      }
      // l stays a per-thread partial sum until the end (alpha is the row's)
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
    };
    // p rounded to E (round to nearest even) as the register A operand
    auto to_frag = [&](const float (&sc)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = pack2<E>(sc[kk * 8 + 2 * j], sc[kk * 8 + 2 * j + 1]);
    };

    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    uint32_t pa[kBN / 16][4];
    float alpha[2];
    int slot = 0;
    for (int k = 0;; ++k) {
      const int w = item_index(k, items);
      if (w < 0) break;
      const Item item = item_at<kBM, kBN>(w, n_q, B * H, H, S, causal);
      const int b = item.b, h = item.h;
      wg_row0 = item.q0 + wg * 64;
      row[0] = wg_row0 + warp * 16 + lane / 4;
      row[1] = row[0] + 8;
      if (kSeg) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          qseg[r] = row[r] < T ? seg[(long long)b * T + row[r]] : -1;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
      }
      mbar_wait(&s.q_full, k & 1);
      // The ring's slots come in order.  Without segment ids the item's
      // tiles fill its next n_tiles slots; with them each slot names its
      // tile, and the producer ends the item with a slot of tile -1 (every
      // item has a live tile: a row sees its own key).
      for (int t = 0;; ++t, ++slot) {
        if (!kSeg && t == item.n_tiles) break;
        const int st = slot % kStages;
        const uint32_t ph = (slot / kStages) & 1;
        mbar_wait(&s.k_full[st], ph);
        int tile = t;
        if (kSeg) {
          tile = s.tile[st];
          if (tile < 0) {  // the end marker: release its stage and move on
            __syncwarp();
            if (lane == 0) mbar_arrive(&s.empty[st]);
            ++slot;
            break;
          }
        }
        fence_regs(sc);
        wgmma_fence();
        issue_qk(sc, st);
        wgmma_wait<0>();
        fence_regs(sc);
        if (!kSeg && t == item.n_tiles - 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&s.q_empty);  // Q is free for the next item
        }
        softmax(sc, alpha, st, tile * kBN);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        to_frag(sc, pa);
        mbar_wait(&s.v_full[st], ph);
        fence_regs(acc);
        fence_regs(pa);
        wgmma_fence();
        issue_pv(pa, st);
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);  // this warp is done with the stage
      }
      if (kSeg) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.q_empty);
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= T) continue;  // rows past T are neither stored nor given an lse
        E* orow = o + (((long long)b * T + row[r]) * H + h) * D + 2 * qc;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float a0 = l[r] == 0.f ? 0.f : acc[4 * j + 2 * r] / l[r];
          const float a1 = l[r] == 0.f ? 0.f : acc[4 * j + 2 * r + 1] / l[r];
          *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack2<E>(a0, a1);
        }
        if (qc == 0)
          lse[((long long)b * H + h) * T + row[r]] =
              l[r] == 0.f ? kEmptyLse : m[r] * scale + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

template <int D, typename E>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* o, void* lse,
                   int B, int T, int S, int H, int KV, float scale, int causal,
                   cudaStream_t stream) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  constexpr CUtensorMapDataType dt = tma_dtype<E>();
  if (!encode_rows(fn, &mq, q, B, T, H, D, kBM, dt) ||
      !encode_rows(fn, &mk, k, B, S, KV, D, kBN, dt) ||
      !encode_rows(fn, &mv, v, B, S, KV, D, kBN, dt))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
  auto kern = seg ? flash_fwd_sm90_kernel<D, true, E> : flash_fwd_sm90_kernel<D, false, E>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // without segment ids at most one block per SM, each walking its share of
  // the work items; with them one block per item, so the hardware's
  // scheduler balances the items that the segment skip makes unequal
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((T + kBM - 1) / kBM) * B * H;
  const unsigned grid = (unsigned)(seg ? items : min(items, (long long)sms));
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, seg, static_cast<E*>(o),
                                         static_cast<float*>(lse), B, T, S, H, KV, scale, causal);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace dstt
