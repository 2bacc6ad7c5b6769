// Flash attention backward for Hopper tensor cores (sm_90a): the bodies that
// csrc/flash_bwd.cu runs for bfloat16 or float16 q/k/v/dO with head_dim 64
// or 128 (one instantiation per element type E; the wgmma products are
// .f32.bf16.bf16 or .f32.f16.f16, every sum f32).
//
// Replaces deepspeed_tpu/ops/attention_pallas.py::_bwd_dq_kernel (B2) and
// ::_bwd_dkv_kernel (B3) for the shapes of the Llama paths (bf16 or fp16,
// D = 128).
// Both recompute p = exp2(s * scale * log2(e) - lse * log2(e)) from the
// forward's lse [B, H, T] f32 and form ds = p * (dO . V^T - delta) * scale
// with delta [B, H, T] f32 = rowsum(O * dO), which B2 computes and writes
// for every row below T and B3 reads after it on one stream; causal or not,
// GQA read in place (query head h reads kv head h / (H / KV)), optional
// packed segment ids [B, T] (T == S), ragged T and S.  q, k, v and dO are
// read through 4-d tensor maps in their model layout [B, rows, heads, D], one
// box per 64-column half of D at 128-byte swizzle; rows past T and keys past
// S arrive as zeros.
//
// Bound on the H100: at the training shapes (T ~ 2k, D = 128) dQ is three
// products and dK/dV four, each ~2 T^2 H D / 2 flops, over O(T H D) bytes:
// far above the 295 flop/byte ridge, so both are bound by the tensor cores'
// 989 TFLOP/s.  The shape of both kernels is B1's (flash_fwd_sm90.cuh):
// blocks of 384 threads, warpgroup 2 a TMA producer, warpgroups 0 and 1
// consumers running wgmma (setmaxnreg moves registers to them), a ring of
// shared-memory stages on mbarriers, a persistent grid of at most one block
// per SM walking its items in a snake (without segment ids; with them one
// block per item, as B1).
//
// B2, dQ: an item is (b * h, 128 query rows), heaviest causal tiles first;
// each consumer owns 64 rows.  Q, dO (TMA, once per item), lse and delta
// (each thread's two rows) stay resident; K and V come through a ring of
// four stages of 64 keys.  delta is formed in the item's prologue, so no
// pass over O and dO runs before the kernel: the four lanes of a row pair
// (lane / 4) each sum f32(o) * f32(do) over a D/4-column slice of both rows,
// O read from global memory (the loads issued before the wait for Q and
// dO, so their latency hides behind it), dO from the swizzled shared tile,
// and the partial sums meet over lane bits 0 and 1 (__shfl_xor_sync), as
// (s0 + s1) + (s2 + s3); lane qc == 0 stores it.  O takes no shared memory
// (a 128 x 128 bf16 tile would bring DqSmem<128> to ~225 of 227 KB); the
// block's next item's O slices are prefetched into L2 during the sweep.  Per
// stage: S = Q K^T and
// dP = dO V^T are SS wgmma m64n64k16 (K and V K-major as loaded); p and ds
// are formed on the accumulator fragment; ds is rounded to E in registers
// (as the TPU kernel rounds it to K's dtype: in fp16 a |ds| past 65504
// becomes inf there and here) and is the register A operand
// of dQ += ds K, wgmma m64nDk16 with K read MN-major through the transpose
// bit.  64-key tiles keep the three accumulators (32 + 32 + 64 f32 at
// D = 128) under setmaxnreg's 232 registers.  A warpgroup skips a tile that
// lies wholly above its rows' diagonal.  This computes exactly what the
// reference computes, up to the order of the sums.
//
// B3, dK/dV: an item is (b * kv head, 64 keys), heaviest causal tiles first;
// K and V stay resident (TMA, once per item), and the block sweeps the G
// query heads of the group times the query tiles of 64 rows at or past the
// item's first key (causal) through a ring of four stages of Q, dO, and the
// rows' lse * log2(e) and delta (staged by the producer warp; +inf and 0
// past T, so those rows give p = 0).  The two consumers take the item's
// slots in turns (slot t to warpgroup t % 2), each for all 64 keys: S^T =
// K Q^T and dP^T = V dO^T are SS wgmma with the keys in M, lse and delta
// vary along N and are read per fragment column.  The reference multiplies
// f32 p and ds into dV and dK; the tensor cores take 16-bit operands.  In
// bf16, P and dS rounded alone leave dK and dV about a bf16 ulp of their
// largest values off the reference before the output's own rounding, past
// phase 6's gate.  So there P^T and dS^T are each split in registers into
// hi = bf16(x) and lo = bf16(x - hi), and both halves are register A
// operands of dV += P^T dO and dK += dS^T Q (dO and Q read MN-major): the
// f32 products recovered to ~2^-16, at 1.5x the plain algorithm's product
// work.  (A third part, the whole f32 significand, changed no result by
// more than the tensor cores' own summation order does, and cost 17 %.)
// In fp16, P and dS are rounded once, as the Pallas kernel does: that
// leaves dK and dV within the outputs' own fp16 rounding of the f64
// oracle, so each is one A operand and one product.  An |x| past 65504
// rounds to inf there as in the Pallas kernel, and the step overflows as
// on the reference, whose ds of that element rounds to inf in K's dtype
// before dQ += ds K.
// Each consumer holds the two f32 accumulators of its 64 keys (128
// registers at D = 128) beside S^T, dP^T and the four operand halves:
// setmaxnreg gives it 240 registers and the producer 24.  At the item's
// end the second warpgroup's partial sums go through shared memory, in
// fragment order, into the first one's, which stores dK and dV: the GQA
// head sum is taken in registers in a fixed order, with no atomics, so the
// result is deterministic.  64-key items make 256 items at T = 2047, KV = 8
// (causal work 1 to 32 query tiles per head); the snake over at most 132
// persistent blocks pairs heavy items with light ones, where 128-key items
// would leave 128 blocks whose longest sets the time at ~53 % fill.
//
// With segment ids (a second instantiation, so the plain causal sweep
// carries none of it) the producer's warp stages each tile's ids, marks a
// tile whose ids all lie outside the range of the item's ids as skipped
// (the consumers release it without a product), and marks whether the
// element mask must compare ids.  The element mask runs only on a tile that
// crosses the diagonal or S, or whose ids are mixed; a masked score is -inf
// and its p is 0.
#pragma once

#include "sm90_common.cuh"

namespace dstt {
namespace sm90 {

constexpr int kBwdThreads = 384;  // warpgroups 0, 1 consume; 2 produces
// B2: query rows per item (two consumers of 64), keys per stage, stages
constexpr int kDqRows = 128;
constexpr int kDqKeys = 64;
constexpr int kDqStages = 4;  // D = 128: Q + dO 64 KB + 4 x (K + V) 128 KB
// B3: keys per item, query rows per stage, stages (two per consumer)
constexpr int kKvKeys = 64;
constexpr int kKvRows = 64;
constexpr int kKvStages = 4;  // D = 128: K + V 32 KB + 4 x (Q + dO) 128 KB
// per-stage mark with segment ids: skipped, one id for all, ids to compare
constexpr int kSkip = 0, kOneId = 1, kMixed = 2;

template <int D>
struct DqSmem {
  static constexpr int kHalves = D / 64;
  // every [rows][64] half of 2-byte elements (bf16 or fp16): rows of 128
  // bytes, swizzled by TMA (128B mode)
  uint16_t q[kHalves][kDqRows * 64];
  uint16_t dout[kHalves][kDqRows * 64];
  uint16_t k[kDqStages][kHalves][kDqKeys * 64];
  uint16_t v[kDqStages][kHalves][kDqKeys * 64];
  int flag[kDqStages];
  int kseg[kDqStages][kDqKeys];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
};

template <int D>
struct KvSmem {
  static constexpr int kHalves = D / 64;
  uint16_t k[kHalves][kKvKeys * 64];
  uint16_t v[kHalves][kKvKeys * 64];
  uint16_t q[kKvStages][kHalves][kKvRows * 64];
  uint16_t dout[kKvStages][kHalves][kKvRows * 64];
  // one warpgroup's accumulator in fragment order: [register][thread]
  float red[D / 2][128];
  float lse[kKvStages][kKvRows];  // times log2(e); +inf past T
  float delta[kKvStages][kKvRows];
  int rseg[kKvStages][kKvRows];
  int flag[kKvStages];
  uint64_t kv_full;
  uint64_t kv_empty;
  uint64_t full[kKvStages];
  uint64_t empty[kKvStages];
};

template <typename Sm>
__device__ __forceinline__ Sm& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Sm*>(raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u));
}

// the two consumer warpgroups only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// two f32 values as hi + lo, each in bf16: hi = bf16(x), lo = bf16(x - hi)
// (the difference exact in f32), packed; hi . B + lo . B, summed in the f32
// accumulator, recovers the f32 product with a bf16 operand B to ~2^-16 of x
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2<__nv_bfloat16>(x0, x1);
  const float2 hf = unpack2<__nv_bfloat16>(hi);
  lo = pack2<__nv_bfloat16>(x0 - hf.x, x1 - hf.y);
}

// a 64 x 64 f32 fragment rounded to E as the register A operand of four
// k16 steps: registers 4 j .. 4 j + 3 are a[j / 2][2 (j % 2)] and the next
template <typename E>
__device__ __forceinline__ void to_frag(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][2 * (j % 2)] = pack2<E>(x[4 * j], x[4 * j + 1]);
    a[j / 2][2 * (j % 2) + 1] = pack2<E>(x[4 * j + 2], x[4 * j + 3]);
  }
}

// d = A . B^T over D for A, B [64 rows][D] K-major in swizzled halves
// `half_a` / `half_b` bytes apart
template <int D, typename E>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t half_a, uint32_t b,
                                         uint32_t half_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<E>(d, desc_sw128(a + (kk / 4) * half_a + (kk % 4) * 32, 16, 1024),
                 desc_sw128(b + (kk / 4) * half_b + (kk % 4) * 32, 16, 1024), kk > 0);
}

// d += A . B over 64 rows of B [64][D], B MN-major (the transpose bit): the
// 64-column halves of D are `half_b` bytes apart, each group of 8 rows 1024
template <int D, typename E>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], const uint32_t (&a)[4][4], uint32_t b,
                                         uint32_t half_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<D, E>(d, a[kk], desc_sw128(b + kk * 16 * 128, half_b, 1024));
}

// a warpgroup's [64 x D] f32 accumulator stored as rows of E: row(r) is the
// element offset of the thread's fragment row r, or -1 to skip it
template <int D, typename E, typename RowFn>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], E* out, int qc, RowFn row) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long off = row(r);
    if (off < 0) continue;
    E* p = out + off + 2 * qc;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack2<E>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ------------------------------------------------------------------ B2: dQ

// the 128-byte line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// acc + sum of f32(a_i) * f32(b_i) over 8 packed pairs of E, in column order
template <typename E>
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack2<E>(pa[i]);
    const float2 y = unpack2<E>(pb[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

template <int D, bool kSeg, typename E>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const E* __restrict__ o, const float* __restrict__ lse,
                         float* __restrict__ delta, const int* __restrict__ seg,
                         E* __restrict__ dq, int B, int T, int S, int H, int KV,
                         float scale, int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  DqSmem<D>& s = aligned_smem<DqSmem<D>>(smem_raw);
  constexpr uint32_t kHalfQ = kDqRows * 128, kHalfK = kDqKeys * 128;
  constexpr int kDeltaChunks = D / 32;  // 16-byte chunks of a lane's D/4 columns
  const int n_q = (T + kDqRows - 1) / kDqRows;
  const int items = n_q * B * H;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, 8);
    for (int i = 0; i < kDqStages; ++i) {
      // TMA bytes, and with segment ids the producer warp's staged ids
      mbar_init(&s.full[i], kSeg ? 1 + 32 : 1);
      mbar_init(&s.empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 256 + (kSeg ? 32 : 1)) {
      const int lane = threadIdx.x % 32;
      int slot = 0;
      for (int k = 0;; ++k) {
        const int w = item_index(k, items);
        if (w < 0) break;
        const Item item = item_at<kDqRows, kDqKeys>(w, n_q, B * H, H, S, causal);
        const int b = item.b, kvh = item.h / (H / KV);
        int qlo = INT_MAX, qhi = INT_MIN;
        if (kSeg) {
          for (int r = item.q0 + lane; r < min(item.q0 + kDqRows, T); r += 32) {
            const int id = seg[(long long)b * T + r];
            qlo = min(qlo, id);
            qhi = max(qhi, id);
          }
          qlo = warp_min(qlo);
          qhi = warp_max(qhi);
        }
        mbar_wait(&s.q_empty, (k & 1) ^ 1);  // the last item's Q and dO are done with
        if (lane == 0) {
          mbar_expect_tx(&s.q_full, 2 * kDqRows * D * 2);
          for (int hf = 0; hf < D / 64; ++hf) {
            tma_load_4d(s.q[hf], &map_q, &s.q_full, hf * 64, item.h, item.q0, b);
            tma_load_4d(s.dout[hf], &map_do, &s.q_full, hf * 64, item.h, item.q0, b);
          }
        }
        for (int it = 0; it < item.n_tiles; ++it, ++slot) {
          const int n0 = it * kDqKeys;
          int ks[kDqKeys / 32];
          int flag = kOneId;
          if (kSeg) {
            int klo = INT_MAX, khi = INT_MIN;
#pragma unroll
            for (int i = 0; i < kDqKeys / 32; ++i) {
              const int c = n0 + lane + 32 * i;
              ks[i] = c < S ? seg[(long long)b * S + c] : INT_MIN;
              if (c < S) {
                klo = min(klo, ks[i]);
                khi = max(khi, ks[i]);
              }
            }
            klo = warp_min(klo);
            khi = warp_max(khi);
            flag = (khi < qlo || klo > qhi) ? kSkip
                   : (qlo == qhi && klo == khi && klo == qlo) ? kOneId
                                                              : kMixed;
          }
          const int st = slot % kDqStages;
          mbar_wait(&s.empty[st], ((slot / kDqStages) & 1) ^ 1);
          if (kSeg) {
#pragma unroll
            for (int i = 0; i < kDqKeys / 32; ++i) s.kseg[st][lane + 32 * i] = ks[i];
          }
          if (lane == 0) {
            if (kSeg) s.flag[st] = flag;
            if (flag != kSkip) {
              mbar_expect_tx(&s.full[st], 2 * kDqKeys * D * 2);
              for (int hf = 0; hf < D / 64; ++hf) {
                tma_load_4d(s.k[st][hf], &map_k, &s.full[st], hf * 64, kvh, n0, b);
                tma_load_4d(s.v[st][hf], &map_v, &s.full[st], hf * 64, kvh, n0, b);
              }
            } else {
              mbar_arrive(&s.full[st]);
            }
          }
          if (kSeg) {
            __syncwarp();
            mbar_arrive(&s.full[st]);  // the warp's shared-memory writes are in
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int qc = lane % 4;
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_base = smem_u32(&s.q[0][0]) + wg * 64 * 128;
    const uint32_t do_base = smem_u32(&s.dout[0][0]) + wg * 64 * 128;
    float acc[D / 2], sc[32], dp[32];
    uint32_t da[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    int slot = 0;
    for (int k = 0;; ++k) {
      const int w = item_index(k, items);
      if (w < 0) break;
      const Item item = item_at<kDqRows, kDqKeys>(w, n_q, B * H, H, S, causal);
      const int b = item.b, h = item.h;
      const int wg_row0 = item.q0 + wg * 64;
      int row[2];
      float lse2[2], dlt[2];
      int qseg[2] = {0, 0};
      row[0] = wg_row0 + warp * 16 + lane / 4;
      row[1] = row[0] + 8;
      // this lane's D/4 columns of O in both rows, 16 bytes a load, in
      // flight while the producer's Q and dO arrive
      uint4 ov[2][kDeltaChunks];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4* src = reinterpret_cast<const uint4*>(
            o + (((long long)b * T + row[r]) * H + h) * D + qc * (D / 4));
#pragma unroll
        for (int j = 0; j < kDeltaChunks; ++j)
          ov[r][j] = row[r] < T ? src[j] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // rows past T read nothing: lse +inf gives them p = 0
        const bool in = row[r] < T;
        const long long off = ((long long)b * H + h) * T + row[r];
        lse2[r] = in ? lse[off] * kLog2e : INFINITY;
        if (kSeg) qseg[r] = in ? seg[(long long)b * T + row[r]] : -1;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      mbar_wait(&s.q_full, k & 1);
      // delta of both rows: dO's same columns from the shared tile (row n of
      // the item's 128, 16-byte chunk c of D at half c / 8, chunk c % 8
      // swizzled with n % 8), the four lanes' sums met over lane bits 0, 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = wg * 64 + warp * 16 + lane / 4 + 8 * r;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kDeltaChunks; ++j) {
          const int c = qc * kDeltaChunks + j;
          const uint4 d4 = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(s.dout[c / 8]) + n * 128 +
              (((c % 8) ^ (n % 8)) << 4));
          sum = dot8<E>(ov[r][j], d4, sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const bool in = row[r] < T;
        dlt[r] = in ? sum : 0.f;
        if (in && qc == 0) delta[((long long)b * H + h) * T + row[r]] = sum;
      }
      // the same slices of the block's next item into L2 while this one
      // sweeps, so that its O loads wait on L2, not device memory
      const int w_next = item_index(k + 1, items);
      if (w_next >= 0) {
        const Item nx = item_at<kDqRows, kDqKeys>(w_next, n_q, B * H, H, S, causal);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int nr = nx.q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
          if (nr < T)
            prefetch_l2(o + (((long long)nx.b * T + nr) * H + nx.h) * D + qc * (D / 4));
        }
      }
      for (int t = 0; t < item.n_tiles; ++t, ++slot) {
        const int st = slot % kDqStages;
        const int n0 = t * kDqKeys;
        mbar_wait(&s.full[st], (slot / kDqStages) & 1);
        const int flag = kSeg ? s.flag[st] : kOneId;
        // a tile wholly above this warpgroup's diagonal adds nothing
        if (flag != kSkip && !(causal && n0 > wg_row0 + 63)) {
          const uint32_t k_base = smem_u32(&s.k[st][0][0]);
          const uint32_t v_base = smem_u32(&s.v[st][0][0]);
          fence_regs(sc);
          fence_regs(dp);
          wgmma_fence();
          issue_ss<D, E>(sc, q_base, kHalfQ, k_base, kHalfK);
          issue_ss<D, E>(dp, do_base, kHalfQ, v_base, kHalfK);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          if (n0 + kDqKeys > S || (causal && n0 + kDqKeys - 1 > wg_row0) || flag == kMixed) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int r = (i >> 1) & 1;
              const int c = (i >> 2) * 8 + 2 * qc + (i & 1);
              bool dead = n0 + c >= S || (causal && n0 + c > row[r]);
              if (kSeg && flag == kMixed) dead = dead || s.kseg[st][c] != qseg[r];
              if (dead) sc[i] = -INFINITY;
            }
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
            dp[i] = p * (dp[i] - dlt[r]) * scale;
          }
          to_frag<E>(dp, da);
          fence_regs(acc);
          fence_regs(da);
          wgmma_fence();
          issue_rs<D, E>(acc, da, k_base, kHalfK);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(da);
        }
        __syncwarp();
        if (lane == 0) {
          if (t == item.n_tiles - 1) mbar_arrive(&s.q_empty);  // Q, dO free for the next item
          mbar_arrive(&s.empty[st]);                           // this warp is done with the stage
        }
      }
      store_rows<D, E>(acc, dq, qc, [&](int r) -> long long {
        return row[r] < T ? (((long long)b * T + row[r]) * H + h) * D : -1;
      });
    }
  }
}

// --------------------------------------------------------------- B3: dK/dV

struct KvItem {
  int b, kvh, k0, m_start, n_m, n_slots;
};

// Work item w (of n_k * B * KV): key tile w / (B * KV), the heaviest causal
// tiles (the first keys, seen by the most rows) first, and (b, kv head) =
// w % (B * KV); its slots are the G heads' query tiles of kKvRows rows from
// the tile's first key (causal) or from 0, head by head.
__device__ __forceinline__ KvItem kv_item_at(int w, int BKV, int KV, int T, int G, int causal) {
  KvItem it;
  const int bkv = w % BKV;
  it.b = bkv / KV;
  it.kvh = bkv % KV;
  it.k0 = (w / BKV) * kKvKeys;
  it.m_start = causal ? (it.k0 / kKvRows) * kKvRows : 0;
  it.n_m = max(0, (T - it.m_start + kKvRows - 1) / kKvRows);
  it.n_slots = G * it.n_m;
  return it;
}

template <int D, bool kSeg, typename E>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seg, E* __restrict__ dk, E* __restrict__ dv, int B, int T, int S, int H, int KV,
                          float scale, int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  KvSmem<D>& s = aligned_smem<KvSmem<D>>(smem_raw);
  constexpr uint32_t kHalfK = kKvKeys * 128, kHalfM = kKvRows * 128;
  constexpr uint32_t kStageM = (D / 64) * kHalfM;  // bytes of one stage's Q (or dO)
  const int G = H / KV;
  const int n_k = (S + kKvKeys - 1) / kKvKeys;
  const int items = n_k * B * KV;

  if (threadIdx.x == 0) {
    mbar_init(&s.kv_full, 1);
    mbar_init(&s.kv_empty, 8);
    for (int i = 0; i < kKvStages; ++i) {
      // TMA bytes (or a skipped slot's plain arrival) and the producer
      // warp's staged lse, delta and ids
      mbar_init(&s.full[i], 1 + 32);
      mbar_init(&s.empty[i], 4);  // one warpgroup consumes a slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      int slot = 0;
      for (int k = 0;; ++k) {
        const int w = item_index(k, items);
        if (w < 0) break;
        const KvItem item = kv_item_at(w, B * KV, KV, T, G, causal);
        const int b = item.b;
        int klo = INT_MAX, khi = INT_MIN;
        if (kSeg) {
          for (int c = item.k0 + lane; c < min(item.k0 + kKvKeys, S); c += 32) {
            const int id = seg[(long long)b * S + c];
            klo = min(klo, id);
            khi = max(khi, id);
          }
          klo = warp_min(klo);
          khi = warp_max(khi);
        }
        mbar_wait(&s.kv_empty, (k & 1) ^ 1);  // the last item's K and V are done with
        if (lane == 0) {
          mbar_expect_tx(&s.kv_full, 2 * kKvKeys * D * 2);
          for (int hf = 0; hf < D / 64; ++hf) {
            tma_load_4d(s.k[hf], &map_k, &s.kv_full, hf * 64, item.kvh, item.k0, b);
            tma_load_4d(s.v[hf], &map_v, &s.kv_full, hf * 64, item.kvh, item.k0, b);
          }
        }
        // slot t's rows: lane's two lse * log2(e), delta and ids (+inf, 0
        // and INT_MIN past T); each slot's are loaded while the one before
        // waits for its stage
        auto rows_of = [&](int t, float (&l2)[2], float (&dl)[2], int (&rs)[2]) {
          const int h = item.kvh * G + t / item.n_m;
          const int m0 = item.m_start + (t % item.n_m) * kKvRows;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = m0 + lane + 32 * i;
            const bool in = r < T;
            const long long off = ((long long)b * H + h) * T + r;
            l2[i] = in ? lse[off] * kLog2e : INFINITY;
            dl[i] = in ? delta[off] : 0.f;
            rs[i] = kSeg && in ? seg[(long long)b * T + r] : INT_MIN;
          }
        };
        float nl2[2], ndl[2];
        int nrs[2];
        if (item.n_slots > 0) rows_of(0, nl2, ndl, nrs);
        for (int t = 0; t < item.n_slots; ++t, ++slot) {
          const int h = item.kvh * G + t / item.n_m;
          const int m0 = item.m_start + (t % item.n_m) * kKvRows;
          const float l2[2] = {nl2[0], nl2[1]}, dl[2] = {ndl[0], ndl[1]};
          const int rs[2] = {nrs[0], nrs[1]};
          if (t + 1 < item.n_slots) rows_of(t + 1, nl2, ndl, nrs);
          int flag = kOneId;
          if (kSeg) {
            int qlo = INT_MAX, qhi = INT_MIN;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (m0 + lane + 32 * i < T) {
                qlo = min(qlo, rs[i]);
                qhi = max(qhi, rs[i]);
              }
            }
            qlo = warp_min(qlo);
            qhi = warp_max(qhi);
            flag = (khi < qlo || klo > qhi) ? kSkip
                   : (qlo == qhi && klo == khi && klo == qlo) ? kOneId
                                                              : kMixed;
          }
          const int st = slot % kKvStages;
          mbar_wait(&s.empty[st], ((slot / kKvStages) & 1) ^ 1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            s.lse[st][lane + 32 * i] = l2[i];
            s.delta[st][lane + 32 * i] = dl[i];
            if (kSeg) s.rseg[st][lane + 32 * i] = rs[i];
          }
          if (lane == 0) {
            s.flag[st] = flag;
            if (flag != kSkip) {
              mbar_expect_tx(&s.full[st], 2 * kKvRows * D * 2);
              for (int hf = 0; hf < D / 64; ++hf) {
                tma_load_4d(s.q[st][hf], &map_q, &s.full[st], hf * 64, h, m0, b);
                tma_load_4d(s.dout[st][hf], &map_do, &s.full[st], hf * 64, h, m0, b);
              }
            } else {
              mbar_arrive(&s.full[st]);
            }
          }
          __syncwarp();
          mbar_arrive(&s.full[st]);  // the warp's shared-memory writes are in
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = threadIdx.x % 32;
    const int qc = lane % 4;
    const float scale_log2 = scale * kLog2e;
    const uint32_t k_base = smem_u32(&s.k[0][0]);
    const uint32_t v_base = smem_u32(&s.v[0][0]);
    float ak[D / 2], av[D / 2], sc[32], dp[32];
    uint32_t pa[4][4], pl[4][4], dsa[4][4], dsl[4][4];  // hi and lo (bf16) parts
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    int slot = 0;
    for (int k = 0;; ++k) {
      const int w = item_index(k, items);
      if (w < 0) break;
      const KvItem item = kv_item_at(w, B * KV, KV, T, G, causal);
      const int b = item.b;
      int key[2], kseg[2] = {0, 0};
      key[0] = item.k0 + warp * 16 + lane / 4;
      key[1] = key[0] + 8;
      if (kSeg) {
#pragma unroll
        for (int r = 0; r < 2; ++r) kseg[r] = key[r] < S ? seg[(long long)b * S + key[r]] : -1;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;
      mbar_wait(&s.kv_full, k & 1);
      for (int t = 0; t < item.n_slots; ++t, ++slot) {
        if ((t & 1) != wg) continue;  // the other warpgroup's slot
        const int st = slot % kKvStages;
        const int m0 = item.m_start + (t % item.n_m) * kKvRows;
        mbar_wait(&s.full[st], (slot / kKvStages) & 1);
        const int flag = kSeg ? s.flag[st] : kOneId;
        if (flag != kSkip) {
          const uint32_t q_st = smem_u32(&s.q[0][0][0]) + st * kStageM;
          const uint32_t do_st = smem_u32(&s.dout[0][0][0]) + st * kStageM;
          fence_regs(sc);
          fence_regs(dp);
          wgmma_fence();
          issue_ss<D, E>(sc, k_base, kHalfK, q_st, kHalfM);
          issue_ss<D, E>(dp, v_base, kHalfK, do_st, kHalfM);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          // keys in rows, query rows in columns: the causal mask only on
          // the tile at the diagonal; rows past T have lse +inf (p = 0)
          if ((causal && m0 < item.k0 + kKvKeys - 1) || flag == kMixed) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int r = (i >> 1) & 1;
              const int c = (i >> 2) * 8 + 2 * qc + (i & 1);
              bool dead = causal && m0 + c < key[r];
              if (kSeg && flag == kMixed) dead = dead || s.rseg[st][c] != kseg[r];
              if (dead) sc[i] = -INFINITY;
            }
          }
          // p and ds as A operands as they come (registers 4 j .. 4 j + 3
          // hold columns 8 j + 2 qc and the next): in bf16 split into hi
          // and lo, in fp16 rounded once
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(&s.lse[st][8 * j + 2 * qc]);
            const float2 dl = *reinterpret_cast<const float2*>(&s.delta[st][8 * j + 2 * qc]);
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e;
              p[e] = ex2(fmaf(sc[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
              ds[e] = p[e] * (dp[i] - ((e & 1) ? dl.y : dl.x)) * scale;
            }
            const int a = j / 2, e = 2 * (j % 2);
            if constexpr (kIsHalf<E>) {
              pa[a][e] = pack2<E>(p[0], p[1]);
              pa[a][e + 1] = pack2<E>(p[2], p[3]);
              dsa[a][e] = pack2<E>(ds[0], ds[1]);
              dsa[a][e + 1] = pack2<E>(ds[2], ds[3]);
            } else {
              split2(p[0], p[1], pa[a][e], pl[a][e]);
              split2(p[2], p[3], pa[a][e + 1], pl[a][e + 1]);
              split2(ds[0], ds[1], dsa[a][e], dsl[a][e]);
              split2(ds[2], ds[3], dsa[a][e + 1], dsl[a][e + 1]);
            }
          }
          fence_regs(av);
          fence_regs(ak);
          fence_regs(pa);
          fence_regs(dsa);
          if constexpr (!kIsHalf<E>) {
            fence_regs(pl);
            fence_regs(dsl);
          }
          wgmma_fence();
          issue_rs<D, E>(av, pa, do_st, kHalfM);
          if constexpr (!kIsHalf<E>) issue_rs<D, E>(av, pl, do_st, kHalfM);
          issue_rs<D, E>(ak, dsa, q_st, kHalfM);
          if constexpr (!kIsHalf<E>) issue_rs<D, E>(ak, dsl, q_st, kHalfM);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(av);
          fence_regs(ak);
          fence_regs(pa);
          fence_regs(dsa);
          if constexpr (!kIsHalf<E>) {
            fence_regs(pl);
            fence_regs(dsl);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);  // this warp is done with the stage
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.kv_empty);  // K, V free for the next item
      // the GQA and query-tile sum: warpgroup 1's partials into warpgroup
      // 0's, through shared memory in fragment order (no atomics)
      consumers_sync();  // the last item's reads of `red` are done
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) s.red[i][tid] = av[i];
      }
      consumers_sync();
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) av[i] += s.red[i][tid];
      }
      consumers_sync();
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) s.red[i][tid] = ak[i];
      }
      consumers_sync();
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) ak[i] += s.red[i][tid];
        auto row = [&](int r) -> long long {
          return key[r] < S ? (((long long)b * S + key[r]) * KV + item.kvh) * D : -1;
        };
        store_rows<D, E>(ak, dk, qc, row);
        store_rows<D, E>(av, dv, qc, row);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

struct Maps {
  CUtensorMap q, k, v, dout;
};

// q and dO [B, T, H, D] in boxes of `q_rows`, k and v [B, S, KV, D] in boxes
// of `k_rows`, all of element type `dt`
inline cudaError_t encode_bwd_maps(Maps* m, const void* q, const void* k, const void* v,
                                   const void* dout, int B, int T, int S, int H, int KV, int D,
                                   int q_rows, int k_rows, CUtensorMapDataType dt) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (!encode_rows(fn, &m->q, q, B, T, H, D, q_rows, dt) ||
      !encode_rows(fn, &m->dout, dout, B, T, H, D, q_rows, dt) ||
      !encode_rows(fn, &m->k, k, B, S, KV, D, k_rows, dt) ||
      !encode_rows(fn, &m->v, v, B, S, KV, D, k_rows, dt))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// without segment ids at most one block per SM, each walking its share of
// the items in a snake; with them one block per item (as B1)
inline cudaError_t bwd_grid(long long items, bool has_seg, unsigned* grid) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *grid = (unsigned)(has_seg ? items : min(items, (long long)sms));
  return cudaSuccess;
}

template <int D, typename E>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, const int* seg,
                          void* dq, int B, int T, int S, int H, int KV, float scale, int causal,
                          cudaStream_t stream) {
  Maps m;
  cudaError_t err =
      encode_bwd_maps(&m, q, k, v, dout, B, T, S, H, KV, D, kDqRows, kDqKeys, tma_dtype<E>());
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(DqSmem<D>) + 1024;  // + room to align the base to 1024
  auto kern =
      seg ? flash_bwd_dq_sm90_kernel<D, true, E> : flash_bwd_dq_sm90_kernel<D, false, E>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned grid = 0;
  err = bwd_grid((long long)((T + kDqRows - 1) / kDqRows) * B * H, seg != nullptr, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBwdThreads, smem, stream>>>(m.q, m.k, m.v, m.dout, static_cast<const E*>(o), lse,
                                            delta, seg, static_cast<E*>(dq), B, T, S, H, KV,
                                            scale, causal);
  return cudaGetLastError();
}

template <int D, typename E>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const int* seg, void* dk,
                           void* dv, int B, int T, int S, int H, int KV, float scale, int causal,
                           cudaStream_t stream) {
  Maps m;
  cudaError_t err =
      encode_bwd_maps(&m, q, k, v, dout, B, T, S, H, KV, D, kKvRows, kKvKeys, tma_dtype<E>());
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(KvSmem<D>) + 1024;
  auto kern =
      seg ? flash_bwd_dkv_sm90_kernel<D, true, E> : flash_bwd_dkv_sm90_kernel<D, false, E>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned grid = 0;
  err = bwd_grid((long long)((S + kKvKeys - 1) / kKvKeys) * B * KV, seg != nullptr, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBwdThreads, smem, stream>>>(m.q, m.k, m.v, m.dout, lse, delta, seg,
                                            static_cast<E*>(dk), static_cast<E*>(dv), B, T, S, H,
                                            KV, scale, causal);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace dstt
