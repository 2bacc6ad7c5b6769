// Flash attention forward for Hopper tensor cores (sm_90a): the body that
// csrc/flash_fwd.cu runs for bfloat16 q/k/v with head_dim 64 or 128.
//
// Replaces deepspeed_tpu/ops/attention_pallas.py::_fwd_kernel for the
// shapes of the Llama paths (bf16, D = 128).  It computes what the scalar
// body of flash_fwd.cu computes: o [B, T, H, D] bf16 and lse [B, H, T] f32
// (natural log, m + log l), causal or not, GQA read in place (query head h
// reads kv head h / (H / KV)), optional packed segment ids [B, T], ragged T
// and S, p rounded to bf16 before P.V, zeros for a row that sees no key.
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
//    to bf16 in registers and is the register A operand of O += P V, wgmma
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

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is
                   // fetched through the runtime, so nothing links -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace dstt {
namespace sm90 {

constexpr int kBM = 128;        // query rows per block (two consumers of 64)
constexpr int kBN = 128;        // keys per stage
constexpr int kStages = 2;  // D = 128: Q 32 KB + 2 x (K + V) 64 KB = 160 KB
constexpr int kThreads = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kEmptyLse = -1e30f;  // lse of a row that sees no key

template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  // every [rows][64] half: rows of 128 bytes, swizzled by TMA (128B mode);
  // each half is a multiple of 1024 bytes, so all stay 1024-aligned
  __nv_bfloat16 q[kHalves][kBM * 64];
  __nv_bfloat16 k[kStages][kHalves][kBN * 64];
  __nv_bfloat16 v[kStages][kHalves][kBN * 64];
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous issue and the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory
// (scale_d = 0: d = A . B^T, ignoring d's old values)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B MN-major in
// shared memory (the transpose bit: B is stored [16 keys][128] with N contiguous)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B MN-major in
// shared memory (the transpose bit: B is stored [16 keys][64] with N contiguous)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_rs_n128(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
  wgmma_rs_n64(d, a, desc);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Work item w (of n_q * B * H): query tile n_q - 1 - w / (B * H), the
// heaviest causal tiles first, and (b, h) = w % (B * H).  Without segment
// ids the grid is at most one block per SM: block i takes items i, then
// 2G - 1 - i, then 2G + i, ... (G blocks, a snake over rounds), which evens
// out the causal tiles' unequal work, and while one item's last products
// and stores run the producer already loads the next item's Q and first
// K/V tile.  With segment ids the grid has a block per item.
struct Item {
  int b, h, q0, n_tiles;
};

__device__ __forceinline__ int item_index(int k, int items) {
  const int G = gridDim.x;
  const int w = k * G + ((k & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  return w < items ? w : -1;
}

__device__ __forceinline__ Item item_at(int w, int n_q, int BH, int H, int S, int causal) {
  Item it;
  const int bh = w % BH;
  it.b = bh / H;
  it.h = bh % H;
  it.q0 = (n_q - 1 - w / BH) * kBM;
  // causal: key j is seen by row i only when j <= i, so the sweep stops at
  // the tile's last row and tiles above the diagonal are never loaded
  const int kv_end = causal ? min(S, it.q0 + kBM) : S;
  it.n_tiles = (kv_end + kBN - 1) / kBN;
  return it;
}

// Accumulator fragment of wgmma m64nN (f32): in a warpgroup, thread
// (warp w, lane 4 g + c) holds register i at row 16 w + g + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 c + (i & 1).  The register A fragment of a
// 64 x 16 bf16 tile is the same four pairs: a[j] = regs 2j, 2j + 1 of the
// two 8-column chunks, so S's fragment turns into P's in place.
template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int T,
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
        const Item item = item_at(w, n_q, B * H, H, S, causal);
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
        wgmma_ss_n128(sc, desc_sw128(q_base + (kk / 4) * kHalfQ + (kk % 4) * 32, 16, 1024),
                      desc_sw128(k_base + (kk / 4) * kHalfKV + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // O += P V of the tile in stage `st`, V MN-major: the two 64-column
    // halves of D are LBO apart, each group of 8 keys SBO = 1024 bytes apart
    auto issue_pv = [&](const uint32_t (&pa)[kBN / 16][4], int st) {
      const uint32_t v_base = smem_u32(&s.v[st][0][0]);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<D>(acc, pa[kk], desc_sw128(v_base + kk * 16 * 128, kHalfKV, 1024));
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
    // p rounded to bf16 (round to nearest even) as the register A operand
    auto to_frag = [&](const float (&sc)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          __nv_bfloat162 p2 = __floats2bfloat162_rn(sc[kk * 8 + 2 * j], sc[kk * 8 + 2 * j + 1]);
          pa[kk][j] = *reinterpret_cast<uint32_t*>(&p2);
        }
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
      const Item item = item_at(w, n_q, B * H, H, S, causal);
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
        __nv_bfloat16* orow = o + (((long long)b * T + row[r]) * H + h) * D + 2 * qc;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float a0 = l[r] == 0.f ? 0.f : acc[4 * j + 2 * r] / l[r];
          const float a1 = l[r] == 0.f ? 0.f : acc[4 * j + 2 * r + 1] / l[r];
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(a0, a1);
        }
        if (qc == 0)
          lse[((long long)b * H + h) * T + row[r]] =
              l[r] == 0.f ? kEmptyLse : m[r] * scale + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// [B, rows, heads, D] bf16 in its own layout, boxes of (64 columns, 1 head,
// box_rows rows, 1 batch) at 128-byte swizzle; rows past the end read as 0
inline bool encode_rows(EncodeTiledFn fn, CUtensorMap* map, const void* base, int B, int rows,
                        int heads, int D, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* o, void* lse,
                   int B, int T, int S, int H, int KV, float scale, int causal,
                   cudaStream_t stream) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode_rows(fn, &mq, q, B, T, H, D, kBM) || !encode_rows(fn, &mk, k, B, S, KV, D, kBN) ||
      !encode_rows(fn, &mv, v, B, S, KV, D, kBN))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
  auto kern = seg ? flash_fwd_sm90_kernel<D, true> : flash_fwd_sm90_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // without segment ids at most one block per SM, each walking its share of
  // the work items; with them one block per item, so the hardware's
  // scheduler balances the items that the segment skip makes unequal
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long items = (long long)((T + kBM - 1) / kBM) * B * H;
  const unsigned grid = (unsigned)(seg ? items : min(items, (long long)sms));
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, seg, static_cast<__nv_bfloat16*>(o),
                                         static_cast<float*>(lse), B, T, S, H, KV, scale, causal);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace dstt
