// Shared machinery of the Hopper (sm_90a) tensor-core bodies of the flash
// kernels (flash_fwd_sm90.cuh: B1; flash_bwd_sm90.cuh: B2 and B3):
// mbarriers, TMA loads through 4-d tensor maps, 128-byte-swizzle wgmma
// descriptors, the wgmma wrappers (SS: both operands K-major in shared
// memory; RS: A from registers, B MN-major through the transpose bit), the
// persistent grid's item order, and the host-side tensor-map encoding.
//
// Accumulator fragment of wgmma m64nN (f32): in a warpgroup, thread
// (warp w, lane 4 g + c) holds register i at row 16 w + g + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 c + (i & 1).  The register A fragment of a
// 64 x 16 bf16 tile is the same four pairs: a[j] = regs 2j, 2j + 1 of the
// two 8-column chunks, so an accumulator turns into an A operand in place.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is
                   // fetched through the runtime, so nothing links -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"

namespace dstt {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

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

// The wgmma wrappers take the operands' element type E (bfloat16 or
// float16: "bf16" or "f16" in the instruction; the accumulator is f32 for
// both).  An asm string is a literal, so each wrapper is a macro of the type
// name, expanded once per type.
#define DSTT_ACC64(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])
#define DSTT_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DSTT_REGS64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DSTT_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// SS: d (+)= A . B^T, A and B K-major in shared memory (scale_d = 0 ignores
// d's old values)
#define DSTT_WGMMA_SS_N128(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " DSTT_REGS64      \
               ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                           \
               : DSTT_ACC64(d)                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define DSTT_WGMMA_SS_N64(TY)                                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTT_REGS32       \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
               : DSTT_ACC32(d)                                                              \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// RS: d += A . B, A from registers, B MN-major in shared memory (the
// transpose bit)
#define DSTT_WGMMA_RS_N128(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " DSTT_REGS64      \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                             \
               : DSTT_ACC64(d)                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define DSTT_WGMMA_RS_N64(TY)                                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTT_REGS32       \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
               : DSTT_ACC32(d)                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d[64 x 128] += A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory
// (scale_d = 0: d = A . B^T, ignoring d's old values)
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  if constexpr (kIsHalf<E>)
    DSTT_WGMMA_SS_N128("f16");
  else
    DSTT_WGMMA_SS_N128("bf16");
}

// d[64 x 64] += A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory
// (scale_d = 0: d = A . B^T, ignoring d's old values)
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  if constexpr (kIsHalf<E>)
    DSTT_WGMMA_SS_N64("f16");
  else
    DSTT_WGMMA_SS_N64("bf16");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B MN-major in
// shared memory (the transpose bit: B is stored [16 keys][128] with N contiguous)
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  if constexpr (kIsHalf<E>)
    DSTT_WGMMA_RS_N128("f16");
  else
    DSTT_WGMMA_RS_N128("bf16");
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B MN-major in
// shared memory (the transpose bit: B is stored [16 keys][64] with N contiguous)
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (kIsHalf<E>)
    DSTT_WGMMA_RS_N64("f16");
  else
    DSTT_WGMMA_RS_N64("bf16");
}

template <int D, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (D == 128)
    wgmma_rs_n128<E>(d, a, desc);
  else
    wgmma_rs_n64<E>(d, a, desc);
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

// Work item w (of n_q * B * H), for query tiles of BM rows and key tiles of
// BN: query tile n_q - 1 - w / (B * H), the
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

template <int BM, int BN>
__device__ __forceinline__ Item item_at(int w, int n_q, int BH, int H, int S, int causal) {
  Item it;
  const int bh = w % BH;
  it.b = bh / H;
  it.h = bh % H;
  it.q0 = (n_q - 1 - w / BH) * BM;
  // causal: key j is seen by row i only when j <= i, so the sweep stops at
  // the tile's last row and tiles above the diagonal are never loaded
  const int kv_end = causal ? min(S, it.q0 + BM) : S;
  it.n_tiles = (kv_end + BN - 1) / BN;
  return it;
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

// the tensor map's element type of E
template <typename E>
constexpr CUtensorMapDataType tma_dtype() {
  return kIsHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// [B, rows, heads, D] of 2-byte elements (bfloat16 or float16, `dt`) in its
// own layout, boxes of (64 columns, 1 head, box_rows rows, 1 batch) at
// 128-byte swizzle; rows past the end read as 0.  The strides are in bytes:
// 2 a column, as both types take.
inline bool encode_rows(EncodeTiledFn fn, CUtensorMap* map, const void* base, int B, int rows,
                        int heads, int D, int box_rows, CUtensorMapDataType dt) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, dt, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SM count (the persistent grids' size), read once
inline cudaError_t sm_count(int* sms) {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = n;
  return cudaSuccess;
}

}  // namespace sm90
}  // namespace dstt
