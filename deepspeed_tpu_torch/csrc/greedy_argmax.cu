// Greedy argmax per row for Hopper (sm_90a).
//
// Replaces deepspeed_tpu/ops/sampling_pallas.py::_greedy_kernel (behind
// fused_greedy_rows / fused_sample_rows): logits [B, V] f32, bf16 or fp16
// (rows `row_stride` elements apart, each row contiguous) -> [B] int32, the
// first index attaining the row max (the first NaN, if the row has one).
// The serving identity gates need this bit-exact with torch.argmax and
// jnp.argmax, so ties go to the smaller index at every step of the
// reduction.  bf16 and fp16 widen to f32 exactly, as the JAX wrapper's
// astype does, so the answer is the f32 one at half the bytes.  No (8, 128)
// padding: each row is read in place.
//
// Bound on the H100: B*V*sizeof(T) bytes read once for ~B*V compares, so it
// is bound by bytes.  A row of 128256 f32 is 513 KB: one block a row (the
// first port) kept a batch of 8 on 8 of the 132 SMs at 5.5 % of the bound.
// So each row is split into S contiguous spans, one block of 512 threads
// each, S chosen by the wrapper (greedy_split_plan in ops/sampling_cuda.py,
// which computes the same spans) so that B*S blocks fill the SMs:
//   - the row's first `head` elements, up to its first 16-byte boundary, go
//     to rank 0 and its last partial vector to rank S-1, scalar; the
//     16-byte vectors between are split evenly (the first nvec % S ranks
//     take one more), ranks in index order;
//   - every thread puts kArgmaxUnroll 16-byte loads in flight before its
//     first compare, then takes the batch's max (max.NaN) and, in a second
//     pass over the registers, the first element equal to it: about three
//     instructions an element, a third of a running (value, index) compare;
//   - candidates travel as (order key, index) pairs, so a warp reduces with
//     two redux.sync (the largest key, then the smallest index holding it)
//     in place of five rounds of shuffles and compares;
//   - the S blocks of a row run as one thread-block cluster (S <= 16; above
//     8 the size is non-portable): each block writes its pair into rank 0's
//     shared memory, and after one cluster barrier rank 0's first warp
//     reduces the S pairs and writes out[b].  One launch, no workspace.
// S = 1 (B alone fills the card) is the same launch with clusters of one.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <limits.h>
#include <math.h>

namespace dstt {

constexpr int kArgmaxThreads = 512;
constexpr int kArgmaxUnroll = 4;   // 16-byte loads in flight per thread
constexpr int kMaxSpans = 16;      // the largest cluster Hopper launches
constexpr int kMaxDevices = 64;    // devices a process remembers attributes for

// A candidate: the order key of its value and its index.  The key orders
// values as the comparisons of torch.argmax do: the float's bits made
// monotone as an int, -0 as +0 (they compare equal), every NaN above +inf
// as one key (NaN counts as the largest value, of two NaNs the first wins).
// Ties go to the smaller index.  (INT_MIN, UINT_MAX) is "nothing seen":
// below every real key (-inf's is INT_MIN + 0x7fffff), so an empty span
// never wins and an all -inf row gives 0.
struct Pair {
  int k;
  unsigned int i;
};
__device__ __forceinline__ Pair nothing() { return Pair{INT_MIN, 0xffffffffu}; }

__device__ __forceinline__ int order_key(float v) {
  if (isnan(v)) return INT_MAX;
  const int b = __float_as_int(v == 0.0f ? 0.0f : v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ void keep_first_max(Pair& a, int k, unsigned int i) {
  if (k > a.k || (k == a.k && i < a.i)) a = Pair{k, i};
}

// the warp's largest key and the smallest index holding it
__device__ __forceinline__ Pair warp_first_max(Pair a) {
  const int k = __reduce_max_sync(0xffffffffu, a.k);
  return Pair{k, __reduce_min_sync(0xffffffffu, a.k == k ? a.i : 0xffffffffu)};
}

// the larger of a and b, NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// storage types, widened to f32 exactly from their bits
struct F32 {
  using bits = unsigned int;
  static __device__ __forceinline__ float widen(unsigned int b) { return __uint_as_float(b); }
};
struct BF16 {
  using bits = unsigned short;
  static __device__ __forceinline__ float widen(unsigned int b) { return __uint_as_float(b << 16); }
};
struct F16 {
  using bits = unsigned short;
  static __device__ __forceinline__ float widen(unsigned int b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
};

// the e-th element of a 16-byte vector, e < 16 / sizeof(bits)
template <typename T>
__device__ __forceinline__ float lane_of(const uint4& u, int e) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(typename T::bits) == 4) {
    return T::widen(w[e]);
  } else {
    const unsigned int word = w[e / 2];
    return T::widen((e & 1) ? word >> 16 : word & 0xffffu);
  }
}

// cluster barriers: arrive (relaxed, or releasing this block's writes) and
// wait (acquiring the other blocks' writes)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// stores p at the address that `slot` (this block's shared memory, 8-byte
// aligned) has in the shared memory of the cluster's rank 0
__device__ __forceinline__ void store_at_rank0(Pair* slot, const Pair& p) {
  unsigned int remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(static_cast<unsigned int>(__cvta_generic_to_shared(slot))), "r"(0));
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(remote), "r"(p.k), "r"(p.i)
               : "memory");
}

// Grid: B * S blocks in clusters of S along x (one cluster a row), row
// blockIdx.x / S, rank blockIdx.x % S.
template <typename T>
__global__ void __launch_bounds__(kArgmaxThreads)
greedy_argmax_kernel(const typename T::bits* __restrict__ logits, int* __restrict__ out, int V,
                     long long row_stride, int S) {
  using bits = typename T::bits;
  constexpr int W = 16 / sizeof(bits);
  __shared__ Pair warp_pairs[kArgmaxThreads / 32];
  __shared__ alignas(8) Pair span_pairs[kMaxSpans];  // rank 0's: one per rank
  // rank 0's shared memory is written below only once every block of the
  // cluster has started; arrive now, wait there, so that costs nothing
  cluster_arrive_relaxed();
  const int row = blockIdx.x / S, rank = blockIdx.x % S;
  const bits* x = logits + row * row_stride;
  const unsigned int misalign = reinterpret_cast<unsigned long long>(x) & 15;
  const int head = min(V, static_cast<int>(((16 - misalign) & 15) / sizeof(bits)));
  const int nvec = (V - head) / W, tail = head + nvec * W;
  const int q = nvec / S, rem = nvec % S;
  const int v0 = rank * q + min(rank, rem), v1 = v0 + q + (rank < rem);
  const int tid = threadIdx.x;
  // each thread sees its elements in increasing index order: the head, its
  // vectors batch by batch, the tail
  Pair best = nothing();
  if (rank == 0 && tid < head) keep_first_max(best, order_key(T::widen(x[tid])), tid);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int base = v0; base < v1; base += kArgmaxThreads * kArgmaxUnroll) {
    uint4 r[kArgmaxUnroll];
#pragma unroll
    for (int u = 0; u < kArgmaxUnroll; ++u) {
      const int j = base + u * kArgmaxThreads + tid;
      if (j < v1) r[u] = __ldcs(xv + j);
    }
    // the batch's max (NaN if it holds one), then the first element equal
    // to it (or the first NaN)
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < kArgmaxUnroll; ++u) {
      if (base + u * kArgmaxThreads + tid < v1) {
#pragma unroll
        for (int e = 0; e < W; ++e) m = max_nan(m, lane_of<T>(r[u], e));
      }
    }
    unsigned int first = 0xffffffffu;
#pragma unroll
    for (int u = kArgmaxUnroll - 1; u >= 0; --u) {
      const int j = base + u * kArgmaxThreads + tid;
      if (j < v1) {
#pragma unroll
        for (int e = W - 1; e >= 0; --e) {
          const float f = lane_of<T>(r[u], e);
          if (f == m || f != f) first = head + j * W + e;
        }
      }
    }
    if (first != 0xffffffffu) keep_first_max(best, order_key(m), first);
  }
  if (rank == S - 1 && tail + tid < V)
    keep_first_max(best, order_key(T::widen(x[tail + tid])), tail + tid);
  best = warp_first_max(best);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) warp_pairs[warp] = best;
  __syncthreads();
  if (warp == 0) best = warp_first_max(lane < kArgmaxThreads / 32 ? warp_pairs[lane] : nothing());
  cluster_wait();
  if (tid == 0) store_at_rank0(&span_pairs[rank], best);
  cluster_arrive();  // release the pairs to rank 0, which reads them next
  cluster_wait();
  if (rank == 0 && warp == 0) {
    best = warp_first_max(lane < S ? span_pairs[lane] : nothing());
    if (lane == 0) out[row] = static_cast<int>(best.i);
  }
}

template <typename T>
int launch_greedy(const void* logits, void* out, int B, int V, long long row_stride, int S,
                  cudaStream_t stream) {
  using bits = typename T::bits;
  const bits* x = static_cast<const bits*>(logits);
  int* o = static_cast<int*>(out);
  auto kern = greedy_argmax_kernel<T>;
  cudaError_t err = cudaSuccess;
  if (S > 8) {
    // clusters above 8 are allowed once per device and instantiation
    static std::atomic<bool> allowed[kMaxDevices];
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || !allowed[dev].load(std::memory_order_relaxed)) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) allowed[dev].store(true, std::memory_order_relaxed);
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * S);
  cfg.blockDim = dim3(kArgmaxThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, o, V, row_stride, S);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dstt

// dtype: 0 f32, 1 bf16, 2 fp16; spans: S, 1..16.  Returns the launch's
// cudaError_t.
extern "C" int dstt_greedy_argmax(const void* logits, void* out, int B, int V, long long row_stride,
                                  int dtype, int spans, void* stream) {
  if (B <= 0 || V <= 0 || spans < 1 || spans > dstt::kMaxSpans ||
      static_cast<long long>(B) * spans > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dstt::launch_greedy<dstt::F32>(logits, out, B, V, row_stride, spans, s);
    case 1: return dstt::launch_greedy<dstt::BF16>(logits, out, B, V, row_stride, spans, s);
    case 2: return dstt::launch_greedy<dstt::F16>(logits, out, B, V, row_stride, spans, s);
    default: return cudaErrorInvalidValue;
  }
}
