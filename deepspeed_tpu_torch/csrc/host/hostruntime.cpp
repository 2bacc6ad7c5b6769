// Host runtime natives for the port (copy of the JAX package's
// csrc/hostruntime.cpp; ref behavior: deepspeed csrc — the pinned-buffer
// management inside csrc/aio's deepspeed_pin_tensor.cpp and the C++ side
// of data loading that deepspeed leans on torch's native DataLoader for).
//
// Two services, driven from Python via ctypes
// (deepspeed_tpu_torch/io/native.py):
//
// 1. Buffer pool: page-aligned host buffers (4 KiB, O_DIRECT-compatible and
//    DMA-friendly as staging for host<->device copies), recycled through
//    per-size-class free lists so steady-state training does zero host
//    allocations.
// 2. Index service: epoch-seeded Fisher-Yates shuffle + batch-window
//    serving for the dataloader (deepspeed_tpu_torch/data/loader.py), off
//    the Python heap and GIL.
//
// Build: g++ -O3 -shared -fPIC -o libdstt_host.so hostruntime.cpp -lpthread

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <vector>

namespace {

constexpr size_t kAlign = 4096;

struct BufferPool {
  std::mutex mu;
  std::multimap<size_t, void *> free_list;  // size -> buffer
  std::map<void *, size_t> live;            // buffer -> size
  size_t bytes_pooled = 0, bytes_live = 0, hits = 0, misses = 0;

  void *Get(size_t nbytes) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = free_list.lower_bound(nbytes);
    // Reuse only when the candidate isn't wastefully large (2x cap).
    if (it != free_list.end() && it->first <= nbytes * 2) {
      void *buf = it->second;
      size_t sz = it->first;
      free_list.erase(it);
      bytes_pooled -= sz;
      live[buf] = sz;
      bytes_live += sz;
      ++hits;
      return buf;
    }
    ++misses;
    void *buf = nullptr;
    size_t padded = (nbytes + kAlign - 1) / kAlign * kAlign;
    if (posix_memalign(&buf, kAlign, padded) != 0) return nullptr;
    live[buf] = padded;
    bytes_live += padded;
    return buf;
  }

  void Put(void *buf) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = live.find(buf);
    if (it == live.end()) return;  // double-free guard
    free_list.emplace(it->second, buf);
    bytes_pooled += it->second;
    bytes_live -= it->second;
    live.erase(it);
  }

  void Trim() {
    std::lock_guard<std::mutex> lk(mu);
    for (auto &kv : free_list) free(kv.second);
    free_list.clear();
    bytes_pooled = 0;
  }

  ~BufferPool() {
    Trim();
    for (auto &kv : live) free(kv.first);
  }
};

// splitmix64: portable, fully specified PRNG so the shuffle order is
// bitwise-identical across stdlibs AND matches the Python mirror in
// deepspeed_tpu_torch/io/native.py (std::mt19937_64 + uniform_int_distribution
// would be implementation-defined → divergent batches across hosts).
static inline uint64_t SplitMix64(uint64_t &state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct IndexService {
  std::vector<int64_t> order;
  int64_t n = 0;
  uint64_t base_seed = 0;
  int64_t epoch = -1;

  void Shuffle(int64_t ep) {
    if (ep == epoch) return;
    epoch = ep;
    order.resize(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    uint64_t state =
        base_seed ^ (static_cast<uint64_t>(ep) * 0xD1B54A32D192ED03ULL) ^
        0x2545F4914F6CDD1DULL;
    for (int64_t i = n - 1; i > 0; --i) {
      // bounded draw by modulo: bias is < 2^-63 for any realistic n and,
      // unlike rejection sampling, trivially mirrored in vectorized numpy
      int64_t j = static_cast<int64_t>(SplitMix64(state) %
                                       static_cast<uint64_t>(i + 1));
      std::swap(order[i], order[j]);
    }
  }
};

}  // namespace

extern "C" {

// ----------------------------------------------------------- buffer pool
void *dstt_pool_create() { return new BufferPool(); }
void dstt_pool_destroy(void *p) { delete static_cast<BufferPool *>(p); }
void *dstt_pool_get(void *p, int64_t nbytes) {
  return static_cast<BufferPool *>(p)->Get(static_cast<size_t>(nbytes));
}
void dstt_pool_put(void *p, void *buf) {
  static_cast<BufferPool *>(p)->Put(buf);
}
void dstt_pool_trim(void *p) { static_cast<BufferPool *>(p)->Trim(); }
// stats: [bytes_pooled, bytes_live, hits, misses]
void dstt_pool_stats(void *p, int64_t *out4) {
  auto *bp = static_cast<BufferPool *>(p);
  std::lock_guard<std::mutex> lk(bp->mu);
  out4[0] = static_cast<int64_t>(bp->bytes_pooled);
  out4[1] = static_cast<int64_t>(bp->bytes_live);
  out4[2] = static_cast<int64_t>(bp->hits);
  out4[3] = static_cast<int64_t>(bp->misses);
}

// ---------------------------------------------------------- index service
void *dstt_idx_create(int64_t n, uint64_t seed) {
  auto *s = new IndexService();
  s->n = n;
  s->base_seed = seed;
  return s;
}
void dstt_idx_destroy(void *p) { delete static_cast<IndexService *>(p); }
// Fill out[count] with indices [start, start+count) of epoch's shuffled
// order; returns number written (clipped at dataset end).
int64_t dstt_idx_window(void *p, int64_t epoch, int64_t start,
                         int64_t count, int64_t *out) {
  auto *s = static_cast<IndexService *>(p);
  s->Shuffle(epoch);
  if (start >= s->n) return 0;
  int64_t m = count;
  if (start + m > s->n) m = s->n - start;
  std::memcpy(out, s->order.data() + start, m * sizeof(int64_t));
  return m;
}

}  // extern "C"
