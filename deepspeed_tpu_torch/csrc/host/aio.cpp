// Async file IO thread pool for the port's NVMe tiers (copy of the JAX
// package's csrc/aio.cpp; ref behavior: deepspeed/ops/aio — csrc/aio's
// deepspeed_aio_thread/aio_handle: submit pread/pwrite requests against
// NVMe-backed files, poll for completion, bounded queue depth).
//
// Host code, not a kernel: plain POSIX pread/pwrite on a worker pool
// (io_uring/libaio are not guaranteed on the host).  The Python side
// (deepspeed_tpu_torch/io/aio.py) drives it through ctypes and overlaps
// the host<->disk streams with host->device uploads for the
// ZeRO-Inference weight tier and the KV tier's NVMe rung.
//
// Completion and Wait() share `mu_`: a worker lowers `pending_` and
// notifies `done_cv_` while holding it.  Wait() tests its predicate under
// the same lock, so a completion can no longer land between Wait()'s test
// and its sleep and be lost (a decrement-then-notify outside the lock
// could, and the waiter then slept forever).
//
// Build: g++ -O3 -shared -fPIC -o libdstt_aio.so aio.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
  int64_t id;
  int fd;
  void *buf;
  int64_t nbytes;
  int64_t offset;
  bool write;
};

class AioPool {
 public:
  explicit AioPool(int n_threads) : next_id_(1), shutdown_(false) {
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { Run(); });
  }

  ~AioPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      shutdown_ = true;
    }
    cv_.notify_all();
    for (auto &t : workers_) t.join();
  }

  int64_t Submit(int fd, void *buf, int64_t nbytes, int64_t offset,
                 bool write) {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t id = next_id_++;
    queue_.push_back(Request{id, fd, buf, nbytes, offset, write});
    pending_.fetch_add(1);
    cv_.notify_one();
    return id;
  }

  // Block until every submitted request has completed; returns the number
  // of failed requests since the last Wait.
  int64_t Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_.load() == 0; });
    return errors_.exchange(0);
  }

  int64_t Pending() const { return pending_.load(); }

 private:
  void Run() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return shutdown_ || !queue_.empty(); });
        if (shutdown_ && queue_.empty()) return;
        req = queue_.front();
        queue_.pop_front();
      }
      int64_t left = req.nbytes, off = req.offset;
      char *p = static_cast<char *>(req.buf);
      bool failed = false;
      while (left > 0) {
        ssize_t n = req.write ? pwrite(req.fd, p, left, off)
                              : pread(req.fd, p, left, off);
        if (n <= 0) {
          failed = true;
          break;
        }
        left -= n;
        off += n;
        p += n;
      }
      if (failed) errors_.fetch_add(1);
      {
        // under mu_: Wait() cannot be between its predicate test and its
        // sleep while this completion lands
        std::lock_guard<std::mutex> lk(mu_);
        if (pending_.fetch_sub(1) == 1) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<Request> queue_;
  std::vector<std::thread> workers_;
  std::atomic<int64_t> next_id_, pending_{0}, errors_{0};
  bool shutdown_;
};

}  // namespace

extern "C" {

void *dstt_aio_create(int n_threads) { return new AioPool(n_threads); }

void dstt_aio_destroy(void *pool) { delete static_cast<AioPool *>(pool); }

int dstt_aio_open(const char *path, int write, int direct) {
  int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
#ifdef O_DIRECT
  if (direct) flags |= O_DIRECT;
#endif
  return open(path, flags, 0644);
}

void dstt_aio_close(int fd) { close(fd); }

int64_t dstt_aio_pread(void *pool, int fd, void *buf, int64_t nbytes,
                       int64_t offset) {
  return static_cast<AioPool *>(pool)->Submit(fd, buf, nbytes, offset, false);
}

int64_t dstt_aio_pwrite(void *pool, int fd, void *buf, int64_t nbytes,
                        int64_t offset) {
  return static_cast<AioPool *>(pool)->Submit(fd, buf, nbytes, offset, true);
}

int64_t dstt_aio_wait(void *pool) {
  return static_cast<AioPool *>(pool)->Wait();
}

int64_t dstt_aio_pending(void *pool) {
  return static_cast<AioPool *>(pool)->Pending();
}

}  // extern "C"
