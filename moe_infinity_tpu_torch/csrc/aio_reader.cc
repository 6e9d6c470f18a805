// Native expert-store reader of the port: O_DIRECT positioned reads with a
// thread pool. The port's own copy of moe_infinity_tpu/csrc/aio_reader.cc
// (same C interface, same semantics).
//
// 4096-aligned O_DIRECT preads, so cold expert fetches stream from disk
// without filling the page cache, and a fixed thread pool for batched reads
// (one expert record is one contiguous read in the expert-major store).
// A file system that refuses O_DIRECT is opened buffered instead, and
// mtstore_is_direct reports which open took effect. Priorities live in the
// caller's fetch queue (or in sched.cc).
//
// Host C++, not CUDA: moe_infinity_tpu_torch/ops/_build.py compiles it with
// sched.cc into _build/mtstore-<hash>.so at first use
// (moe_infinity_tpu_torch/store/native.py).

#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr size_t kAlign = 4096;  // O_DIRECT sector alignment

struct Handle {
  int fd = -1;
  bool direct = false;
};

struct ReadTask {
  int fd;
  uint64_t offset;
  uint64_t size;
  void* dst;
  std::atomic<int>* pending;
  std::atomic<int>* status;
};

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      threads_.emplace_back([this] { Loop(); });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void Submit(ReadTask t) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push_back(t);
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      ReadTask t;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        t = tasks_.front();
        tasks_.pop_front();
      }
      if (DoRead(t.fd, t.offset, t.size, t.dst) != 0) {
        t.status->store(-1);
      }
      if (t.pending->fetch_sub(1) == 1) {
        // last task: wake the waiter via futex-free spin (caller polls)
      }
    }
  }

  static int DoRead(int fd, uint64_t off, uint64_t size, void* dst) {
    char* p = static_cast<char*>(dst);
    uint64_t done = 0;
    while (done < size) {
      ssize_t n = pread(fd, p + done, size - done, off + done);
      if (n < 0) {
        if (errno == EINTR) continue;
        return -1;
      }
      if (n == 0) return -1;  // unexpected EOF
      done += static_cast<uint64_t>(n);
    }
    return 0;
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<ReadTask> tasks_;
  bool stop_;
  std::vector<std::thread> threads_;
};

Pool* g_pool = nullptr;
std::mutex g_pool_mu;
int g_pool_size = 4;

Pool* GetPool() {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (!g_pool) g_pool = new Pool(g_pool_size);
  return g_pool;
}

}  // namespace

extern "C" {

// Configure the worker count (before first use).
void mtstore_set_threads(int n) {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (!g_pool && n > 0) g_pool_size = n;
}

// Open a blob. use_direct=1 requests O_DIRECT (falls back to buffered if
// the filesystem refuses). Returns an opaque handle or NULL.
void* mtstore_open(const char* path, int use_direct) {
  Handle* h = new Handle();
  int flags = O_RDONLY;
#ifdef O_DIRECT
  if (use_direct) flags |= O_DIRECT;
#endif
  h->fd = open(path, flags);
  if (h->fd < 0 && use_direct) {
    h->fd = open(path, O_RDONLY);  // fallback: no O_DIRECT support
  } else {
    h->direct = use_direct != 0;
  }
  if (h->fd < 0) {
    delete h;
    return nullptr;
  }
  return h;
}

int mtstore_is_direct(void* handle) {
  return handle && static_cast<Handle*>(handle)->direct ? 1 : 0;
}

// Synchronous single read. For O_DIRECT, offset/size/dst must be
// 4096-aligned (the expert store is 4096-strided by construction).
int mtstore_read(void* handle, uint64_t offset, uint64_t size, void* dst) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h || h->fd < 0) return -1;
  char* p = static_cast<char*>(dst);
  uint64_t done = 0;
  while (done < size) {
    ssize_t n = pread(h->fd, p + done, size - done, offset + done);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (n == 0) return -1;
    done += static_cast<uint64_t>(n);
  }
  return 0;
}

// Batched parallel read: n records into n destinations. Blocks until all
// complete. Returns 0 on success, -1 if any read failed.
int mtstore_read_batch(void* handle, int n, const uint64_t* offsets,
                       const uint64_t* sizes, void** dsts) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h || h->fd < 0) return -1;
  std::atomic<int> pending(n);
  std::atomic<int> status(0);
  Pool* pool = GetPool();
  for (int i = 0; i < n; ++i) {
    pool->Submit(ReadTask{h->fd, offsets[i], sizes[i], dsts[i], &pending,
                          &status});
  }
  while (pending.load(std::memory_order_acquire) > 0) {
    std::this_thread::yield();
  }
  return status.load();
}

void mtstore_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (h) {
    if (h->fd >= 0) close(h->fd);
    delete h;
  }
}

uint64_t mtstore_alignment() { return kAlign; }

}  // extern "C"
