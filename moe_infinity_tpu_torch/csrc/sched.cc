// Native priority fetch scheduler of the port: block-granular
// priority-preemptive reads over one expert-store blob. The port's own copy
// of moe_infinity_tpu/csrc/sched.cc (same C interface and semantics, plus
// mtsched_is_direct, which reports whether the open took O_DIRECT).
//
// A priority queue of record reads with stale-generation purge, and
// block-granular preemption: on-demand requests (priority 0) drain whole
// while prefetches (priority >= 1) read one block per scheduling pass, so an
// on-demand miss that arrives mid-prefetch is served within one block's time.
// Workers only produce host bytes; the caller owns device placement. Waiters
// block inside mtsched_wait with the GIL released (ctypes).
//
// Host C++, not CUDA: built with aio_reader.cc into _build/mtstore-<hash>.so
// by moe_infinity_tpu_torch/ops/_build.py (store/native.py).

#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

int DoPread(int fd, uint64_t off, uint64_t size, char* dst) {
  uint64_t done = 0;
  while (done < size) {
    ssize_t n = pread(fd, dst + done, size - done, off + done);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (n == 0) return -1;  // unexpected EOF
    done += static_cast<uint64_t>(n);
  }
  return 0;
}

struct Req {
  int64_t key;
  uint64_t off;
  uint64_t size;
  char* dst;
  int prio;          // 0 = on-demand (drain whole), >=1 = prefetch
  int64_t gen;       // prefetch generation (stale-purge)
  uint64_t done = 0; // bytes read
  int status = 0;    // 0 queued/in-progress, 1 done, -1 io error,
                     // -2 cancelled (stale generation)
  bool in_service = false;
  uint64_t seq;      // FIFO tiebreak within a priority
};

class Sched {
 public:
  Sched(int fd, uint64_t block, int nthreads, bool direct)
      : direct(direct), fd_(fd), block_(block) {
    for (int i = 0; i < nthreads; ++i)
      workers_.emplace_back([this] { Loop(); });
  }

  ~Sched() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_done_.notify_all();
    for (auto& t : workers_) t.join();
    if (fd_ >= 0) close(fd_);
  }

  // 0 ok, -1 duplicate key
  int Submit(int64_t key, uint64_t off, uint64_t size, char* dst, int prio,
             int64_t gen) {
    std::lock_guard<std::mutex> lk(mu_);
    if (reqs_.count(key)) return -1;
    auto r = std::make_shared<Req>();
    r->key = key;
    r->off = off;
    r->size = size;
    r->dst = dst;
    r->prio = prio;
    r->gen = gen;
    r->seq = seq_++;
    reqs_[key] = r;
    cv_work_.notify_one();
    return 0;
  }

  // Purge QUEUED prefetch requests older than `gen` (in-service requests
  // finish their current block, then notice the cancel).
  void SetGen(int64_t gen) {
    std::lock_guard<std::mutex> lk(mu_);
    gen_ = gen;
    bool any = false;
    for (auto& kv : reqs_) {
      auto& r = kv.second;
      if (r->status == 0 && r->prio > 0 && r->gen < gen) {
        r->status = -2;
        any = true;
      }
    }
    if (any) cv_done_.notify_all();
  }

  // Boost a request to on-demand priority (no-op if unknown/finished).
  void Escalate(int64_t key) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = reqs_.find(key);
    if (it != reqs_.end() && it->second->status == 0) {
      it->second->prio = 0;
      cv_work_.notify_all();
    }
  }

  // Block until the request finishes; removes it. Returns its final
  // status (1 done, -1 io error), -3 on timeout, -4 if the key is
  // unknown. Cancelled requests are ALWAYS revived at prio 0 (a waiter
  // means someone needs the bytes NOW, stale plan or not), so -2 never
  // escapes Wait — only Poll reports it.
  int Wait(int64_t key, int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = reqs_.find(key);
    if (it == reqs_.end()) return -4;
    auto r = it->second;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    while (!stop_) {
      if (r->status == -2) {  // revive; the in-service worker (if any)
        r->status = 0;        // sees status back at 0 and keeps reading
        r->prio = 0;
        cv_work_.notify_all();
      }
      // Never release dst ownership while a worker may still be writing:
      // SetGen can cancel mid-pread, leaving status set while in_service
      // stays true until the worker re-locks.
      if (r->status != 0 && !r->in_service) break;
      if (timeout_ms < 0) {
        cv_done_.wait(lk);
      } else if (cv_done_.wait_until(lk, deadline) ==
                 std::cv_status::timeout) {
        if (r->status != 0 && !r->in_service) break;
        return -3;  // request stays live; caller may wait again
      }
    }
    int st = r->status == 0 ? -3 : r->status;
    reqs_.erase(key);
    return st;
  }

  // Non-blocking status probe (0 in flight, else Wait's codes plus -2
  // cancelled). Pure probe: only Wait consumes/removes a request, so a
  // poll-then-wait sequence always sees the completion exactly once.
  int Poll(int64_t key) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = reqs_.find(key);
    if (it == reqs_.end()) return -4;
    return it->second->status;
  }

  const bool direct;  // the blob was opened with O_DIRECT

  int Pending() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<int>(reqs_.size());
  }

 private:
  std::shared_ptr<Req> PickLocked() {
    // Linear scan: the queue holds at most a few dozen expert fetches.
    std::shared_ptr<Req> best;
    for (auto& kv : reqs_) {
      auto& r = kv.second;
      if (r->status != 0 || r->in_service) continue;
      if (!best || r->prio < best->prio ||
          (r->prio == best->prio && r->seq < best->seq))
        best = r;
    }
    return best;
  }

  bool HigherPrioWaitingLocked(int prio) {
    for (auto& kv : reqs_) {
      auto& r = kv.second;
      if (r->status == 0 && !r->in_service && r->prio < prio) return true;
    }
    return false;
  }

  void Loop() {
    std::unique_lock<std::mutex> lk(mu_);
    while (!stop_) {
      auto r = PickLocked();
      if (!r) {
        cv_work_.wait(lk);
        continue;
      }
      r->in_service = true;
      while (r->status == 0) {
        uint64_t chunk = r->size - r->done;
        if (r->prio > 0 && chunk > block_) chunk = block_;
        uint64_t off = r->off + r->done;
        char* dst = r->dst + r->done;
        lk.unlock();
        int rc = DoPread(fd_, off, chunk, dst);
        lk.lock();
        if (r->status == -2) break;  // cancelled mid-read
        if (rc != 0) {
          r->status = -1;
          break;
        }
        r->done += chunk;
        if (r->done >= r->size) {
          r->status = 1;
          break;
        }
        // block-granular preemption: a prefetch yields the worker when
        // higher-priority work is queued
        if (r->prio > 0 && HigherPrioWaitingLocked(r->prio)) break;
      }
      r->in_service = false;
      if (r->status != 0)
        cv_done_.notify_all();
      else
        cv_work_.notify_one();  // yielded: requeue for any worker
    }
  }

  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  std::map<int64_t, std::shared_ptr<Req>> reqs_;
  uint64_t seq_ = 0;
  int64_t gen_ = 0;
  int fd_;
  uint64_t block_;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

// Open `path` and start `nthreads` service threads. block_bytes is the
// preemption granularity for prefetch-priority reads (0 -> 1 MiB).
// use_direct=1 requests O_DIRECT with buffered fallback.
void* mtsched_create(const char* path, uint64_t block_bytes, int nthreads,
                     int use_direct) {
  int flags = O_RDONLY;
#ifdef O_DIRECT
  if (use_direct) flags |= O_DIRECT;
#endif
  int fd = open(path, flags);
  bool direct = fd >= 0 && use_direct;
  if (fd < 0 && use_direct) fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  if (block_bytes == 0) block_bytes = 1 << 20;
  if (nthreads < 1) nthreads = 1;
  return new Sched(fd, block_bytes, nthreads, direct);
}

int mtsched_submit(void* h, int64_t key, uint64_t off, uint64_t size,
                   void* dst, int prio, int64_t gen) {
  return static_cast<Sched*>(h)->Submit(key, off, size,
                                        static_cast<char*>(dst), prio, gen);
}

void mtsched_set_gen(void* h, int64_t gen) {
  static_cast<Sched*>(h)->SetGen(gen);
}

void mtsched_escalate(void* h, int64_t key) {
  static_cast<Sched*>(h)->Escalate(key);
}

int mtsched_wait(void* h, int64_t key, int64_t timeout_ms) {
  return static_cast<Sched*>(h)->Wait(key, timeout_ms);
}

int mtsched_poll(void* h, int64_t key) {
  return static_cast<Sched*>(h)->Poll(key);
}

int mtsched_pending(void* h) { return static_cast<Sched*>(h)->Pending(); }

int mtsched_is_direct(void* h) { return static_cast<Sched*>(h)->direct ? 1 : 0; }

void mtsched_destroy(void* h) { delete static_cast<Sched*>(h); }

}  // extern "C"
