// Concurrency stress main for the port's fetch scheduler (sched.cc), built
// under ThreadSanitizer by tests/test_torch_native_sched.py:
//
//   g++ -O1 -g -std=c++17 -fsanitize=thread -pthread sched.cc sched_stress.cc
//   ./a.out [directory for the temporary blob, default $TMPDIR or .]
//
// Hammers every API from concurrent threads against a temporary blob:
// submit/wait pairs at mixed priorities, escalations, generation purges and
// polls, then checks every completed read's bytes. Prints STRESS_OK.

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <atomic>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* mtsched_create(const char*, uint64_t, int, int);
int mtsched_submit(void*, int64_t, uint64_t, uint64_t, void*, int, int64_t);
void mtsched_set_gen(void*, int64_t);
void mtsched_escalate(void*, int64_t);
int mtsched_wait(void*, int64_t, int64_t);
int mtsched_poll(void*, int64_t);
int mtsched_pending(void*);
void mtsched_destroy(void*);
}

int main(int argc, char** argv) {
  const int kRecords = 64;
  const uint64_t kRec = 64 << 10;
  const char* dir = argc > 1 ? argv[1] : getenv("TMPDIR");
  std::string tmpl = std::string(dir && *dir ? dir : ".") + "/mtsched_stress_XXXXXX";
  std::vector<char> path(tmpl.begin(), tmpl.end());
  path.push_back('\0');
  int fd = mkstemp(path.data());
  if (fd < 0) return 1;
  {
    std::vector<char> rec(kRec);
    for (int i = 0; i < kRecords; ++i) {
      memset(rec.data(), i, kRec);
      if (write(fd, rec.data(), kRec) != (ssize_t)kRec) return 1;
    }
  }
  close(fd);

  void* s = mtsched_create(path.data(), 8 << 10, 3, 0);
  if (!s) return 1;

  std::atomic<int> errors{0};
  std::atomic<int64_t> gen{0};

  auto worker = [&](int tid) {
    std::vector<char> dst(kRec);
    for (int iter = 0; iter < 200; ++iter) {
      int rec = (tid * 37 + iter * 11) % kRecords;
      int64_t key = tid * 1000000 + iter;  // unique per request
      int prio = iter % 3 == 0 ? 0 : 1;
      if (mtsched_submit(s, key, (uint64_t)rec * kRec, kRec, dst.data(),
                         prio, gen.load()) != 0) {
        ++errors;
        continue;
      }
      if (iter % 5 == 0) mtsched_escalate(s, key);
      if (iter % 7 == 0) mtsched_set_gen(s, gen.fetch_add(1) + 1);
      mtsched_poll(s, key);
      int st = mtsched_wait(s, key, 30000);
      if (st != 1) {  // cancelled requests are revived by wait
        ++errors;
        continue;
      }
      for (uint64_t b = 0; b < kRec; b += 4096) {
        if (dst[b] != (char)rec) {
          ++errors;
          break;
        }
      }
    }
  };

  std::vector<std::thread> ts;
  for (int t = 0; t < 6; ++t) ts.emplace_back(worker, t);
  for (auto& t : ts) t.join();
  mtsched_destroy(s);
  unlink(path.data());
  if (errors.load() != 0) {
    fprintf(stderr, "errors: %d\n", errors.load());
    return 2;
  }
  printf("STRESS_OK\n");
  return 0;
}
