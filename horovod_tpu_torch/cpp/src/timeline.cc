// Chrome-tracing timeline writer (reference timeline.{h,cc}).
// Same architecture as the reference: producers enqueue events into a
// bounded lock-light MPSC queue; a dedicated writer thread drains it to
// chrome://tracing JSON.  The reference uses boost::lockfree with
// capacity 1M and drops on overflow; we use a mutex-guarded ring (the
// producers are Python-side dispatch calls, far from the contention
// levels that justified lockfree) with the same bounded/drop policy.
#include "hvd_core.h"

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace {
struct Event {
  std::string name, category;
  char ph;
  int64_t ts_us, dur_us, arg_bytes;
  int32_t pid, tid;
};

constexpr size_t kMaxQueue = 1 << 20;  // reference capacity 1M

struct Timeline {
  FILE* fh = nullptr;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Event> queue;
  std::atomic<bool> closed{false};
  std::atomic<int64_t> dropped{0};
  bool first = true;
  std::thread writer;

  void drain() {
    for (;;) {
      std::deque<Event> batch;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return closed.load() || !queue.empty(); });
        batch.swap(queue);
        if (batch.empty() && closed.load()) break;
      }
      for (const auto& e : batch) write_event(e);
    }
    fprintf(fh, "\n]\n");
    fclose(fh);
    fh = nullptr;
  }

  void write_event(const Event& e) {
    if (!first) fprintf(fh, ",\n");
    first = false;
    fprintf(fh,
            "{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"%c\",\"ts\":%lld,"
            "\"pid\":%d,\"tid\":%d",
            e.name.c_str(), e.category.c_str(), e.ph, (long long)e.ts_us,
            e.pid, e.tid);
    if (e.ph == 'X') fprintf(fh, ",\"dur\":%lld", (long long)e.dur_us);
    if (e.ph == 'i') fprintf(fh, ",\"s\":\"g\"");
    if (e.arg_bytes >= 0)
      fprintf(fh, ",\"args\":{\"bytes\":%lld}", (long long)e.arg_bytes);
    fprintf(fh, "}");
  }
};
}  // namespace

extern "C" {
void* hvd_timeline_open(const char* path) {
  FILE* fh = fopen(path, "w");
  if (!fh) return nullptr;
  fprintf(fh, "[\n");
  auto* tl = new Timeline();
  tl->fh = fh;
  tl->writer = std::thread([tl] { tl->drain(); });
  return tl;
}

void hvd_timeline_close(void* p) {
  auto* tl = static_cast<Timeline*>(p);
  if (!tl) return;
  tl->closed.store(true);
  tl->cv.notify_all();
  tl->writer.join();
  delete tl;
}

void hvd_timeline_event(void* p, const char* name, const char* category,
                        char ph, int64_t ts_us, int64_t dur_us, int32_t pid,
                        int32_t tid, int64_t arg_bytes) {
  auto* tl = static_cast<Timeline*>(p);
  if (!tl || tl->closed.load()) return;
  {
    std::lock_guard<std::mutex> lock(tl->mu);
    if (tl->queue.size() >= kMaxQueue) {
      tl->dropped.fetch_add(1);
      return;  // bounded queue: drop like the reference
    }
    tl->queue.push_back(Event{name ? name : "", category ? category : "", ph,
                              ts_us, dur_us, arg_bytes, pid, tid});
  }
  tl->cv.notify_one();
}

int64_t hvd_timeline_dropped(void* p) {
  auto* tl = static_cast<Timeline*>(p);
  return tl ? tl->dropped.load() : 0;
}
}
