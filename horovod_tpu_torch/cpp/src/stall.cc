// Stall inspector (reference stall_inspector.{h,cc}).
// The reference's rank 0 warns when some ranks submitted a tensor and
// others didn't for 60s, optionally shutting the job down.  Under SPMD
// the analogous failure is a *dispatched collective that never
// completes* (a hung peer or a wedged transport): callers mark
// begin/end around blocking points and poll the report from a watchdog.
#include "hvd_core.h"

#include <chrono>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>

namespace {
using Clock = std::chrono::steady_clock;
struct Stall {
  double warn_s, shutdown_s;
  std::mutex mu;
  std::unordered_map<std::string, Clock::time_point> pending;
};
}  // namespace

extern "C" {
void* hvd_stall_new(double warn_seconds, double shutdown_seconds) {
  auto* s = new Stall();
  s->warn_s = warn_seconds;
  s->shutdown_s = shutdown_seconds;
  return s;
}
void hvd_stall_free(void* p) { delete static_cast<Stall*>(p); }

void hvd_stall_begin(void* p, const char* name) {
  auto* s = static_cast<Stall*>(p);
  if (!s || !name) return;
  std::lock_guard<std::mutex> lock(s->mu);
  s->pending.emplace(name, Clock::now());
}

void hvd_stall_end(void* p, const char* name) {
  auto* s = static_cast<Stall*>(p);
  if (!s || !name) return;
  std::lock_guard<std::mutex> lock(s->mu);
  s->pending.erase(name);
}

int64_t hvd_stall_report(void* p, char* buf, int64_t buf_len,
                         int32_t* out_shutdown) {
  auto* s = static_cast<Stall*>(p);
  if (!s) return 0;
  if (out_shutdown) *out_shutdown = 0;
  std::lock_guard<std::mutex> lock(s->mu);
  auto now = Clock::now();
  int64_t count = 0, off = 0;
  for (const auto& kv : s->pending) {
    double age =
        std::chrono::duration<double>(now - kv.second).count();
    if (age < s->warn_s) continue;
    ++count;
    if (out_shutdown && s->shutdown_s > 0 && age >= s->shutdown_s)
      *out_shutdown = 1;
    if (buf && off + (int64_t)kv.first.size() + 1 < buf_len) {
      memcpy(buf + off, kv.first.c_str(), kv.first.size());
      off += (int64_t)kv.first.size();
      buf[off++] = '\n';
    }
  }
  if (buf && off < buf_len) buf[off] = '\0';
  return count;
}
}
