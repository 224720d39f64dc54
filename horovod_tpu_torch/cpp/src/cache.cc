// LRU response cache (reference response_cache.{h,cc}).
// The reference caches negotiated Responses keyed by tensor
// name+parameters so repeat iterations skip negotiation; here the cache
// serves the same role for compiled-dispatch bookkeeping: a hit means
// the (name, signature) pair was seen with identical parameters, a
// signature change (new shape/dtype) evicts and reports a miss, which
// callers use to invalidate per-tensor state.
#include "hvd_core.h"

#include <list>
#include <mutex>
#include <string>
#include <unordered_map>

namespace {
struct Cache {
  explicit Cache(int64_t capacity) : cap(capacity) {}
  int64_t cap;
  std::mutex mu;
  // LRU list of names, most-recent first; map name -> (signature, iter)
  std::list<std::string> lru;
  std::unordered_map<std::string,
                     std::pair<uint64_t, std::list<std::string>::iterator>>
      table;
};
}  // namespace

extern "C" {
void* hvd_cache_new(int64_t capacity) { return new Cache(capacity); }
void hvd_cache_free(void* cache) { delete static_cast<Cache*>(cache); }

int32_t hvd_cache_lookup(void* cache, const char* name, uint64_t signature) {
  auto* c = static_cast<Cache*>(cache);
  if (!c || !name || c->cap <= 0) return 0;
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->table.find(name);
  if (it != c->table.end()) {
    c->lru.erase(it->second.second);
    c->lru.push_front(name);
    it->second.second = c->lru.begin();
    if (it->second.first == signature) return 1;
    it->second.first = signature;  // changed params: refresh, report miss
    return 0;
  }
  c->lru.push_front(name);
  c->table.emplace(name, std::make_pair(signature, c->lru.begin()));
  if ((int64_t)c->table.size() > c->cap) {
    c->table.erase(c->lru.back());
    c->lru.pop_back();
  }
  return 0;
}

void hvd_cache_erase(void* cache, const char* name) {
  auto* c = static_cast<Cache*>(cache);
  if (!c || !name) return;
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->table.find(name);
  if (it != c->table.end()) {
    c->lru.erase(it->second.second);
    c->table.erase(it);
  }
}

int64_t hvd_cache_size(void* cache) {
  auto* c = static_cast<Cache*>(cache);
  if (!c) return 0;
  std::lock_guard<std::mutex> lock(c->mu);
  return (int64_t)c->table.size();
}
}
