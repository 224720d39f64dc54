// Fusion planner: greedy in-order bucketing with per-dtype look-ahead.
// Re-design of Controller::FuseResponses (reference controller.cc:793):
// the reference fuses negotiated Responses under the fusion threshold,
// keeping same dtype/device and looking ahead past interleaved dtypes;
// here the same policy runs at trace time over the gradient list.
#include "hvd_core.h"

#include <unordered_map>
#include <vector>

extern "C" int64_t hvd_fusion_plan(const int64_t* sizes_bytes,
                                   const int32_t* dtype_ids, int64_t n,
                                   int64_t threshold_bytes,
                                   int64_t* out_bucket_ids) {
  if (n < 0 || (n > 0 && (!sizes_bytes || !dtype_ids || !out_bucket_ids)))
    return -1;
  if (threshold_bytes <= 0) {
    for (int64_t i = 0; i < n; ++i) out_bucket_ids[i] = i;
    return n;
  }
  struct Open {
    int64_t bucket;
    int64_t bytes;
  };
  std::unordered_map<int32_t, Open> open;  // dtype -> open bucket
  int64_t next_bucket = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto it = open.find(dtype_ids[i]);
    if (it != open.end() && it->second.bytes + sizes_bytes[i] <= threshold_bytes) {
      out_bucket_ids[i] = it->second.bucket;
      it->second.bytes += sizes_bytes[i];
    } else {
      out_bucket_ids[i] = next_bucket;
      open[dtype_ids[i]] = Open{next_bucket, sizes_bytes[i]};
      ++next_bucket;
    }
  }
  return next_bucket;
}
