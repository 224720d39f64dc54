/* C ABI of the horovod_tpu native core (libhvd_core.so).
 *
 * The PyTorch port's copy of horovod_tpu/cpp (this header and src/),
 * built with g++ by horovod_tpu_torch/native.py into
 * horovod_tpu_torch/_build/native/ at first use.
 *
 * TPU-native re-design of the reference's C++ runtime
 * (horovod/common, *.cc).  The reference's native layer owns a background
 * negotiation thread, fusion buffers, response cache, timeline, stall
 * inspector, autotuner, and the Gloo/MPI controllers.  Under XLA the
 * data plane is compiled, so the native layer here owns the *host-side*
 * services with the same responsibilities:
 *
 *  - fusion planning        (fusion.cc      ~ FuseResponses / FusionBufferManager)
 *  - response cache         (cache.cc       ~ response_cache.cc)
 *  - timeline writer        (timeline.cc    ~ timeline.cc, writer thread)
 *  - stall inspector        (stall.cc       ~ stall_inspector.cc)
 *  - wire messages          (wire.cc        ~ message.cc + wire/message.fbs)
 *  - TCP host controller    (controller.cc  ~ gloo_context/http_store rendezvous)
 *  - autotuner              (autotune.cc    ~ parameter_manager.cc + optim/)
 *
 * Bound from Python with ctypes (no pybind11 in this image).
 */
#ifndef HVD_CORE_H
#define HVD_CORE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- version / error handling ---- */
const char* hvd_version(void);
/* Returns last error message for the calling thread ("" if none). */
const char* hvd_last_error(void);

/* ---- fusion planner (reference controller.cc:793 FuseResponses) ----
 * sizes_bytes[i], dtype_ids[i] describe tensor i (in request order).
 * out_bucket_ids[i] receives the bucket index for tensor i.
 * Buckets group same-dtype tensors, in order, with total <= threshold
 * (threshold 0 => one bucket per tensor).  Look-ahead across interleaved
 * dtypes mirrors the reference's mixed-precision fusion.
 * Returns the number of buckets, or -1 on error. */
int64_t hvd_fusion_plan(const int64_t* sizes_bytes, const int32_t* dtype_ids,
                        int64_t n, int64_t threshold_bytes,
                        int64_t* out_bucket_ids);

/* ---- response cache (reference response_cache.cc) ----
 * LRU keyed by (name, signature). */
void* hvd_cache_new(int64_t capacity);
void hvd_cache_free(void* cache);
/* Returns 1 on hit, 0 on miss (miss inserts). signature = hash of
 * shape/dtype/op params. */
int32_t hvd_cache_lookup(void* cache, const char* name, uint64_t signature);
void hvd_cache_erase(void* cache, const char* name);
int64_t hvd_cache_size(void* cache);

/* ---- timeline (reference timeline.cc) ----
 * Chrome-tracing JSON writer fed through a bounded MPSC queue drained by
 * a dedicated thread. */
void* hvd_timeline_open(const char* path);
void hvd_timeline_close(void* tl);
/* ph: 'X' complete (dur_us used), 'B' begin, 'E' end, 'i' instant */
void hvd_timeline_event(void* tl, const char* name, const char* category,
                        char ph, int64_t ts_us, int64_t dur_us,
                        int32_t pid, int32_t tid, int64_t arg_bytes);
int64_t hvd_timeline_dropped(void* tl);

/* ---- stall inspector (reference stall_inspector.cc) ----
 * Tracks named pending operations; a watchdog thread reports ops
 * pending longer than warn_seconds via the returned report. */
void* hvd_stall_new(double warn_seconds, double shutdown_seconds);
void hvd_stall_free(void* si);
void hvd_stall_begin(void* si, const char* name);
void hvd_stall_end(void* si, const char* name);
/* Writes a \n-separated report of stalled op names into buf (truncated
 * to buf_len); returns number of stalled ops.  shutdown flag set to 1
 * if any op exceeded shutdown_seconds. */
int64_t hvd_stall_report(void* si, char* buf, int64_t buf_len,
                         int32_t* out_shutdown);

/* ---- wire messages (reference message.cc) ----
 * Compact length-prefixed binary encoding of collective Requests:
 * request = {rank, type, dtype, root, ndim, dims[], name}.
 * Encode n requests into out (cap bytes); returns bytes written or -1.
 * Decode returns number of requests parsed, filling parallel arrays. */
int64_t hvd_wire_encode_request(int32_t rank, int32_t type, int32_t dtype,
                                int32_t root, const int64_t* dims,
                                int32_t ndim, const char* name,
                                uint8_t* out, int64_t cap);
/* Parses one request from buf; returns bytes consumed or -1.
 * name_buf receives the tensor name (truncated to name_cap). */
int64_t hvd_wire_decode_request(const uint8_t* buf, int64_t len,
                                int32_t* out_rank, int32_t* out_type,
                                int32_t* out_dtype, int32_t* out_root,
                                int64_t* out_dims, int32_t dims_cap,
                                int32_t* out_ndim, char* name_buf,
                                int64_t name_cap);
/* Response record (reference Response: response_type echoing the op or
 * ERROR(=8), '\n'-joined tensor names, error message, tensor sizes).
 * Encode returns bytes written or -1; decode returns bytes consumed. */
int64_t hvd_wire_encode_response(int32_t rtype, const char* names,
                                 const char* error, const int64_t* sizes,
                                 int32_t nsizes, uint8_t* out, int64_t cap);
int64_t hvd_wire_decode_response(const uint8_t* buf, int64_t len,
                                 int32_t* out_rtype, char* names_buf,
                                 int64_t names_cap, char* err_buf,
                                 int64_t err_cap, int64_t* out_sizes,
                                 int32_t sizes_cap, int32_t* out_nsizes);

/* ---- TCP host controller (reference gloo rendezvous + http_store) ----
 * Server: a KV store + barrier/allgather coordination service run by the
 * launcher.  Client: workers connect, put/get blobs, barrier.
 * All payloads authenticated with an HMAC-SHA256-like keyed digest. */
void* hvd_ctrl_server_start(const char* bind_host, int32_t port,
                            const char* secret, int32_t world);
/* Returns bound port (server picks a free port when port==0), -1 error */
int32_t hvd_ctrl_server_port(void* srv);
void hvd_ctrl_server_stop(void* srv);

void* hvd_ctrl_client_connect(const char* host, int32_t port,
                              const char* secret, int32_t rank);
void hvd_ctrl_client_close(void* cli);
/* KV ops: scope/key strings, arbitrary value bytes. */
int32_t hvd_ctrl_put(void* cli, const char* scope, const char* key,
                     const uint8_t* val, int64_t len);
/* Blocking get with timeout_ms (-1 = forever). Returns value length,
 * -1 on error/timeout; writes min(len, cap) bytes into out. */
int64_t hvd_ctrl_get(void* cli, const char* scope, const char* key,
                     uint8_t* out, int64_t cap, int64_t timeout_ms);
int32_t hvd_ctrl_delete_scope(void* cli, const char* scope);
/* Barrier across `count` participants under `name`. Returns 0 on
 * success, -1 on error/timeout. */
int32_t hvd_ctrl_barrier(void* cli, const char* name, int32_t count,
                         int64_t timeout_ms);

/* ---- autotuner (reference parameter_manager.cc + optim/) ----
 * Online Bayesian optimization (GP + expected improvement) over the
 * fusion threshold (log2 bytes) maximizing observed bytes/sec. */
void* hvd_autotune_new(double low_log2_bytes, double high_log2_bytes);
void hvd_autotune_free(void* at);
/* Record an observation (threshold in log2 bytes, score = bytes/sec). */
void hvd_autotune_observe(void* at, double log2_bytes, double score);
/* Next suggested threshold (log2 bytes) by EI maximization on a grid. */
double hvd_autotune_suggest(void* at);
/* Best observed point so far. */
double hvd_autotune_best(void* at, double* out_score);

#ifdef __cplusplus
}
#endif
#endif /* HVD_CORE_H */
