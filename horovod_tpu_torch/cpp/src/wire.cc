// Wire message encoding (reference common/message.{h,cc} +
// wire/message.fbs).  The reference serializes Request/Response with
// FlatBuffers for controller negotiation; on TPU negotiation is gone,
// but collective *metadata* still crosses hosts (elastic re-rendezvous,
// launcher state exchange), so the same Request record gets a compact
// deterministic binary layout:
//   u32 rank | u8 type | u8 dtype | i32 root | u8 ndim | i64 dims[] |
//   u16 name_len | name bytes
#include "hvd_core.h"

#include <cstring>

namespace {
void w32(uint8_t*& p, uint32_t v) {
  p[0] = uint8_t(v >> 24); p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8); p[3] = uint8_t(v);
  p += 4;
}
uint32_t r32(const uint8_t*& p) {
  uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
               (uint32_t(p[2]) << 8) | uint32_t(p[3]);
  p += 4;
  return v;
}
void w64(uint8_t*& p, uint64_t v) {
  w32(p, uint32_t(v >> 32));
  w32(p, uint32_t(v));
}
uint64_t r64(const uint8_t*& p) {
  uint64_t hi = r32(p);
  return (hi << 32) | r32(p);
}
}  // namespace

extern "C" {

int64_t hvd_wire_encode_request(int32_t rank, int32_t type, int32_t dtype,
                                int32_t root, const int64_t* dims,
                                int32_t ndim, const char* name, uint8_t* out,
                                int64_t cap) {
  if (!out || ndim < 0 || ndim > 255 || (ndim > 0 && !dims)) return -1;
  size_t name_len = name ? strlen(name) : 0;
  if (name_len > 0xffff) return -1;
  int64_t need = 4 + 1 + 1 + 4 + 1 + 8LL * ndim + 2 + (int64_t)name_len;
  if (cap < need) return -1;
  uint8_t* p = out;
  w32(p, (uint32_t)rank);
  *p++ = (uint8_t)type;
  *p++ = (uint8_t)dtype;
  w32(p, (uint32_t)root);
  *p++ = (uint8_t)ndim;
  for (int32_t i = 0; i < ndim; ++i) w64(p, (uint64_t)dims[i]);
  *p++ = uint8_t(name_len >> 8);
  *p++ = uint8_t(name_len);
  memcpy(p, name, name_len);
  return need;
}

// Response record (reference common/message.h Response: response_type
// echoing the op or ERROR, tensor names, error message, tensor sizes):
//   u8 rtype | u16 names_len | names ('\n'-joined) |
//   u32 err_len | err bytes | u16 nsizes | i64 sizes[]
int64_t hvd_wire_encode_response(int32_t rtype, const char* names,
                                 const char* error, const int64_t* sizes,
                                 int32_t nsizes, uint8_t* out, int64_t cap) {
  if (!out || nsizes < 0 || (nsizes > 0 && !sizes)) return -1;
  size_t names_len = names ? strlen(names) : 0;
  size_t err_len = error ? strlen(error) : 0;
  if (names_len > 0xffff || nsizes > 0xffff || err_len > 0xffffffff)
    return -1;
  int64_t need = 1 + 2 + (int64_t)names_len + 4 + (int64_t)err_len + 2 +
                 8LL * nsizes;
  if (cap < need) return -1;
  uint8_t* p = out;
  *p++ = (uint8_t)rtype;
  *p++ = uint8_t(names_len >> 8);
  *p++ = uint8_t(names_len);
  if (names_len) memcpy(p, names, names_len);  // NULL src is UB even for n=0
  p += names_len;
  w32(p, (uint32_t)err_len);
  if (err_len) memcpy(p, error, err_len);
  p += err_len;
  *p++ = uint8_t(nsizes >> 8);
  *p++ = uint8_t(nsizes);
  for (int32_t i = 0; i < nsizes; ++i) w64(p, (uint64_t)sizes[i]);
  return need;
}

int64_t hvd_wire_decode_response(const uint8_t* buf, int64_t len,
                                 int32_t* out_rtype, char* names_buf,
                                 int64_t names_cap, char* err_buf,
                                 int64_t err_cap, int64_t* out_sizes,
                                 int32_t sizes_cap, int32_t* out_nsizes) {
  if (!buf || len < 9) return -1;
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  int32_t rtype = *p++;
  uint16_t names_len = (uint16_t(p[0]) << 8) | p[1];
  p += 2;
  if (end - p < names_len + 4) return -1;
  if (names_buf && names_cap > 0) {
    int64_t n = names_len < names_cap - 1 ? names_len : names_cap - 1;
    memcpy(names_buf, p, (size_t)n);
    names_buf[n] = '\0';
  }
  p += names_len;
  uint32_t err_len = r32(p);
  if ((uint64_t)(end - p) < (uint64_t)err_len + 2) return -1;
  if (err_buf && err_cap > 0) {
    int64_t n = err_len < (uint64_t)err_cap - 1 ? err_len
                                                : (uint64_t)err_cap - 1;
    memcpy(err_buf, p, (size_t)n);
    err_buf[n] = '\0';
  }
  p += err_len;
  uint16_t nsizes = (uint16_t(p[0]) << 8) | p[1];
  p += 2;
  if (end - p < 8LL * nsizes) return -1;
  for (int32_t i = 0; i < nsizes; ++i) {
    int64_t v = (int64_t)r64(p);
    if (out_sizes && i < sizes_cap) out_sizes[i] = v;
  }
  if (out_rtype) *out_rtype = rtype;
  if (out_nsizes) *out_nsizes = nsizes;
  return p - buf;
}

int64_t hvd_wire_decode_request(const uint8_t* buf, int64_t len,
                                int32_t* out_rank, int32_t* out_type,
                                int32_t* out_dtype, int32_t* out_root,
                                int64_t* out_dims, int32_t dims_cap,
                                int32_t* out_ndim, char* name_buf,
                                int64_t name_cap) {
  if (!buf || len < 13) return -1;
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  int32_t rank = (int32_t)r32(p);
  int32_t type = *p++;
  int32_t dtype = *p++;
  int32_t root = (int32_t)r32(p);
  int32_t ndim = *p++;
  if (end - p < 8LL * ndim + 2) return -1;
  for (int32_t i = 0; i < ndim; ++i) {
    int64_t d = (int64_t)r64(p);
    if (out_dims && i < dims_cap) out_dims[i] = d;
  }
  uint16_t name_len = (uint16_t(p[0]) << 8) | p[1];
  p += 2;
  if (end - p < name_len) return -1;
  if (name_buf && name_cap > 0) {
    int64_t n = name_len < name_cap - 1 ? name_len : name_cap - 1;
    memcpy(name_buf, p, (size_t)n);
    name_buf[n] = '\0';
  }
  p += name_len;
  if (out_rank) *out_rank = rank;
  if (out_type) *out_type = type;
  if (out_dtype) *out_dtype = dtype;
  if (out_root) *out_root = root;
  if (out_ndim) *out_ndim = ndim;
  return p - buf;
}

}  // extern "C"
