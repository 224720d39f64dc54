// Kernels B3, B4 and B5 of the quantized gradient wire (int8 / fp8).
//
// B3, quantize and pack: (m, nb, block) f32 -> (m, nb, block + 4) int8
//   rows, each the block's int8 values (or float8_e4m3fn bit patterns)
//   followed by its f32 scale, little-endian; optionally also the f32
//   dequant q * scale that the error-feedback residual needs.
//   Replaces horovod_tpu/ops/pallas_quant.py::_quant_packed_kernel and
//   _quant_packed_only_kernel (launched by _quant_packed) and their
//   Triton-lowered twin ops/mosaic_quant.py::_quant_packed_gpu.
// B4, dequant-accumulate: n packed arrivals (n, nb, block + 4), in source
//   order -> (nb, block) f32 sum of q * s.  Replaces
//   pallas_quant.py::_rs_accum and mosaic_quant.py::_rs_accum_gpu.
// B5, dequant rows: (n, nb, block + 4) -> (n, nb, block) f32 q * s.
//   Replaces pallas_quant.py::_dequant_rows_kernel (launched by
//   fused_all_gather) and mosaic_quant.py::_dequant_rows_gpu.
//
// Bound: memory.  Each kernel does a handful of operations per byte, so
// the least time is (bytes in + bytes out) / 3.35 TB/s on an H100 SXM.
// For a 16,489,472-element bucket at block 512: B3 with the dequant
// moves 148.5 MB (44.3 us), without it 82.6 MB; B4 with one arrival
// and B5 82.6 MB (24.6 us each).
//
// Design against that bound.  The TPU kernels hold whole chunks in VMEM
// and reduce each block's amax with vector ops.  Here one warp owns one
// quantization block at a time (a grid-stride loop over blocks): lanes
// read the block as float4 (block % 4 == 0) or scalars, a shuffle
// reduction gives amax and a ballot gives "non-finite", then the lanes
// read the block again (from L1/L2) to quantize it and store four q
// bytes as one 32-bit word; lane 0 stores the scale as one word at byte
// `block` of the row.  Rows of block + 4 bytes are 4-byte aligned but,
// at block 512, not 16-byte aligned, hence 32-bit stores.  B4 and B5
// keep the same warp-per-block shape so each lane loads one q word and
// the block's scale once per source.
//
// Numerics, bitwise with the plain PyTorch versions in
// horovod_tpu_torch/ops/quant_kernels.py:
// - scale: safe = amax * float32(1/qmax) (the host passes the constant;
//   XLA's jit turns amax / qmax into this product), 1.0 for a zero block
//   or when the product underflows to 0; a block holding inf or NaN gets
//   scale NaN (0x7fc00000) and q = 0.  fmaxf drops NaN, so non-finiteness
//   is tracked on its own.
// - x / safe is an IEEE division (__fdiv_rn), never a reciprocal.
// - int8: rintf (round half to even) and clamp to [-127, 127].
// - fp8: round to nearest even into float8_e4m3fn, saturating at 448,
//   the algorithm of PyTorch's c10 conversion (values never exceed
//   448 by more than rounding here).
// - B4 rounds each product and each sum (__fmul_rn, __fadd_rn): no FMA
//   contraction, as PyTorch's separate multiply and add.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInt8 = 0;
constexpr int kFp8 = 1;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNaN = 0x7fc00000u;

// float -> float8_e4m3fn, round to nearest even, saturating to 448.
__device__ __forceinline__ uint32_t f32_to_e4m3(float f) {
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint32_t r;
  if (bits >= (1087u << 20)) {  // >= 480 (or inf / NaN)
    r = bits > 0x7f800000u ? 0x7fu : 0x7eu;
  } else if (bits < (121u << 23)) {  // below 2^-6: e4m3 subnormal range
    const uint32_t denorm = 141u << 23;
    r = __float_as_uint(__fadd_rn(__uint_as_float(bits), __uint_as_float(denorm))) - denorm;
  } else {
    const uint32_t odd = (bits >> 20) & 1u;
    bits += (static_cast<uint32_t>(7 - 127) << 23) + 0x7ffffu + odd;
    r = bits >> 20;
    if (r == 0x7fu) r = 0x7eu;
  }
  return (r | (sign >> 24)) & 0xffu;
}

// float8_e4m3fn -> float, exact.
__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24;
  const uint32_t e = (b >> 3) & 0xfu;
  const uint32_t m = b & 0x7u;
  uint32_t bits;
  if (e == 0xfu && m == 0x7u) {
    bits = 0x7fc00000u;
  } else if (e == 0) {
    // m * 2^-9, exact in float
    return __uint_as_float(sign | __float_as_uint(static_cast<float>(m) * 0.001953125f));
  } else {
    bits = ((e + 120u) << 23) | (m << 20);
  }
  return __uint_as_float(sign | bits);
}

template <int W>
__device__ __forceinline__ float q_value(uint32_t byte) {
  if (W == kInt8) return static_cast<float>(static_cast<int8_t>(byte & 0xffu));
  return e4m3_to_f32(byte & 0xffu);
}

template <int W>
__device__ __forceinline__ uint32_t quantize(float x, float safe) {
  const float v = __fdiv_rn(x, safe);
  if (W == kInt8) {
    const float r = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
    return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
  }
  return f32_to_e4m3(v);
}

__device__ __forceinline__ void observe(float v, float& amax, bool& bad) {
  amax = fmaxf(amax, fabsf(v));
  bad |= (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;  // inf or NaN
}

__device__ __forceinline__ int64_t warp_id() {
  return static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
}

__device__ __forceinline__ int64_t warp_count() {
  return static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
}

// B3.  VEC: block % 4 == 0 and x / deq 16-byte aligned.
template <int W, bool DEQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_pack_kernel(const float* __restrict__ x, uint8_t* __restrict__ packed,
                  float* __restrict__ deq, int64_t nblocks, int block,
                  float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const int words = block / 4;
  for (int64_t b = warp_id(); b < nblocks; b += warp_count()) {
    const float* xb = x + b * block;
    uint8_t* pb = packed + b * (block + 4);
    float amax = 0.0f;
    bool bad = false;
    if (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(xb);
      for (int g = lane; g < words; g += 32) {
        const float4 v = x4[g];
        observe(v.x, amax, bad); observe(v.y, amax, bad);
        observe(v.z, amax, bad); observe(v.w, amax, bad);
      }
    } else {
      for (int i = lane; i < block; i += 32) observe(xb[i], amax, bad);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
    bad = __any_sync(kFull, bad);
    const float cand = __fmul_rn(amax, inv_qmax);
    const float safe = (!bad && cand > 0.0f) ? cand : 1.0f;
    const float scale = bad ? __uint_as_float(kNaN) : safe;
    if (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(xb);
      uint32_t* p4 = reinterpret_cast<uint32_t*>(pb);
      for (int g = lane; g < words; g += 32) {
        const float4 v = x4[g];
        uint32_t q0 = 0, q1 = 0, q2 = 0, q3 = 0;
        if (!bad) {
          q0 = quantize<W>(v.x, safe); q1 = quantize<W>(v.y, safe);
          q2 = quantize<W>(v.z, safe); q3 = quantize<W>(v.w, safe);
        }
        p4[g] = q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
        if (DEQ) {
          reinterpret_cast<float4*>(deq + b * block)[g] = make_float4(
              __fmul_rn(q_value<W>(q0), scale), __fmul_rn(q_value<W>(q1), scale),
              __fmul_rn(q_value<W>(q2), scale), __fmul_rn(q_value<W>(q3), scale));
        }
      }
      if (lane == 0) p4[words] = __float_as_uint(scale);
    } else {
      for (int i = lane; i < block; i += 32) {
        const uint32_t q = bad ? 0u : quantize<W>(xb[i], safe);
        pb[i] = static_cast<uint8_t>(q);
        if (DEQ) deq[b * block + i] = __fmul_rn(q_value<W>(q), scale);
      }
      if (lane < 4) pb[block + lane] = static_cast<uint8_t>(__float_as_uint(scale) >> (8 * lane));
    }
  }
}

__device__ __forceinline__ float load_scale(const uint8_t* row, int block, bool vec) {
  if (vec) return __uint_as_float(*reinterpret_cast<const uint32_t*>(row + block));
  const uint32_t s = static_cast<uint32_t>(row[block]) |
                     (static_cast<uint32_t>(row[block + 1]) << 8) |
                     (static_cast<uint32_t>(row[block + 2]) << 16) |
                     (static_cast<uint32_t>(row[block + 3]) << 24);
  return __uint_as_float(s);
}

// B4: out[b] = sum over sources i in order of q_i[b] * s_i[b].
// VEC: block % 4 == 0 and out 16-byte aligned.
template <int W, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_accum_kernel(const uint8_t* __restrict__ recv, float* __restrict__ out,
                     int n, int64_t nb, int block) {
  const int lane = threadIdx.x & 31;
  const int64_t row = block + 4;
  const int words = block / 4;
  for (int64_t b = warp_id(); b < nb; b += warp_count()) {
    float* ob = out + b * block;
    if (VEC) {
      for (int g = lane; g < words; g += 32) {
        float4 acc;
        for (int i = 0; i < n; ++i) {
          const uint8_t* r = recv + (static_cast<int64_t>(i) * nb + b) * row;
          const float s = load_scale(r, block, true);
          const uint32_t w = reinterpret_cast<const uint32_t*>(r)[g];
          const float p0 = __fmul_rn(q_value<W>(w), s);
          const float p1 = __fmul_rn(q_value<W>(w >> 8), s);
          const float p2 = __fmul_rn(q_value<W>(w >> 16), s);
          const float p3 = __fmul_rn(q_value<W>(w >> 24), s);
          if (i == 0) {
            acc = make_float4(p0, p1, p2, p3);
          } else {
            acc.x = __fadd_rn(acc.x, p0); acc.y = __fadd_rn(acc.y, p1);
            acc.z = __fadd_rn(acc.z, p2); acc.w = __fadd_rn(acc.w, p3);
          }
        }
        reinterpret_cast<float4*>(ob)[g] = acc;
      }
    } else {
      for (int j = lane; j < block; j += 32) {
        float acc = 0.0f;
        for (int i = 0; i < n; ++i) {
          const uint8_t* r = recv + (static_cast<int64_t>(i) * nb + b) * row;
          const float p = __fmul_rn(q_value<W>(r[j]), load_scale(r, block, false));
          acc = i == 0 ? p : __fadd_rn(acc, p);
        }
        ob[j] = acc;
      }
    }
  }
}

// B5: out[r] = q[r] * s[r] for every packed row r.
template <int W, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_rows_kernel(const uint8_t* __restrict__ packed, float* __restrict__ out,
                    int64_t rows, int block) {
  const int lane = threadIdx.x & 31;
  const int words = block / 4;
  for (int64_t b = warp_id(); b < rows; b += warp_count()) {
    const uint8_t* r = packed + b * (block + 4);
    float* ob = out + b * block;
    const float s = load_scale(r, block, VEC);
    if (VEC) {
      for (int g = lane; g < words; g += 32) {
        const uint32_t w = reinterpret_cast<const uint32_t*>(r)[g];
        reinterpret_cast<float4*>(ob)[g] = make_float4(
            __fmul_rn(q_value<W>(w), s), __fmul_rn(q_value<W>(w >> 8), s),
            __fmul_rn(q_value<W>(w >> 16), s), __fmul_rn(q_value<W>(w >> 24), s));
      }
    } else {
      for (int j = lane; j < block; j += 32) ob[j] = __fmul_rn(q_value<W>(r[j]), s);
    }
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || sms <= 0) {
      sms = 132;
    }
    cached[dev] = sms;
  }
  return cached[dev];
}

// One warp per quantization block; enough thread blocks to fill every
// SM several times over, the grid-stride loops cover the rest.
unsigned grid_for(int64_t warps) {
  int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }
bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; }

template <int W, bool DEQ>
void launch_quant(const float* x, uint8_t* p, float* deq, int64_t nblocks, int block,
                  float inv_qmax, cudaStream_t s) {
  const bool vec = block % 4 == 0 && aligned16(x) && aligned4(p) &&
                   (!DEQ || aligned16(deq));
  const unsigned grid = grid_for(nblocks);
  if (vec) {
    quant_pack_kernel<W, DEQ, true><<<grid, kThreads, 0, s>>>(x, p, deq, nblocks, block, inv_qmax);
  } else {
    quant_pack_kernel<W, DEQ, false><<<grid, kThreads, 0, s>>>(x, p, deq, nblocks, block, inv_qmax);
  }
}

}  // namespace

// Each entry returns the cudaError_t of its launch (0 on success) and
// launches on `stream` without synchronising.

extern "C" int hvd_quant_pack(const void* x, void* packed, void* deq, long long nblocks,
                              int block, int wire, float inv_qmax, void* stream) {
  if (nblocks < 0 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  uint8_t* p = static_cast<uint8_t*>(packed);
  float* d = static_cast<float*>(deq);
  if (wire == kInt8) {
    if (d) launch_quant<kInt8, true>(xf, p, d, nblocks, block, inv_qmax, s);
    else launch_quant<kInt8, false>(xf, p, d, nblocks, block, inv_qmax, s);
  } else if (wire == kFp8) {
    if (d) launch_quant<kFp8, true>(xf, p, d, nblocks, block, inv_qmax, s);
    else launch_quant<kFp8, false>(xf, p, d, nblocks, block, inv_qmax, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_dequant_accum(const void* recv, void* out, int n, long long nb,
                                 int block, int wire, void* stream) {
  if (n < 1 || nb < 0 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(recv);
  float* o = static_cast<float*>(out);
  const bool vec = block % 4 == 0 && aligned4(r) && aligned16(o);
  const unsigned grid = grid_for(nb);
  if (wire == kInt8) {
    if (vec) dequant_accum_kernel<kInt8, true><<<grid, kThreads, 0, s>>>(r, o, n, nb, block);
    else dequant_accum_kernel<kInt8, false><<<grid, kThreads, 0, s>>>(r, o, n, nb, block);
  } else if (wire == kFp8) {
    if (vec) dequant_accum_kernel<kFp8, true><<<grid, kThreads, 0, s>>>(r, o, n, nb, block);
    else dequant_accum_kernel<kFp8, false><<<grid, kThreads, 0, s>>>(r, o, n, nb, block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_dequant_rows(const void* packed, void* out, long long rows, int block,
                                int wire, void* stream) {
  if (rows < 0 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  float* o = static_cast<float*>(out);
  const bool vec = block % 4 == 0 && aligned4(p) && aligned16(o);
  const unsigned grid = grid_for(rows);
  if (wire == kInt8) {
    if (vec) dequant_rows_kernel<kInt8, true><<<grid, kThreads, 0, s>>>(p, o, rows, block);
    else dequant_rows_kernel<kInt8, false><<<grid, kThreads, 0, s>>>(p, o, rows, block);
  } else if (wire == kFp8) {
    if (vec) dequant_rows_kernel<kFp8, true><<<grid, kThreads, 0, s>>>(p, o, rows, block);
    else dequant_rows_kernel<kFp8, false><<<grid, kThreads, 0, s>>>(p, o, rows, block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
