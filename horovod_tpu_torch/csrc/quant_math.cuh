// Device functions of the quantized wire, shared by quant.cu (kernels
// B3, B4, B5) and quant_ring.cu (B6, B7), so the ring and the
// three-kernel lowering quantize and accumulate with the same bits.
// Counterpart of horovod_tpu/ops/pallas_quant.py::_quant_math (:79) and
// _accum_math (:99), which the JAX package shares the same way.
//
// Numerics (bitwise with the plain PyTorch versions in
// horovod_tpu_torch/ops/quant_kernels.py):
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
// - A dequant is q * s rounded once (__fmul_rn); a sum of dequants
//   rounds each product and each sum (__fmul_rn, __fadd_rn): no FMA
//   contraction, as PyTorch's separate multiply and add.
//
// The packed wire row of one block is block + 4 bytes: the q bytes, then
// the float32 scale, little-endian.  At block % 4 == 0 rows are 4-byte
// aligned (not 16-byte aligned at block 512), so the vector paths move
// four q bytes as one 32-bit word and the scale as one word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hvdq {

constexpr int kInt8 = 0;
constexpr int kFp8 = 1;
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

template <int W>
__device__ __forceinline__ float dequant(uint32_t byte, float s) {
  return __fmul_rn(q_value<W>(byte), s);
}

// The four dequants of one 32-bit word of q bytes.
template <int W>
__device__ __forceinline__ float4 dequant_word(uint32_t w, float s) {
  return make_float4(dequant<W>(w, s), dequant<W>(w >> 8, s),
                     dequant<W>(w >> 16, s), dequant<W>(w >> 24, s));
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ void observe(float v, float& amax, bool& bad) {
  amax = fmaxf(amax, fabsf(v));
  bad |= (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;  // inf or NaN
}

struct BlockScale {
  float safe;   // the divisor
  float scale;  // the wire scale: safe, or NaN for a non-finite block
  bool bad;     // the block holds inf or NaN: q = 0
};

// One warp reads one block of `block` floats (float4 when VEC: block % 4
// == 0 and xb 16-byte aligned) and returns its scale on every lane.
template <bool VEC>
__device__ __forceinline__ BlockScale warp_block_scale(const float* xb, int block,
                                                       float inv_qmax, int lane) {
  float amax = 0.0f;
  bool bad = false;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    for (int g = lane; g < block / 4; g += 32) {
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
  return {safe, bad ? __uint_as_float(kNaN) : safe, bad};
}

// Four elements -> one word of q bytes, and their dequants in `deq`.
template <int W>
__device__ __forceinline__ uint32_t quant_word(float4 v, const BlockScale& bs, float4& deq) {
  uint32_t q0 = 0, q1 = 0, q2 = 0, q3 = 0;
  if (!bs.bad) {
    q0 = quantize<W>(v.x, bs.safe); q1 = quantize<W>(v.y, bs.safe);
    q2 = quantize<W>(v.z, bs.safe); q3 = quantize<W>(v.w, bs.safe);
  }
  const uint32_t w = q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
  deq = dequant_word<W>(w, bs.scale);
  return w;
}

// One warp quantizes one block and stores its packed row at `row` (B3)
// and, when `deq` is not null, its dequant there.
template <int W, bool VEC>
__device__ __forceinline__ void warp_quant_block(const float* xb, int block, float inv_qmax,
                                                 int lane, uint8_t* row, float* deq) {
  const BlockScale bs = warp_block_scale<VEC>(xb, block, inv_qmax, lane);
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    for (int g = lane; g < block / 4; g += 32) {
      float4 d;
      const uint32_t w = quant_word<W>(x4[g], bs, d);
      reinterpret_cast<uint32_t*>(row)[g] = w;
      if (deq) reinterpret_cast<float4*>(deq)[g] = d;
    }
    if (lane == 0) reinterpret_cast<uint32_t*>(row)[block / 4] = __float_as_uint(bs.scale);
  } else {
    for (int i = lane; i < block; i += 32) {
      const uint32_t q = bs.bad ? 0u : quantize<W>(xb[i], bs.safe);
      row[i] = static_cast<uint8_t>(q);
      if (deq) deq[i] = dequant<W>(q, bs.scale);
    }
    if (lane < 4) row[block + lane] = static_cast<uint8_t>(__float_as_uint(bs.scale) >> (8 * lane));
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

}  // namespace hvdq
