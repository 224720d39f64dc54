// Kernel B1: fused scale + cast, out[i] = cvt_rn(float(x[i]) * scale).
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_scale_cast_kernel (launched
// by _scale_buffer_impl, reached through scale_buffer / cast_buffer), the
// TPU analog of the reference's ScaleBufferCudaImpl and
// BatchedScaledD2DMemcpyCudaImpl.  On the data-parallel step it is the
// bf16 wire's down-cast and up-cast around every bucket's allreduce
// (sched/execute.py bf16_wire) and the fp32-staged scale of a bf16/f16
// buffer (ops/collectives.py _scale).
//
// Bound: memory.  Each element is read once and written once, with one
// multiply and one conversion in between, so the least time is
// (in + out bytes) / 3.35 TB/s on an H100 SXM.  The down-cast of
// ResNet-50's ~102 MB of f32 gradients to bf16 moves ~153 MB: about 46 us.
//
// Design against that bound.  The TPU kernel pads the buffer to 512x128
// tiles and copies it into the padded layout; here there is no padding
// and no extra copy: one pass, a grid-stride loop over 8-element groups
// moved with 16-byte vector loads and stores (two per group on the f32
// side), and a scalar tail for the last n % 8 elements.  Buffers that are
// not 16-byte aligned take the scalar loop throughout.  The scale is a
// kernel argument (the TPU kernel kept it in SMEM).  Conversions use the
// round-to-nearest-even intrinsics, which compile to the same cvt.rn
// instructions PyTorch's own casts use on sm_90, so NaN, infinities,
// overflow and subnormals come out as torch.Tensor.to gives them.
//
// Plain C interface, loaded with ctypes (horovod_tpu_torch/ops/kernels.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with the Python wrapper.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

constexpr int kVec = 8;        // elements per vector group
constexpr int kThreads = 256;  // threads per block

template <int K> struct Bits;
template <> struct Bits<kF32> { using T = uint32_t; };
template <> struct Bits<kBF16> { using T = uint16_t; };
template <> struct Bits<kF16> { using T = uint16_t; };

template <int K> __device__ __forceinline__ float to_f32(typename Bits<K>::T b);
template <> __device__ __forceinline__ float to_f32<kF32>(uint32_t b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ float to_f32<kBF16>(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
template <> __device__ __forceinline__ float to_f32<kF16>(uint16_t b) {
  return __half2float(__ushort_as_half(b));
}

template <int K> __device__ __forceinline__ typename Bits<K>::T from_f32(float f);
template <> __device__ __forceinline__ uint32_t from_f32<kF32>(float f) {
  return __float_as_uint(f);
}
template <> __device__ __forceinline__ uint16_t from_f32<kBF16>(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
template <> __device__ __forceinline__ uint16_t from_f32<kF16>(float f) {
  return __half_as_ushort(__float2half_rn(f));
}

// One group of kVec elements as floats: two uint4 loads for 4-byte types,
// one for 2-byte types.  Little-endian: the low half of a 32-bit word is
// the lower-addressed element.
template <int K> __device__ __forceinline__ void load_group(const void* p, int64_t g, float f[kVec]);
template <> __device__ __forceinline__ void load_group<kF32>(const void* p, int64_t g, float f[kVec]) {
  const uint4* q = reinterpret_cast<const uint4*>(p) + 2 * g;
  const uint4 a = q[0];
  const uint4 b = q[1];
  f[0] = __uint_as_float(a.x); f[1] = __uint_as_float(a.y);
  f[2] = __uint_as_float(a.z); f[3] = __uint_as_float(a.w);
  f[4] = __uint_as_float(b.x); f[5] = __uint_as_float(b.y);
  f[6] = __uint_as_float(b.z); f[7] = __uint_as_float(b.w);
}
template <int K> __device__ __forceinline__ void unpack_halves(const uint4 a, float f[kVec]) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = to_f32<K>(static_cast<uint16_t>(w[j] & 0xffffu));
    f[2 * j + 1] = to_f32<K>(static_cast<uint16_t>(w[j] >> 16));
  }
}
template <> __device__ __forceinline__ void load_group<kBF16>(const void* p, int64_t g, float f[kVec]) {
  unpack_halves<kBF16>(reinterpret_cast<const uint4*>(p)[g], f);
}
template <> __device__ __forceinline__ void load_group<kF16>(const void* p, int64_t g, float f[kVec]) {
  unpack_halves<kF16>(reinterpret_cast<const uint4*>(p)[g], f);
}

template <int K> __device__ __forceinline__ void store_group(void* p, int64_t g, const float f[kVec]);
template <> __device__ __forceinline__ void store_group<kF32>(void* p, int64_t g, const float f[kVec]) {
  uint4* q = reinterpret_cast<uint4*>(p) + 2 * g;
  q[0] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
  q[1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]),
                    __float_as_uint(f[6]), __float_as_uint(f[7]));
}
template <int K> __device__ __forceinline__ uint4 pack_halves(const float f[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = static_cast<uint32_t>(from_f32<K>(f[2 * j])) |
           (static_cast<uint32_t>(from_f32<K>(f[2 * j + 1])) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <> __device__ __forceinline__ void store_group<kBF16>(void* p, int64_t g, const float f[kVec]) {
  reinterpret_cast<uint4*>(p)[g] = pack_halves<kBF16>(f);
}
template <> __device__ __forceinline__ void store_group<kF16>(void* p, int64_t g, const float f[kVec]) {
  reinterpret_cast<uint4*>(p)[g] = pack_halves<kF16>(f);
}

template <int KI, int KO>
__device__ __forceinline__ void scale_one(const void* x, void* y, int64_t i, float scale) {
  const auto b = reinterpret_cast<const typename Bits<KI>::T*>(x)[i];
  reinterpret_cast<typename Bits<KO>::T*>(y)[i] = from_f32<KO>(to_f32<KI>(b) * scale);
}

// Vector body over n / kVec groups, then the n % kVec tail element-wise.
template <int KI, int KO>
__global__ void __launch_bounds__(kThreads)
scale_cast_vec(const void* __restrict__ x, void* __restrict__ y, float scale, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t groups = n / kVec;
  for (int64_t g = tid; g < groups; g += stride) {
    float f[kVec];
    load_group<KI>(x, g, f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[j] *= scale;
    store_group<KO>(y, g, f);
  }
  for (int64_t i = groups * kVec + tid; i < n; i += stride) {
    scale_one<KI, KO>(x, y, i, scale);
  }
}

// Fallback for buffers that are not 16-byte aligned.
template <int KI, int KO>
__global__ void __launch_bounds__(kThreads)
scale_cast_scalar(const void* __restrict__ x, void* __restrict__ y, float scale, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    scale_one<KI, KO>(x, y, i, scale);
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

template <int KI, int KO>
void launch(const void* x, void* y, int64_t n, float scale, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
  const int64_t work = aligned ? (n + kVec - 1) / kVec : n;
  // Enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest.
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (aligned) {
    scale_cast_vec<KI, KO><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, y, scale, n);
  } else {
    scale_cast_scalar<KI, KO><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, y, scale, n);
  }
}

template <int KI>
int dispatch_out(const void* x, void* y, int out_kind, int64_t n, float scale, cudaStream_t s) {
  switch (out_kind) {
    case kF32: launch<KI, kF32>(x, y, n, scale, s); break;
    case kBF16: launch<KI, kBF16>(x, y, n, scale, s); break;
    case kF16: launch<KI, kF16>(x, y, n, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Launches on
// `stream` without synchronising; n == 0 launches nothing.
extern "C" int hvd_scale_cast(const void* x, int in_kind, void* out, int out_kind,
                              long long n, float scale, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case kF32: return dispatch_out<kF32>(x, out, out_kind, n, scale, s);
    case kBF16: return dispatch_out<kBF16>(x, out, out_kind, n, scale, s);
    case kF16: return dispatch_out<kF16>(x, out, out_kind, n, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
