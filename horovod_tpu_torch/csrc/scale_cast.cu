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
// ResNet-50's 16,489,448-element bucket moves ~99 MB: about 30 us.
//
// Design against that bound.  The TPU kernel pads the buffer to 512x128
// tiles and copies it into the padded layout; here there is no padding
// and no extra copy, one pass over the buffer:
// - A unit is 4 elements when either side is float32 (16 bytes of it),
//   else 8 (16 bytes of a 2-byte type).  Lane l of a warp takes unit
//   base + l, so every warp-wide load and store covers 32 consecutive
//   units: 512 contiguous bytes on a 16-byte side, 256 on the 2-byte
//   side of a cast to or from float32 (8 bytes a lane; whole 128-byte
//   lines all the same; a cross-lane shuffle to make them 16 would cost
//   one shuffle per element).
// - A thread issues the loads of kUnroll units (kUnroll * 16 bytes)
//   before the first of their stores.
// - Every block takes one round of kThreads * kUnroll units, and the
//   grid has as many blocks as that takes: the hardware hands a finished
//   SM its next block.  A grid of one wave with equal spans per block,
//   and one wave striding by rounds, were both slower in same-run
//   measurements on the H100 (PERF.md §6).
// - Loads bypass L1 and stores stream (ld.global.nc.L1::no_allocate,
//   st.global.cs): 1-3% faster than plain loads and stores in same-run
//   measurements (PERF.md §6).
// - The last n % unit elements, and buffers that are not 16-byte
//   aligned, take a scalar loop.
// The scale is a kernel argument (the TPU kernel kept it in SMEM).
// Conversions use the round-to-nearest-even intrinsics, which compile to
// the same cvt.rn instructions PyTorch's own casts use on sm_90, so NaN,
// infinities, overflow and subnormals come out as torch.Tensor.to gives
// them.
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

constexpr int kThreads = 256;  // threads per block
constexpr int kUnroll = 4;     // units in flight per thread

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

// Elements per unit, and the bytes of a unit on each side.
template <int KI, int KO> struct Unit {
  static constexpr int kElems = (KI == kF32 || KO == kF32) ? 4 : 8;
  static constexpr int kInWords = kElems * sizeof(typename Bits<KI>::T) / 4;
  static constexpr int kOutWords = kElems * sizeof(typename Bits<KO>::T) / 4;
};

// A unit's 32-bit words: 4 (16 bytes) or 2 (8 bytes).
template <int W> struct Words { uint32_t w[W]; };

// Loads bypass L1 (ld.global.nc.L1::no_allocate) and stores stream
// (st.global.cs): each byte is touched once.
template <int W>
__device__ __forceinline__ Words<W> load_words(const void* p, long long unit) {
  Words<W> r;
  if constexpr (W == 4) {
    const uint4* q = reinterpret_cast<const uint4*>(p) + unit;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]) : "l"(q));
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(p) + unit;
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(r.w[0]), "=r"(r.w[1]) : "l"(q));
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store_words(void* p, long long unit, const Words<W>& r) {
  if constexpr (W == 4) {
    uint4* q = reinterpret_cast<uint4*>(p) + unit;
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(q), "r"(r.w[0]), "r"(r.w[1]), "r"(r.w[2]), "r"(r.w[3]) : "memory");
  } else {
    uint2* q = reinterpret_cast<uint2*>(p) + unit;
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};"
                 :: "l"(q), "r"(r.w[0]), "r"(r.w[1]) : "memory");
  }
}

// One unit, scaled and converted.  Little-endian: the low half of a
// 32-bit word is the lower-addressed element.
template <int KI, int KO>
__device__ __forceinline__ Words<Unit<KI, KO>::kOutWords> convert(
    const Words<Unit<KI, KO>::kInWords>& in, float scale) {
  using U = Unit<KI, KO>;
  float f[U::kElems];
#pragma unroll
  for (int j = 0; j < U::kElems; ++j) {
    if constexpr (KI == kF32) {
      f[j] = __uint_as_float(in.w[j]);
    } else {
      const uint32_t w = in.w[j / 2];
      f[j] = to_f32<KI>(static_cast<uint16_t>((j & 1) ? (w >> 16) : (w & 0xffffu)));
    }
    f[j] *= scale;
  }
  Words<U::kOutWords> out;
#pragma unroll
  for (int j = 0; j < U::kOutWords; ++j) {
    if constexpr (KO == kF32) {
      out.w[j] = __float_as_uint(f[j]);
    } else {
      out.w[j] = static_cast<uint32_t>(from_f32<KO>(f[2 * j])) |
                 (static_cast<uint32_t>(from_f32<KO>(f[2 * j + 1])) << 16);
    }
  }
  return out;
}

template <int KI, int KO>
__device__ __forceinline__ void scale_one(const void* x, void* y, long long i, float scale) {
  const auto b = reinterpret_cast<const typename Bits<KI>::T*>(x)[i];
  reinterpret_cast<typename Bits<KO>::T*>(y)[i] = from_f32<KO>(to_f32<KI>(b) * scale);
}

// Block b converts the kThreads * kUnroll units from b * kThreads *
// kUnroll, thread t the units at t + u * kThreads: all kUnroll loads,
// then the stores.  The last block also takes the n - units * elems tail
// element-wise.
template <int KI, int KO>
__global__ void __launch_bounds__(kThreads)
scale_cast_vec(const void* __restrict__ x, void* __restrict__ y, float scale, long long n,
               long long units) {
  using U = Unit<KI, KO>;
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  Words<U::kInWords> v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < units) v[u] = load_words<U::kInWords>(x, i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < units) store_words<U::kOutWords>(y, i, convert<KI, KO>(v[u], scale));
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (long long i = units * U::kElems + threadIdx.x; i < n; i += kThreads) {
      scale_one<KI, KO>(x, y, i, scale);
    }
  }
}

// Buffers that are not 16-byte aligned.
template <int KI, int KO>
__global__ void __launch_bounds__(kThreads)
scale_cast_scalar(const void* __restrict__ x, void* __restrict__ y, float scale, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
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
void launch(const void* x, void* y, long long n, float scale, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
  if (aligned) {
    const long long units = n / Unit<KI, KO>::kElems;
    long long blocks = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    if (blocks < 1) blocks = 1;
    scale_cast_vec<KI, KO><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, y, scale, n, units);
  } else {
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sm_count()) * 8;
    if (blocks > cap) blocks = cap;
    scale_cast_scalar<KI, KO><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, y, scale, n);
  }
}

template <int KI>
int dispatch_out(const void* x, void* y, int out_kind, long long n, float scale,
                 cudaStream_t s) {
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

