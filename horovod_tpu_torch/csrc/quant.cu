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
// Numerics: csrc/quant_math.cuh, shared with the ring kernels B6 and B7
// (csrc/quant_ring.cu), bitwise with the plain PyTorch versions in
// horovod_tpu_torch/ops/quant_kernels.py.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_math.cuh"

namespace {

using namespace hvdq;

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

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
  for (int64_t b = warp_id(); b < nblocks; b += warp_count()) {
    warp_quant_block<W, VEC>(x + b * block, block, inv_qmax, lane, packed + b * (block + 4),
                             DEQ ? deq + b * block : nullptr);
  }
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
          const float4 p = dequant_word<W>(reinterpret_cast<const uint32_t*>(r)[g],
                                           load_scale(r, block, true));
          acc = i == 0 ? p : add_rn(acc, p);
        }
        reinterpret_cast<float4*>(ob)[g] = acc;
      }
    } else {
      for (int j = lane; j < block; j += 32) {
        float acc = 0.0f;
        for (int i = 0; i < n; ++i) {
          const uint8_t* r = recv + (static_cast<int64_t>(i) * nb + b) * row;
          const float p = dequant<W>(r[j], load_scale(r, block, false));
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
        reinterpret_cast<float4*>(ob)[g] =
            dequant_word<W>(reinterpret_cast<const uint32_t*>(r)[g], s);
      }
    } else {
      for (int j = lane; j < block; j += 32) ob[j] = dequant<W>(r[j], s);
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
