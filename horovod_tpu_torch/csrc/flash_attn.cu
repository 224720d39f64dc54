// Kernel B2: the flash-attention forward.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_flash_fwd_kernel
// (launched by _flash_forward).  For each (batch b, head h, query row i)
// of q, k, v in the [B, T, H, D] layout it computes, as the TPU kernel:
//   s    = (q_i . k_j) * scale                  (float32, from dtype inputs)
//   mask = j < T  [and i >= j when causal]  [and seg_i == seg_j when packed]
//   s    = mask ? s : -1e30
// then an online softmax over key tiles, in float32:
//   m'   = max(m, rowmax(s));  ms = (m' <= -1e30) ? 0 : m'
//   p    = mask ? exp(s - ms) : 0
//   c    = exp(((m <= -1e30) ? -1e30 : m) - ms)
//   l    = l * c + rowsum(p);  acc = acc * c + p.to(dtype) . v;  m = m'
// and at the end
//   out  = (acc / (l == 0 ? 1 : l)).to(dtype)
//   lse  = (l == 0) ? -1e30 : m + log(max(l, 1e-37))     (float32, [B, H, T])
// p is rounded to the input dtype before p.v (bf16 on the model's path),
// with float32 accumulation, as the TPU kernel does.
//
// Bound.  At the GPT-2-small step (B 16, T 1024, H 12, D 64, bf16,
// causal) the function reads q, k, v and writes out and lse: 101.4 MB,
// 30.3 us at 3.35 TB/s; its two products are 25.8 GFLOP, 26.1 us at
// 989 TFLOP/s.  So it is bound by bytes when causal and by operations
// (51.6 GFLOP, 52.2 us) when not: both bounds are close, and the score
// matrix, T x T per head, must never reach device memory.
//
// Design.  One thread block (4 warps) per (b, h, 64-query tile), looping
// over 64-key tiles: the scores stay in registers, so device memory sees
// q, k, v once per tile pair and out and lse once.  Key tiles above the
// causal diagonal are skipped.  Tiles are read straight from the
// [B, T, H, D] layout by strides (q, k and v may be strided views of one
// qkv tensor), 16 bytes a thread, into shared memory rows padded by 16
// bytes so that the fragment reads of 8 rows hit distinct banks; rows
// past T are zero and masked.  Each warp owns 16 query rows.
//   bf16: both products on the tensor cores with mma.sync m16n8k16
//     (bf16 in, float32 accumulate).  The query fragments stay in
//     registers for the whole loop; the score accumulators, rounded to
//     bf16, are reused in place as the A fragments of p.v (the m16n8
//     accumulator layout of two neighbouring n-tiles is the m16k16 A
//     layout); v is stored transposed in shared memory so that its B
//     fragments are 32-bit reads.
//   float32: the same tile loop with the same per-thread layout of the
//     scores, on FFMA; p goes through shared memory for p.v.
// Rows are reduced across the 4 threads of a quad with shuffles.  Not
// yet done (later work): wgmma, TMA, a pipeline of tiles, warp
// specialisation.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // [B, T] int32, contiguous, or null
  void* out;       // [B, T, H, D], contiguous
  float* lse;      // [B, H, T], contiguous
  long long q_sb, q_st, q_sh;  // element strides of b, t, h (d is 1)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int B, T, H;
  float scale;
  int causal;
};

// Shared-memory layout, in elements of T unless named otherwise.
template <typename T, int D>
struct Layout {
  static constexpr bool kIsF32 = std::is_same<T, float>::value;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kPitch = D + kPad;         // q, k rows (and v rows for f32)
  static constexpr int kVtPitch = kBlockK + kPad; // bf16: v transposed, [D][kBlockK]
  static constexpr int kPPitch = kBlockK + 4;     // f32: p rows, floats
  static constexpr int kQ = kBlockQ * kPitch;
  static constexpr int kK = kBlockK * kPitch;
  static constexpr int kV = kIsF32 ? kBlockK * kPitch : D * kVtPitch;
  static constexpr size_t kPBytes = kIsF32 ? sizeof(float) * kWarps * 16 * kPPitch : 0;
  static constexpr size_t kBytes =
      sizeof(T) * (kQ + kK + kV) + kPBytes + sizeof(int) * kBlockK;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [t0, t0 + 64) of one (b, h) slice into shared memory rows of
// `pitch` elements, zero past T; TRANSPOSE stores element (r, d) at
// [d * pitch + r] instead.
template <typename T, int D, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* src, long long st, int t0,
                                          int T_) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T_) val = *reinterpret_cast<const uint4*>(src + (t0 + r) * st + c);
    if (TRANSPOSE) {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[(c + j) * pitch + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  using L = Layout<T, D>;
  constexpr bool kIsF32 = L::kIsF32;
  constexpr int kNT = D / 8;  // 8-column tiles of the output row

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + L::kQ;
  T* vs = ks + L::kK;
  float* ps = reinterpret_cast<float*>(vs + L::kV);
  int* segk = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(ps) + L::kPBytes);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the warp's 8-row half
  const int tig = lane & 3;  // thread in the quad
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T_ = a.T;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  // This thread's two query rows: g and g + 8 of the warp's 16.
  int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int segq[2] = {-1, -1};
  if (a.seg) {
    for (int i = 0; i < 2; ++i)
      if (rows[i] < T_) segq[i] = a.seg[(long long)b * T_ + rows[i]];
  }

  load_tile<T, D, false>(qs, L::kPitch, qg, a.q_st, q0, T_);
  __syncthreads();

  // bf16: the warp's query A fragments, one per 16-wide slice of D.
  uint32_t qa[kIsF32 ? 1 : D / 16][4];
  if constexpr (!kIsF32) {
    const T* qw = qs + (warp * 16 + g) * L::kPitch + tig * 2;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      qa[kc][0] = ld32(qw + kc * 16);
      qa[kc][1] = ld32(qw + 8 * L::kPitch + kc * 16);
      qa[kc][2] = ld32(qw + kc * 16 + 8);
      qa[kc][3] = ld32(qw + 8 * L::kPitch + kc * 16 + 8);
    }
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float o[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;

  int n_kt = (T_ + kBlockK - 1) / kBlockK;
  if (a.causal) n_kt = min(n_kt, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile has been consumed
    load_tile<T, D, false>(ks, L::kPitch, kg, a.k_st, k0, T_);
    if constexpr (kIsF32) {
      load_tile<T, D, false>(vs, L::kPitch, vg, a.v_st, k0, T_);
    } else {
      load_tile<T, D, true>(vs, L::kVtPitch, vg, a.v_st, k0, T_);
    }
    if (a.seg && threadIdx.x < kBlockK) {
      const int t = k0 + threadIdx.x;
      segk[threadIdx.x] = t < T_ ? a.seg[(long long)b * T_ + t] : -1;
    }
    __syncthreads();

    // Scores of the warp's 16 rows against the tile's 64 keys: s[j][c]
    // is row rows[c >> 1], key k0 + j * 8 + tig * 2 + (c & 1).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    if constexpr (kIsF32) {
      const float* qr0 = qs + (warp * 16 + g) * L::kPitch;
      const float* qr1 = qr0 + 8 * L::kPitch;
      const float* kr = ks + tig * 2 * L::kPitch;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float x0 = qr0[d], x1 = qr1[d];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y0 = kr[(j * 8) * L::kPitch + d];
          const float y1 = kr[(j * 8 + 1) * L::kPitch + d];
          s[j][0] = fmaf(x0, y0, s[j][0]);
          s[j][1] = fmaf(x0, y1, s[j][1]);
          s[j][2] = fmaf(x1, y0, s[j][2]);
          s[j][3] = fmaf(x1, y1, s[j][3]);
        }
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const T* kr = ks + (j * 8 + g) * L::kPitch + kc * 16 + tig * 2;
          mma_bf16(s[j], qa[kc], ld32(kr), ld32(kr + 8));
        }
      }
    }

    // Scale, mask, and the row maxima.
    uint32_t keep = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = rows[c >> 1];
        const int col = k0 + j * 8 + tig * 2 + (c & 1);
        bool ok = col < T_;
        if (a.causal) ok = ok && row >= col;
        if (a.seg) ok = ok && segq[c >> 1] == segk[col - k0];
        const float v = ok ? s[j][c] * a.scale : kNegInf;
        s[j][c] = v;
        keep |= static_cast<uint32_t>(ok) << (j * 4 + c);
        mx[c >> 1] = fmaxf(mx[c >> 1], v);
      }
    }
    float ms[2], corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      ms[i] = m_new <= kNegInf ? 0.0f : m_new;
      corr[i] = expf((m[i] <= kNegInf ? kNegInf : m[i]) - ms[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (keep >> (j * 4 + c)) & 1u ? expf(s[j][c] - ms[c >> 1]) : 0.0f;
        s[j][c] = p;
        sum[c >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
      sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // acc += p . v
    if constexpr (kIsF32) {
      float* pw = ps + warp * 16 * L::kPPitch;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pw[((c >> 1) * 8 + g) * L::kPPitch + j * 8 + tig * 2 + (c & 1)] = s[j][c];
      }
      __syncwarp();
      const float* vc = vs + tig * 2;
#pragma unroll 4
      for (int kk = 0; kk < kBlockK; ++kk) {
        const float p0 = pw[g * L::kPPitch + kk];
        const float p1 = pw[(g + 8) * L::kPPitch + kk];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float v0 = vc[kk * L::kPitch + nt * 8];
          const float v1 = vc[kk * L::kPitch + nt * 8 + 1];
          o[nt][0] = fmaf(p0, v0, o[nt][0]);
          o[nt][1] = fmaf(p0, v1, o[nt][1]);
          o[nt][2] = fmaf(p1, v0, o[nt][2]);
          o[nt][3] = fmaf(p1, v1, o[nt][3]);
        }
      }
      __syncwarp();  // p is read before the next tile overwrites it
    } else {
#pragma unroll
      for (int kc = 0; kc < kBlockK / 16; ++kc) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kc][0], s[2 * kc][1]), pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const T* vr = vs + (nt * 8 + g) * L::kVtPitch + kc * 16 + tig * 2;
          mma_bf16(o[nt], pa, ld32(vr), ld32(vr + 8));
        }
      }
    }
  }

  // out = acc / l, lse; rows past T are never stored.
  T* og = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= T_) continue;
    const float den = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = og + (((long long)b * T_ + row) * a.H + h) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float x = __fdiv_rn(o[nt][2 * i], den);
      const float y = __fdiv_rn(o[nt][2 * i + 1], den);
      if constexpr (kIsF32) {
        *reinterpret_cast<float2*>(orow + nt * 8) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) = __floats2bfloat162_rn(x, y);
      }
    }
    if (tig == 0) {
      a.lse[((long long)b * a.H + h) * T_ + row] =
          l[i] == 0.0f ? kNegInf : m[i] + logf(fmaxf(l[i], 1e-37f));
    }
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.T + kBlockQ - 1) / kBlockQ, a.H, a.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, T, H, D] with the given element strides for b, t and h
// (d contiguous; every row 16-byte aligned); seg: [B, T] int32 or null;
// out: [B, T, H, D] contiguous; lse: [B, H, T] float32 contiguous.
// dtype: 0 float32, 1 bfloat16.  D: 16, 32, 64 or 128.
extern "C" int hvd_flash_fwd(const void* q, long long q_sb, long long q_st, long long q_sh,
                             const void* k, long long k_sb, long long k_st, long long k_sh,
                             const void* v, long long v_sb, long long v_st, long long v_sh,
                             const int* seg, void* out, float* lse, int dtype, int B, int T,
                             int H, int D, float scale, int causal, void* stream) {
  if (B < 0 || T < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || H == 0) return 0;
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, seg, out, lse, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
         v_sb, v_st, v_sh, B, T, H, scale, causal};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(a, D, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
