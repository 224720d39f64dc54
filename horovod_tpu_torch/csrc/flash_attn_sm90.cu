// Kernel B2 on Hopper: the flash-attention forward for bf16 q, k, v with
// head dim 64 or 128, on wgmma and TMA.
//
// Replaces horovod_tpu/ops/pallas_kernels.py::_flash_fwd_kernel
// (launched by _flash_forward, pl.pallas_call at :309).  It computes
// the same function as csrc/flash_attn.cu, the kernel it takes over from
// for these dtypes and head dims (that one stays for float32 and for bf16
// at head dims 16 and 32): for each (b, h, query row i) of [B, T, H, D]
// inputs,
//   s    = (q_i . k_j) * scale                  (float32, from bf16 inputs)
//   mask = j < T  [and i >= j when causal]  [and seg_i == seg_j when packed]
//   s    = mask ? s : -1e30
// then an online softmax over 128-key tiles, in float32:
//   m'   = max(m, rowmax(s));  ms = (m' <= -1e30) ? 0 : m'
//   p    = mask ? exp(s - ms) : 0
//   c    = exp(((m <= -1e30) ? -1e30 : m) - ms)
//   l    = l * c + rowsum(p);  acc = acc * c + p.to(bf16) . v;  m = m'
// and at the end
//   out  = (acc / (l == 0 ? 1 : l)).to(bf16)
//   lse  = (l == 0) ? -1e30 : m + log(max(l, 1e-37))      (float32, [B, H, T])
// The scores are kept in log2 units (scale * log2 e folded in, one FFMA
// per exponent on unmasked tiles, exp2 on the special-function unit).
// A masked score is -inf here: the running maximum starts at the -1e30
// sentinel, so m, m_safe and c are the TPU kernel's, and p = exp2(-inf)
// is exactly +0, the TPU kernel's p = 0 where masked.  p is rounded to
// bf16 against the running maximum of each 128-key tile, so the plain
// version is compared with block_k = 128.
//
// Bound.  At the GPT-2-small step (B 16, T 1024, H 12, D 64, bf16,
// causal) the function reads q, k, v and writes out and lse: 101.4 MB,
// 0.0303 ms at 3.35 TB/s; its two products are 25.8 GFLOP, 0.0261 ms at
// 989 TFLOP/s.  Bytes and operations bound it alike, so the kernel must
// both keep the tensor cores fed and touch device memory once: the
// score matrix, T x T per head, never leaves registers.
//
// Design (what it does about that bound):
// * Work items are (b, h, 128-query tile).  The grid is persistent: one
//   block per SM walks items i, i + grid, ...; items are ordered query
//   tile first, heaviest first under the causal mask, so every block
//   gets a like share of the work and the grid does not end on a tail
//   of its longest items.  A block has two consumer warpgroups of 64
//   query rows each and one producer warp; the producer warpgroup gives
//   its registers to the consumers (setmaxnreg).
// * Loads: TMA.  Q is double-buffered, so the next item's Q is loaded
//   while this one runs; K and V go through a ring of shared-memory
//   stages (4 at D 64, 2 at D 128, continuing from item to item) with
//   128-byte swizzle and mbarrier "full" (K, V) and "empty" barriers per
//   stage.  The tensor maps describe q, k, v as 4-D [D, H, T, B] tensors
//   by their byte strides (views of one qkv tensor are read in place);
//   rows past T come back as zeros, and the mask drops them.  A box is
//   64 columns (128 bytes, the swizzle's span) by 128 rows, so D 128
//   takes two boxes per tile.
// * S = Q . K^T: wgmma m64n128k16, Q and K both K-major in shared
//   memory.  O += P . V: wgmma m64n64k16 (one per 64 columns of D) with
//   P in registers, the S accumulators rounded to bf16 in place (the
//   accumulator layout of m64nN is the register-A layout of the next
//   wgmma, in bf16 pairs), and V read MN-major through the descriptor's
//   transpose bit: V is never transposed by stores.
// * Overlap.  P . V of tile j is issued with S of tile j + 1, so the
//   softmax of j + 1 runs while the tensor cores do P . V; and the two
//   consumer warpgroups take turns to issue their products (named
//   barriers), so one's softmax overlaps the other's products.  The loop
//   after the first tile has no branch that touches a wgmma operand,
//   and the operands are fenced around each batch: otherwise ptxas
//   serializes every wgmma (warnings C7514-C7519).
// * Only tiles that cross the causal diagonal or hold the ragged end of
//   T are masked, with selects; with segments every tile compares
//   segment ids, which the producer warp writes into the stage beside K.
//   Rows are reduced across the 4 threads of a quad with shuffles.
// * Epilogue: each warp stages its 16 rows of out in its (dead) Q rows
//   and writes whole 128-byte lines, 16 bytes a thread; lse from
//   registers.
// Not done yet (later work): more warpgroups in flight at D 64 (there a
// warpgroup's exponentials take the special-function unit as long as
// its products take the tensor cores, so two warpgroups cannot hide
// each other), a TMA store of out.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch (a negative CUresult when a
// tensor map cannot be encoded).  cuTensorMapEncodeTiled is a driver
// API function: it is obtained through cudaGetDriverEntryPoint, so the
// library links against the runtime only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block
constexpr int kBlockK = 128;  // keys per tile
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxCols = 64;  // bf16 columns of one 128-byte swizzle span
constexpr int kRegion = kBlockK * 128;  // bytes of 128 rows of one box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBlockQ == kBlockK, "the causal tile count assumes square tiles");

struct Params {
  const int* seg;  // [B, T] int32, contiguous, or null
  __nv_bfloat16* out;  // [B, T, H, D], contiguous
  float* lse;  // [B, H, T], contiguous
  int B, T, H;
  int n_qt;  // query tiles
  float scale_log2;  // scale * log2(e)
  int causal;
};

// Shared memory, in bytes from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
template <int D>
struct Smem {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kTile = kBoxes * kRegion;  // one Q, K or V tile
  static constexpr int kQ = 0;  // two Q tiles: the next item's loads early
  static constexpr int kK = kQ + 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kSeg = kV + kStages * kTile;  // int[kStages][kBlockK]
  static constexpr int kBar = kSeg + kStages * kBlockK * 4;
  static constexpr int kBars = 4 + 3 * kStages;  // qfull[2], qempty[2], kfull[], vfull[], empty[]
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment slack
  // One block per SM: the consumers take the producer's registers, so a
  // second block must not fit beside it.
  static_assert(2 * kBytes > 228 * 1024, "two blocks would fit on one SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` of the barrier to complete.  The
// spin is one asm block: a bound on it (a timer and a trap) costs the
// D 128 consumers the registers that keep their wgmma asynchronous.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Box (c0 .. c0 + 63, head, rows t0 .. t0 + 127, batch) of a [D, H, T, B]
// tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int head, int t0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(head), "r"(t0), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose
// 8-row groups are 1024 bytes apart (the stride byte offset, SBO), with
// leading byte offset `lbo`.  A K-major operand's 16-element depth stays
// inside one 128-byte row, so its LBO is unused (1, as CUTLASS sets it);
// an MN-major operand is taken 64 columns (one swizzle span) per
// instruction, so the LBO, the distance to the next 64 columns, is
// unused as well, and is set equal to the SBO.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return sw128_desc(addr, 16); }
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) { return sw128_desc(addr, 1024); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= a . b, m64n128k16: a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a . b, m64n64k16: a in registers, b MN-major in shared memory
// (the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Scale to log2 units, mask (MASK: the tile crosses the causal diagonal,
// holds the end of T, or the rows are packed; one integer compare per
// score against a per-row limit, and a select to -inf), and fold the
// tile into the running softmax: s becomes p, and corr the factor by
// which the output so far must be rescaled.  An unmasked tile at a positive scale
// takes the maximum of the raw scores and one FFMA per exponent.  Thread layout of the m64n128
// accumulator: s[4j + c] is row rows[c >> 1], key
// k0 + 8j + 2·(lane % 4) + (c & 1).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&corr)[2], float (&m)[2],
                                             float (&l)[2], const Params& p, const int (&rows)[2],
                                             const int (&segq)[2], const int* segk, int k0,
                                             int tq) {
  float mx[2] = {kNegInf, kNegInf};
  if (!MASK && p.scale_log2 > 0.0f) {
    // The maximum of the raw scores, scaled once (a positive scale
    // commutes with rounding and max); p = exp2(s * scale - m) in one FFMA.
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
      ms[r] = m_new <= kNegInf ? 0.0f : m_new;
      corr[r] = ex2((m[r] <= kNegInf ? kNegInf : m[r]) - ms[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], p.scale_log2, -ms[r]));
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
    return;
  }
  // Key k0 + 2 tq + c_i, c_i = 8 (i / 4) + i % 2, is kept when c_i <=
  // lim[r] (inside T, and at or below row r under the causal mask) and
  // its segment is row r's.
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lim[r] = p.T - 1 - k0 - 2 * tq;
    if (p.causal) lim[r] = min(lim[r], rows[r] - k0 - 2 * tq);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = s[i] * p.scale_log2;
    if (MASK) {  // selects, no branches: s is a wgmma accumulator
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + (i & 1);
      const int sk = segk != nullptr ? segk[c + 2 * tq] : 0;
      const bool ok = (c <= lim[r]) & ((segk == nullptr) | (segq[r] == sk));
      x = ok ? x : -__int_as_float(0x7f800000);
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    ms[r] = m_new <= kNegInf ? 0.0f : m_new;
    corr[r] = ex2((m[r] <= kNegInf ? kNegInf : m[r]) - ms[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(s[i] - ms[r]);
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

template <int NB>
__device__ __forceinline__ void rescale(float (&o)[NB][32], const float (&corr)[2]) {
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] *= corr[(i >> 1) & 1];
}

// Issue O += P . V for one 128-key tile: V's rows are keys, 128 bytes
// each, 16 keys a step; one m64n64 product per 64 columns of D.
template <int NB>
__device__ __forceinline__ void pv(float (&o)[NB][32], const uint32_t (&pa)[8][4],
                                   uint32_t v_addr) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
#pragma unroll
    for (int x = 0; x < NB; ++x)
      wgmma_rs_n64(o[x], pa[kc], mnmajor_desc(v_addr + x * kRegion + kc * 16 * 128));
  }
}

// Where a block's i-th work item lies: query tile qt (heaviest first:
// under the causal mask a query tile's work grows with its index), head
// h, batch row b.
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ Item item_at(int i, const Params& p) {
  const int per_tile = p.H * p.B;
  const int rem = i % per_tile;
  return Item{p.n_qt - 1 - i / per_tile, rem % p.H, rem / p.H};
}

__device__ __forceinline__ int key_tiles(int qt, const Params& p) {
  const int n = (p.T + kBlockK - 1) / kBlockK;
  return p.causal ? min(n, qt + 1) : n;
}

// Named barriers 1 and 2: consumer warpgroup w waits on 1 + w for its
// turn to issue products, and hands the turn to the other.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + (cw ^ 1)) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Smem<D>;
  constexpr int kBoxes = L::kBoxes;
  constexpr int kStages = L::kStages;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* const segk_all = reinterpret_cast<int*>(smem_raw + (base - raw) + L::kSeg);
  const uint32_t bar_qfull = base + L::kBar;          // + 8 * Q buffer
  const uint32_t bar_qempty = bar_qfull + 16;         // + 8 * Q buffer
  const uint32_t bar_kfull = bar_qempty + 16;          // + 8 * stage
  const uint32_t bar_vfull = bar_kfull + 8 * kStages;  // + 8 * stage
  const uint32_t bar_empty = bar_vfull + 8 * kStages;  // + 8 * stage
  const int T = p.T;
  const int n_items = p.n_qt * p.H * p.B;

  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(bar_qfull + 8 * x, 1);
      mbar_init(bar_qempty + 8 * x, kConsumers * 4);  // every consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_kfull + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_vfull + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform: wgmma and its accumulators must stay off divergent paths, or
  // ptxas serializes every wgmma.
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // Producer: warp 0 issues every load; the warpgroup keeps 40 registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_q))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_k))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_v))
                     : "memory");
      }
      int it = 0;  // key tiles loaded, over every item: the ring's position
      int qi = 0;  // items loaded
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++qi) {
        const Item w = item_at(i, p);
        const int n_kt = key_tiles(w.qt, p);
        // Q buffer qi % 2: the consumers are done with the Q of item
        // qi - 2 (the first round passes on the fresh barrier).
        const int qb = qi & 1;
        mbar_wait(bar_qempty + 8 * qb, ((qi >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(bar_qfull + 8 * qb, L::kTile);
          for (int x = 0; x < kBoxes; ++x)
            tma_load(base + L::kQ + qb * L::kTile + x * kRegion, &tm_q, bar_qfull + 8 * qb,
                     x * kBoxCols, w.h, w.qt * kBlockQ, w.b);
        }
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStages;
          const int k0 = kt * kBlockK;
          // The consumers released this stage's previous tile.
          mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(bar_kfull + 8 * s, L::kTile);
            for (int x = 0; x < kBoxes; ++x)
              tma_load(base + L::kK + s * L::kTile + x * kRegion, &tm_k, bar_kfull + 8 * s,
                       x * kBoxCols, w.h, k0, w.b);
            mbar_arrive_expect_tx(bar_vfull + 8 * s, L::kTile);
            for (int x = 0; x < kBoxes; ++x)
              tma_load(base + L::kV + s * L::kTile + x * kRegion, &tm_v, bar_vfull + 8 * s,
                       x * kBoxCols, w.h, k0, w.b);
          }
          if (p.seg != nullptr) {
            int* segk = segk_all + s * kBlockK;
            for (int j = lane; j < kBlockK; j += 32) {
              const int t = k0 + j;
              segk[j] = t < T ? p.seg[static_cast<long long>(w.b) * T + t] : -1;
            }
          }
          mbar_arrive(bar_kfull + 8 * s);  // K's bytes and the segment ids
        }
      }
    }
  } else {
    // Consumer warpgroup cw: query rows 64 cw .. 64 cw + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tq = lane & 3;
    if (cw == 1) turn_pass(cw);  // warpgroup 0 issues first

    int it = 0;  // key tiles consumed, over every item: the ring's position
    int qi = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++qi) {
      const Item w = item_at(i, p);
      const int n_kt = key_tiles(w.qt, p);
      const int q0 = w.qt * kBlockQ;
      const int first_row = q0 + 64 * cw;
      const int row0 = first_row + 16 * warp + (lane >> 2);
      const int rows[2] = {row0, row0 + 8};
      int segq[2] = {-1, -1};
      if (p.seg != nullptr) {
        for (int r = 0; r < 2; ++r)
          if (rows[r] < T) segq[r] = p.seg[static_cast<long long>(w.b) * T + rows[r]];
      }

      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.0f, 0.0f};
      float corr[2];  // of the tile whose P . V is pending
      float o[kBoxes][32];
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[x][j] = 0.0f;
      uint32_t pa[8][4];  // P of the pending tile, bf16 pairs: the A operand
      float sacc[64];

      // Tile u's softmax: masked only where it crosses the causal
      // diagonal, holds the end of T, or the rows are packed.
      auto softmax = [&](int kt, int u) {
        const int k0 = kt * kBlockK;
        const bool masked = p.seg != nullptr || k0 + kBlockK > T ||
                            (p.causal && k0 + kBlockK - 1 > first_row);
        const int* segk = p.seg != nullptr ? segk_all + (u % kStages) * kBlockK : nullptr;
        if (masked) {
          softmax_tile<true>(sacc, corr, m, l, p, rows, segq, segk, k0, tq);
        } else {
          softmax_tile<false>(sacc, corr, m, l, p, rows, segq, segk, k0, tq);
        }
      };
      // S = Q . K^T of tile u, over D in steps of 16 (32 bytes along the
      // swizzled row).
      const uint32_t q_addr = base + L::kQ + (qi & 1) * L::kTile + cw * 64 * 128;
      auto issue_s = [&](int u) {
        const uint32_t k_addr = base + L::kK + (u % kStages) * L::kTile;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks / 4) * kRegion + (ks % 4) * 32;
          wgmma_ss_n128(sacc, kmajor_desc(q_addr + off), kmajor_desc(k_addr + off), ks > 0);
        }
        wgmma_commit();
      };
      // O = O * c + P . V of tile u (its V waited for here).
      auto issue_pv = [&](int u) {
        rescale(o, corr);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
        fence_regs(pa);
        mbar_wait(bar_vfull + 8 * (u % kStages), (u / kStages) & 1);
        wgmma_fence();
        pv(o, pa, base + L::kV + (u % kStages) * L::kTile);
        wgmma_commit();
      };
      // After P . V of tile u: its K and V may be overwritten.
      auto release = [&](int u) {
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * (u % kStages));
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int kc = 0; kc < 8; ++kc) {
          pa[kc][0] = pack_bf16(sacc[8 * kc + 0], sacc[8 * kc + 1]);
          pa[kc][1] = pack_bf16(sacc[8 * kc + 2], sacc[8 * kc + 3]);
          pa[kc][2] = pack_bf16(sacc[8 * kc + 4], sacc[8 * kc + 5]);
          pa[kc][3] = pack_bf16(sacc[8 * kc + 6], sacc[8 * kc + 7]);
        }
      };

      // The first tile: S and its softmax; its P . V goes with the next S.
      mbar_wait(bar_qfull + 8 * (qi & 1), (qi >> 1) & 1);
      mbar_wait(bar_kfull + 8 * (it % kStages), (it / kStages) & 1);
      turn_wait(cw);
      issue_s(it);
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax(0, it);
      pack_p();
      // Tile u = it + kt: S of u and P . V of u - 1 on the tensor cores,
      // then the softmax of u while P . V runs.  No branch here touches
      // a wgmma operand, so ptxas keeps the products asynchronous.
      for (int kt = 1; kt < n_kt; ++kt) {
        const int u = it + kt;
        mbar_wait(bar_kfull + 8 * (u % kStages), (u / kStages) & 1);
        turn_wait(cw);
        issue_s(u);
        issue_pv(u - 1);
        turn_pass(cw);
        wgmma_wait<1>();
        fence_regs(sacc);
        softmax(kt, u);
        wgmma_wait<0>();
        release(u - 1);
        pack_p();
      }
      it += n_kt;
      issue_pv(it - 1);
      wgmma_wait<0>();
      release(it - 1);

      // out = acc / l, and lse.  Each warp stages its 16 rows of out in
      // its own rows of the Q tile (read for the last time by the S
      // above), swizzled as the Q tile is so that neither side conflicts
      // on banks, then writes them as whole 128-byte lines, 16 bytes a
      // thread; rows past T are never stored.  The accumulators are read
      // on the uniform path; only the stores branch.
      {
        const uint32_t stage = q_addr + warp * 16 * 128;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float inv = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
          const int srow = (lane >> 2) + 8 * r;  // row within the warp's 16
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint32_t at = stage + x * kRegion + srow * 128 + ((j ^ (srow & 7)) << 4) +
                                  4 * tq;
              asm volatile("st.shared.u32 [%0], %1;" ::"r"(at),
                           "r"(pack_bf16(o[x][4 * j + 2 * r] * inv,
                                         o[x][4 * j + 2 * r + 1] * inv))
                           : "memory");
            }
        }
        __syncwarp();
        const int warp_row = first_row + 16 * warp;
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int srow = 4 * k + (lane >> 3);
            const int chunk = lane & 7;
            uint4 v;
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                         : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                         : "r"(stage + x * kRegion + srow * 128 + ((chunk ^ (srow & 7)) << 4))
                         : "memory");
            const int row = warp_row + srow;
            if (row < T) {
              __nv_bfloat16* dst = p.out +
                                   ((static_cast<long long>(w.b) * T + row) * p.H + w.h) * D +
                                   x * kBoxCols + 8 * chunk;
              *reinterpret_cast<uint4*>(dst) = v;
            }
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (tq == 0 && rows[r] < T) {
            p.lse[(static_cast<long long>(w.b) * p.H + w.h) * T + rows[r]] =
                l[r] == 0.0f ? kNegInf : m[r] * kLn2 + logf(fmaxf(l[r], 1e-37f));
          }
        }
        // This warp's Q rows are free for the item after next, whose Q
        // the TMA (the async proxy) writes there.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_qempty + 8 * (qi & 1));
      }
    }
    if (cw == 0) turn_wait(cw);  // takes warpgroup 1's last hand-over
  }
}

// The driver's cuTensorMapEncodeTiled, through the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [D, H, T, B] view of a [B, T, H, D] bf16 tensor with element strides
// sb, st, sh (d contiguous); boxes of 64 columns x 128 rows, 128-byte
// swizzle, zero fill past T.
int encode(CUtensorMap* map, const void* ptr, long long sb, long long st, long long sh, int B,
           int T, int H, int D) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBlockK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// Streaming multiprocessors of the current device (the persistent grid).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <int D>
int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, const Params& p,
           cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = static_cast<long long>(p.n_qt) * p.H * p.B;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: [B, T, H, D] bf16 with the given element strides for b, t and h
// (d contiguous; base and b/t/h strides 16-byte aligned, as TMA needs);
// seg: [B, T] int32 or null; out: [B, T, H, D] bf16 contiguous; lse:
// [B, H, T] float32 contiguous.  D: 64 or 128.
extern "C" int hvd_flash_fwd_sm90(const void* q, long long q_sb, long long q_st, long long q_sh,
                                  const void* k, long long k_sb, long long k_st, long long k_sh,
                                  const void* v, long long v_sb, long long v_st, long long v_sh,
                                  const int* seg, void* out, float* lse, int B, int T, int H,
                                  int D, float scale, int causal, void* stream) {
  if (B < 0 || T < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || H == 0) return 0;
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (T + kBlockQ - 1) / kBlockQ;
  if (static_cast<long long>(n_qt) * H * B > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, q_sb, q_st, q_sh, B, T, H, D);
  if (rc == 0) rc = encode(&tk, k, k_sb, k_st, k_sh, B, T, H, D);
  if (rc == 0) rc = encode(&tv, v, v_sb, v_st, v_sh, B, T, H, D);
  if (rc != 0) return rc;
  const Params p{seg, static_cast<__nv_bfloat16*>(out), lse, B, T, H, n_qt, scale * kLog2e,
                 causal};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(tq, tk, tv, p, s) : launch<128>(tq, tk, tv, p, s);
}

// Dynamic shared memory of one block at head dim D (64 or 128), for the
// build report; 0 for another D.
extern "C" int hvd_flash_fwd_sm90_smem(int D) {
  return D == 64 ? Smem<64>::kBytes : D == 128 ? Smem<128>::kBytes : 0;
}
