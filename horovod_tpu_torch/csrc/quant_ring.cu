// Kernels B6 and B7: the single-kernel quantized rings over NVLink.
//
// B6, rs_ring: one quantized reduce-scatter per launch.  Per rank, n
//   chunks of c = nb * block float32 go in; out come the float32 sum of
//   this rank's chunk over all ranks (`acc`, c) and, for error feedback,
//   B3's dequant of every chunk in chunk order (`deq`, n * c).  Each
//   chunk is quantized once, by its producer; the packed row (q ||
//   float32 scale) of chunk (my + t) % n is stored straight into receive
//   slot t of rank (my + t) % n through its peer-mapped pointer; the
//   arrivals are summed in hop order (own chunk, then sources my - 1,
//   my - 2, ...), each product and each sum rounded as B4 rounds them.
//   Replaces horovod_tpu/ops/pallas_quant.py::_rs_ring_tpu (:477, body
//   _rs_ring_kernel :371).
// B7, ag_ring: one quantized all-gather per launch.  The shard (c
//   float32) is quantized once, its packed row stored into every peer's
//   receive slot for this source and its dequant into out[my]; each
//   arrival is dequantized into out[src].  Bitwise equal to B3 + an
//   all-gather + B5: the result does not depend on order.  Replaces
//   pallas_quant.py::_ag_ring_tpu (:563, body _ag_ring_kernel :515).
//
// Bound.  Both kernels do a few operations per byte: the least time is
// the larger of the device-memory bytes over 3.35 TB/s and the bytes a
// rank stores into its peers over NVLink's 450 GB/s each way.  B6 with
// the dequant reads n * c * 4 bytes, writes n * c * 4 (deq) + c * 4
// (acc), receives and reads (n - 1) packed chunks; B7 reads c * 4 and
// writes n * c * 4.  Each sends (n - 1) packed chunks of c * (1 + 4 /
// block) bytes.  At a world of 4 the device bytes bound both.
//
// Design against that bound.  The TPU kernel stages chunks through VMEM
// with double-buffered DMAs and keeps the float32 sum in VMEM.  Here a
// persistent grid of G thread blocks (at most the co-resident capacity,
// so the spins below cannot deadlock) cuts every chunk into G stripes of
// quantization blocks; block s owns stripe s of every chunk on every
// rank.  One warp quantizes one quantization block at a time with the
// device functions B3 uses (quant_math.cuh) and stores the packed row
// word by word straight into the peer's slot: no staging copy, the
// stores travel over NVLink while the next block is read.  The sum of a
// rank's own chunk and its n - 1 arrivals is kept in registers, one
// float4 per lane, and written once.  The packed payload is 1/4 of the
// float32 bytes, so the kernel moves about the bytes B3 + B4 move, in
// one launch, without the all-to-all's own pass over device memory.
// B7 goes further (its section below): its slots keep the q bytes apart
// from the scales, so a lane stores 16 bytes into each peer and a warp
// whole lines; it does not wait at the entry barrier, which its epochs
// make redundant; a block publishes its stripe to every peer after one
// system fence and stores its own dequant only after that; it
// dequantizes the arrivals in the order they land.
//
// Synchronisation.  Each rank's window (ops/peer.py allocates it, CUDA
// IPC maps it into the peers) holds two epoch-parity sets of n - 1
// receive slots, one flag per (parity, slot, stripe) and one barrier
// word per source rank.  Every launch carries a new epoch; flags hold
// epochs, so nothing is ever reset.  At entry, block 0 of every rank
// stores the epoch into its barrier word at every peer and every block
// waits until all peers have entered (the TPU kernel's barrier
// semaphore, :378-385): a peer that entered this launch has finished
// the previous one, so no slot is overwritten while it is read.  (B7
// announces itself but does not wait: the previous launch already
// proves what it needs; ag_ring_kernel says how.)  A
// sender's block fences its stores to system scope and then stores the
// epoch into the flag of its stripe at the receiver with st.release.sys;
// the receiver's block spins on ld.acquire.sys and reads the slot
// through L2 (ld.cg).  Every spin is bounded by %globaltimer: past the
// bound the block prints which flag it waited on and traps, so a broken
// protocol is a CUDA error and not a hung card.
//
// Per-rank arguments (inputs, outputs, windows) come in tables indexed
// by rank, in one __grid_constant__ struct (the device functions take
// its address without a per-thread copy), and a block's rank is rank0 +
// blockIdx.y: a real world launches grid.y = 1 on each card; the
// one-card check launches all n ranks' blocks in one grid, windows all
// on the one card.  Both launch with cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be co-resident.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "quant_math.cuh"

namespace {

using namespace hvdq;

constexpr int kMaxRanks = 16;
constexpr int kMaxStripes = 2048;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// __launch_bounds__(kThreads, kMinBlocks) caps the registers so that
// kMinBlocks blocks fit on every SM; the grid uses at most that many.
constexpr int kMinBlocks = 4;
constexpr long long kSlotAlign = 256;

struct RingArgs {
  const float* x[kMaxRanks];  // B6: (n, nb, block); B7: (nb, block)
  float* out[kMaxRanks];      // B6: acc (nb, block); B7: (n, nb, block)
  float* deq[kMaxRanks];      // B6 only, (n, nb, block), or null
  uint8_t* win[kMaxRanks];    // every rank's window, mapped here
  long long nb;               // quantization blocks per chunk
  long long slot_bytes;       // bytes per receive slot
  long long flags_off;        // byte offset of the flags in a window
  unsigned long long timeout_ns;
  int n, rank0, block;
  unsigned epoch;
  float inv_qmax;
  unsigned long long* trace;  // B7: kTraceEvents timestamps per block, or null
};

__device__ __forceinline__ uint8_t* slot(const RingArgs& a, int r, int parity, int hop) {
  return a.win[r] + static_cast<long long>(parity * (a.n - 1) + hop - 1) * a.slot_bytes;
}

__device__ __forceinline__ unsigned* flag(const RingArgs& a, int r, int parity, int hop,
                                          int stripe) {
  return reinterpret_cast<unsigned*>(a.win[r] + a.flags_off) +
         static_cast<long long>(parity * (a.n - 1) + hop - 1) * kMaxStripes + stripe;
}

__device__ __forceinline__ unsigned* barrier(const RingArgs& a, int r) {
  return reinterpret_cast<unsigned*>(a.win[r] + a.flags_off) +
         static_cast<long long>(2 * (a.n - 1)) * kMaxStripes;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p has reached `epoch`; past the deadline, say which flag
// and trap.
__device__ void wait_epoch(const unsigned* p, const RingArgs& a, unsigned long long deadline,
                           const char* kernel, const char* what, int rank, int index) {
  unsigned seen;
  while (static_cast<int>((seen = load_acquire(p)) - a.epoch) < 0) {
    if (now_ns() > deadline) {
      printf("%s: rank %d block %d timed out after %llu ns waiting for %s %d "
             "(epoch %u, flag holds %u)\n",
             kernel, rank, static_cast<int>(blockIdx.x), a.timeout_ns, what, index,
             a.epoch, seen);
      __trap();
    }
    __nanosleep(64);
  }
}

// Block 0 announces this rank at every peer.
__device__ __forceinline__ void announce(const RingArgs& a, int my) {
  const int t = threadIdx.x;
  if (blockIdx.x == 0 && t >= 1 && t < a.n) {
    store_release(barrier(a, (my + t) % a.n) + my, a.epoch);
  }
}

// Block 0 announces this rank at every peer; every block waits until
// every peer has entered.  Ends with a __syncthreads().
__device__ void enter(const RingArgs& a, int my, unsigned long long deadline,
                      const char* kernel) {
  announce(a, my);
  if (threadIdx.x == 0) {
    for (int h = 1; h < a.n; ++h) {
      const int p = (my + a.n - h) % a.n;
      wait_epoch(barrier(a, my) + p, a, deadline, kernel, "the barrier of rank", my, p);
    }
  }
  __syncthreads();
}

// After this block's stores into `dest`'s slot: make them visible at
// system scope, then raise the stripe's flag there.
__device__ __forceinline__ void publish(const RingArgs& a, int dest, int parity, int hop) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) store_release(flag(a, dest, parity, hop, blockIdx.x), a.epoch);
}

// Wait for the n - 1 arrivals of this block's stripe.  Ends with a
// __syncthreads().
__device__ void await_arrivals(const RingArgs& a, int my, int parity,
                               unsigned long long deadline, const char* kernel) {
  if (threadIdx.x == 0) {
    for (int h = 1; h < a.n; ++h) {
      wait_epoch(flag(a, my, parity, h, blockIdx.x), a, deadline, kernel,
                 "the slot of hop", my, h);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float slot_scale(const uint8_t* row, int block, bool vec) {
  if (vec) return __uint_as_float(__ldcg(reinterpret_cast<const unsigned*>(row + block)));
  uint32_t s = 0;
  for (int k = 0; k < 4; ++k) s |= static_cast<uint32_t>(__ldcg(row + block + k)) << (8 * k);
  return __uint_as_float(s);
}

// B6.  VEC: block % 4 == 0 and x / acc / deq 16-byte aligned.
template <int W, bool DEQ, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rs_ring_kernel(const __grid_constant__ RingArgs a) {
  const int n = a.n;
  const int my = a.rank0 + static_cast<int>(blockIdx.y);
  const unsigned long long deadline = now_ns() + a.timeout_ns;
  const int parity = static_cast<int>(a.epoch & 1u);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = a.block;
  const long long row = block + 4;
  const long long chunk = a.nb * block;
  const long long lo = a.nb * blockIdx.x / gridDim.x;
  const long long hi = a.nb * (blockIdx.x + 1) / gridDim.x;
  const float* x = a.x[my];
  float* deq = a.deq[my];
  enter(a, my, deadline, "rs_ring");

  // Quantize chunk (my + t) % n and store it into that rank's slot t.
  for (int t = 1; t < n; ++t) {
    const int dest = (my + t) % n;
    uint8_t* dst = slot(a, dest, parity, t);
    for (long long b = lo + warp; b < hi; b += kWarps) {
      uint8_t* pb = dst + b * row;
      warp_quant_block<W, VEC>(x + dest * chunk + b * block, block, a.inv_qmax, lane, 1,
                               [pb](int) { return pb; },
                               DEQ ? deq + dest * chunk + b * block : nullptr);
    }
    publish(a, dest, parity, t);
  }

  // Own chunk, then the arrivals in hop order: slot t holds source
  // (my - t) % n.
  await_arrivals(a, my, parity, deadline, "rs_ring");
  const float* xo = x + my * chunk;
  float* acc = a.out[my];
  for (long long b = lo + warp; b < hi; b += kWarps) {
    const BlockScale bs = warp_block_scale<VEC>(xo + b * block, block, a.inv_qmax, lane);
    if (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(xo + b * block);
      for (int g = lane; g < block / 4; g += 32) {
        float4 sum;
        quant_word<W>(x4[g], bs, sum);
        if (DEQ) reinterpret_cast<float4*>(deq + my * chunk + b * block)[g] = sum;
        for (int t = 1; t < n; ++t) {
          const uint8_t* r = slot(a, my, parity, t) + b * row;
          const uint32_t w = __ldcg(reinterpret_cast<const unsigned*>(r) + g);
          sum = add_rn(sum, dequant_word<W>(w, slot_scale(r, block, true)));
        }
        reinterpret_cast<float4*>(acc + b * block)[g] = sum;
      }
    } else {
      const float* xb = xo + b * block;
      for (int i = lane; i < block; i += 32) {
        const uint32_t q = bs.bad ? 0u : quantize<W>(xb[i], bs.safe);
        float sum = dequant<W>(q, bs.scale);
        if (DEQ) deq[my * chunk + b * block + i] = sum;
        for (int t = 1; t < n; ++t) {
          const uint8_t* r = slot(a, my, parity, t) + b * row;
          sum = __fadd_rn(sum, dequant<W>(__ldcg(r + i), slot_scale(r, block, false)));
        }
        acc[b * block + i] = sum;
      }
    }
  }
}

// B7's trace: thread 0 of each block stores %globaltimer at these points
// into trace[((rank - rank0) * kMaxStripes + blockIdx.x) * kTraceEvents].
constexpr int kTraceEvents = 7;
enum TraceEvent { kStart, kQuantized, kSent, kPublished, kOwn, kFirstArrival, kEnd };

__device__ __forceinline__ void trace_event(const RingArgs& a, int my, int event) {
  if (a.trace != nullptr && threadIdx.x == 0) {
    a.trace[((my - a.rank0) * static_cast<long long>(kMaxStripes) + blockIdx.x) * kTraceEvents +
            event] = now_ns();
  }
}

// ------------------------------------------------------------------ B7
//
// B7's receive slots have a layout of their own (B6's keep the packed
// rows): the stripe's q bytes first, block b's at byte b * block, then
// the nb float32 scales, block b's at byte nb * block + 4 * b.  The slot
// still takes nb * (block + 4) bytes.  On the 16-byte path (block % 16 ==
// 0, block <= 512; L = block / 16 lanes per block) the q bytes of a block
// are in lane order: 16-byte word l holds the q words of the block's
// float4s l, l + L, l + 2L and l + 3L.  A warp then reads x, stores into
// a peer's slot, reads its own slot and stores out in whole contiguous
// 128-byte lines, 512 bytes per instruction at block 512.

constexpr int kPath16 = 16;   // block % 16 == 0, block <= 512, tensors 16-byte aligned
constexpr int kPath4 = 4;     // block % 4 == 0, tensors 16-byte aligned
constexpr int kPath1 = 1;     // anything else: byte by byte
constexpr int kAgBatch = 4;   // arrivals whose loads a lane issues before its stores

// The scale of a block from its amax and non-finiteness, on every lane:
// warp_block_scale's reduction, for values the caller already holds.
__device__ __forceinline__ BlockScale warp_scale(float amax, bool bad, float inv_qmax) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  bad = __any_sync(kFull, bad);
  const float cand = __fmul_rn(amax, inv_qmax);
  const float safe = (!bad && cand > 0.0f) ? cand : 1.0f;
  return {safe, bad ? __uint_as_float(kNaN) : safe, bad};
}

// 16-byte path: one warp reads block xb into registers (lane l < L: the
// float4s l + k * L) and returns lane l's q word and the block's scale.
template <int W>
__device__ __forceinline__ void quant16(const float* xb, int block, float inv_qmax, int lane,
                                        uint4& q, float& scale) {
  const int L = block / 16;
  float4 v[4];
  float amax = 0.0f;
  bool bad = false;
  if (lane < L) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = x4[lane + k * L];
      observe(v[k].x, amax, bad); observe(v[k].y, amax, bad);
      observe(v[k].z, amax, bad); observe(v[k].w, amax, bad);
    }
  }
  const BlockScale bs = warp_scale(amax, bad, inv_qmax);
  scale = bs.scale;
  if (lane < L) {
    float4 unused;
    q = make_uint4(quant_word<W>(v[0], bs, unused), quant_word<W>(v[1], bs, unused),
                   quant_word<W>(v[2], bs, unused), quant_word<W>(v[3], bs, unused));
  }
}

// 16-byte path: lane l's dequant of a q word into block ob.
template <int W>
__device__ __forceinline__ void dequant16(float* ob, int block, int lane, uint4 q, float s) {
  const int L = block / 16;
  if (lane < L) {
    float4* o = reinterpret_cast<float4*>(ob);
    o[lane] = dequant_word<W>(q.x, s);
    o[lane + L] = dequant_word<W>(q.y, s);
    o[lane + 2 * L] = dequant_word<W>(q.z, s);
    o[lane + 3 * L] = dequant_word<W>(q.w, s);
  }
}

// Block b of this rank's shard into every peer's slot for this source.
// The 16-byte path stores the q word the caller quantized; the other
// paths quantize here (reading x twice, as B3 does) and also store the
// own dequant.
template <int W, int PATH>
__device__ __forceinline__ void send_block(const RingArgs& a, int my, int parity, long long b,
                                           int lane, uint4 q, float scale, const float* xb,
                                           float* own) {
  const int n = a.n;
  const int block = a.block;
  const long long qoff = b * block;
  const long long soff = a.nb * block + 4 * b;
  if (PATH == kPath16) {
    if (lane < block / 16) {
      for (int t = 1; t < n; ++t) {
        uint8_t* dst = slot(a, (my + t) % n, parity, t);
        *reinterpret_cast<uint4*>(dst + qoff + 16 * lane) = q;
      }
    }
    if (lane == 0) {
      for (int t = 1; t < n; ++t) {
        *reinterpret_cast<float*>(slot(a, (my + t) % n, parity, t) + soff) = scale;
      }
    }
  } else if (PATH == kPath4) {
    const BlockScale bs = warp_block_scale<true>(xb, block, a.inv_qmax, lane);
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    for (int g = lane; g < block / 4; g += 32) {
      float4 d;
      const uint32_t w = quant_word<W>(x4[g], bs, d);
      for (int t = 1; t < n; ++t) {
        reinterpret_cast<uint32_t*>(slot(a, (my + t) % n, parity, t) + qoff)[g] = w;
      }
      reinterpret_cast<float4*>(own)[g] = d;
    }
    if (lane == 0) {
      for (int t = 1; t < n; ++t) {
        *reinterpret_cast<float*>(slot(a, (my + t) % n, parity, t) + soff) = bs.scale;
      }
    }
  } else {
    const BlockScale bs = warp_block_scale<false>(xb, block, a.inv_qmax, lane);
    for (int i = lane; i < block; i += 32) {
      const uint32_t v = bs.bad ? 0u : quantize<W>(xb[i], bs.safe);
      for (int t = 1; t < n; ++t) slot(a, (my + t) % n, parity, t)[qoff + i] = static_cast<uint8_t>(v);
      own[i] = dequant<W>(v, bs.scale);
    }
    if (lane < 4) {  // the scale's bytes: nb * block need not be 4-aligned here
      const uint8_t byte = static_cast<uint8_t>(__float_as_uint(bs.scale) >> (8 * lane));
      for (int t = 1; t < n; ++t) slot(a, (my + t) % n, parity, t)[soff + lane] = byte;
    }
  }
}

// After this block's stores into every peer: make them visible at
// system scope once, then raise the n - 1 flags of this stripe at once.
__device__ __forceinline__ void publish_all(const RingArgs& a, int my, int parity) {
  __threadfence_system();
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= 1 && t < a.n) store_release(flag(a, (my + t) % a.n, parity, t, blockIdx.x), a.epoch);
}

// Wait until at least one arrival of this stripe not in `done` has
// landed; returns every such arrival that has (bit h: slot h), on every
// thread.  Ends with a __syncthreads().
__device__ unsigned await_any(const RingArgs& a, int my, int parity, unsigned done,
                              unsigned long long deadline, unsigned* ready_smem) {
  if (threadIdx.x == 0) {
    unsigned ready = 0;
    for (;;) {
      for (int h = 1; h < a.n; ++h) {
        if (!((done >> h) & 1u) &&
            static_cast<int>(load_acquire(flag(a, my, parity, h, blockIdx.x)) - a.epoch) >= 0) {
          ready |= 1u << h;
        }
      }
      if (ready) break;
      if (now_ns() > deadline) {
        const int h = __ffs(~done & ~1u) - 1;
        printf("ag_ring: rank %d block %d timed out after %llu ns waiting for the slot of "
               "hop %d (epoch %u, flag holds %u)\n", my, static_cast<int>(blockIdx.x),
               a.timeout_ns, h, a.epoch, load_acquire(flag(a, my, parity, h, blockIdx.x)));
        __trap();
      }
      __nanosleep(32);
    }
    __threadfence();
    *ready_smem = ready;
  }
  __syncthreads();
  return *ready_smem;
}

// Dequantize block b of the arrivals in `ready` into out[src].
template <int W, int PATH>
__device__ __forceinline__ void receive_block(const RingArgs& a, int my, int parity,
                                              unsigned ready, long long b, int lane,
                                              float* out) {
  const int n = a.n;
  const int block = a.block;
  const long long chunk = a.nb * block;
  const long long qoff = b * block;
  const long long soff = a.nb * block + 4 * b;
  if (PATH == kPath16) {
    // Up to kAgBatch arrivals at a time: every load, then every store.
    while (ready) {
      int hop[kAgBatch];
      uint4 q[kAgBatch];
      float s[kAgBatch];
#pragma unroll
      for (int k = 0; k < kAgBatch; ++k) {
        hop[k] = 0;
        if (ready) {
          hop[k] = __ffs(ready) - 1;
          ready &= ready - 1;
        }
      }
#pragma unroll
      for (int k = 0; k < kAgBatch; ++k) {
        if (hop[k] && lane < block / 16) {
          const uint8_t* r = slot(a, my, parity, hop[k]);
          q[k] = __ldcg(reinterpret_cast<const uint4*>(r + qoff) + lane);
          s[k] = __uint_as_float(__ldcg(reinterpret_cast<const unsigned*>(r + soff)));
        }
      }
#pragma unroll
      for (int k = 0; k < kAgBatch; ++k) {
        if (hop[k]) {
          const int src = (my + n - hop[k]) % n;
          dequant16<W>(out + src * chunk + qoff, block, lane, q[k], s[k]);
        }
      }
    }
  } else {
    for (; ready; ready &= ready - 1) {
      const int h = __ffs(ready) - 1;
      const uint8_t* r = slot(a, my, parity, h);
      float* ob = out + ((my + n - h) % n) * chunk + qoff;
      if (PATH == kPath4) {
        const float s = __uint_as_float(__ldcg(reinterpret_cast<const unsigned*>(r + soff)));
        for (int g = lane; g < block / 4; g += 32) {
          const uint32_t w = __ldcg(reinterpret_cast<const unsigned*>(r + qoff) + g);
          reinterpret_cast<float4*>(ob)[g] = dequant_word<W>(w, s);
        }
      } else {
        uint32_t bits = 0;
        for (int k = 0; k < 4; ++k) bits |= static_cast<uint32_t>(__ldcg(r + soff + k)) << (8 * k);
        const float s = __uint_as_float(bits);
        for (int i = lane; i < block; i += 32) ob[i] = dequant<W>(__ldcg(r + qoff + i), s);
      }
    }
  }
}

// B7.  Warp w of a block takes blocks lo + w, lo + w + kWarps, ... of the
// block's stripe.  On the 16-byte path the warp's first block is read
// and quantized into registers before anything else, and its own
// dequant is stored only after the stripe's flags are up, so the fence
// waits for the peer stores alone.  The arrivals are dequantized in the
// order they land.
//
// B7 does not wait at the entry barrier; it needs no wait.  Launch e
// stores into the peers' slots and flags of parity e & 1, which only
// launch e - 2 used.
// Launch e - 1 on this card, B6 or B7, ended after it had taken every
// peer's arrivals of epoch e - 1, so every peer had started launch e - 1
// and had therefore ended launch e - 2, reads of those slots included.
// Launches 1 and 2 store into slots no launch has used.  It still
// announces itself, so B6's barrier reads every epoch.
template <int W, int PATH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ag_ring_kernel(const __grid_constant__ RingArgs a) {
  __shared__ unsigned ready_smem;
  const int my = a.rank0 + static_cast<int>(blockIdx.y);
  const unsigned long long deadline = now_ns() + a.timeout_ns;
  const int parity = static_cast<int>(a.epoch & 1u);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = a.block;
  const long long chunk = a.nb * block;
  const long long lo = a.nb * blockIdx.x / gridDim.x;
  const long long hi = a.nb * (blockIdx.x + 1) / gridDim.x;
  const float* x = a.x[my];
  float* own = a.out[my] + my * chunk;
  const long long b0 = lo + warp;

  trace_event(a, my, kStart);
  announce(a, my);
  uint4 q0 = make_uint4(0u, 0u, 0u, 0u);
  float s0 = 0.0f;
  if (PATH == kPath16 && b0 < hi) quant16<W>(x + b0 * block, block, a.inv_qmax, lane, q0, s0);
  trace_event(a, my, kQuantized);

  for (long long b = b0; b < hi; b += kWarps) {
    uint4 q = q0;
    float s = s0;
    if (PATH == kPath16 && b != b0) quant16<W>(x + b * block, block, a.inv_qmax, lane, q, s);
    send_block<W, PATH>(a, my, parity, b, lane, q, s, x + b * block, own + b * block);
    if (PATH == kPath16 && b != b0) dequant16<W>(own + b * block, block, lane, q, s);
  }
  trace_event(a, my, kSent);
  publish_all(a, my, parity);
  trace_event(a, my, kPublished);
  if (PATH == kPath16 && b0 < hi) dequant16<W>(own + b0 * block, block, lane, q0, s0);
  trace_event(a, my, kOwn);

  const unsigned all = ((1u << a.n) - 1u) & ~1u;
  for (unsigned done = 0; done != all;) {
    const unsigned ready = await_any(a, my, parity, done, deadline, &ready_smem);
    if (done == 0) trace_event(a, my, kFirstArrival);
    for (long long b = b0; b < hi; b += kWarps) {
      receive_block<W, PATH>(a, my, parity, ready, b, lane, a.out[my]);
    }
    done |= ready;
    __syncthreads();  // every thread has read ready_smem before it is rewritten
  }
  trace_event(a, my, kEnd);
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// B7's trace buffer for later launches (hvd_ag_ring_trace), or null.
unsigned long long* g_ag_trace = nullptr;

int launch(const void* kernel, RingArgs& a, int ranks, void* stream) {
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  // Stripes: as many blocks as fit on the card at once (split between
  // the ranks of one launch), no more than the chunk has warps' work for.
  // Every rank computes the same number from the same card and nb.
  long long g = static_cast<long long>(sms) * kMinBlocks / ranks;
  const long long need = (a.nb + kWarps - 1) / kWarps;
  if (g > need) g = need;
  if (g > kMaxStripes) g = kMaxStripes;
  if (g < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(g), static_cast<unsigned>(ranks)), dim3(kThreads),
      params, 0, reinterpret_cast<cudaStream_t>(stream)));
}

// Fills `a` from the C arguments; returns a cudaError_t.
int make_args(RingArgs& a, void* const* x, void* const* out, void* const* deq,
              void* const* win, int n, int rank0, int ranks, long long nb, int block,
              float inv_qmax, unsigned epoch, long long slot_bytes, double timeout_s) {
  if (n < 2 || n > kMaxRanks || ranks < 1 || rank0 < 0 || rank0 + ranks > n || nb < 1 ||
      block < 1 || epoch == 0 || timeout_s <= 0.0 ||
      nb * (block + 4) > slot_bytes || slot_bytes % kSlotAlign != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a = RingArgs{};
  for (int r = 0; r < n; ++r) {
    if (!win[r]) return static_cast<int>(cudaErrorInvalidValue);
    a.win[r] = static_cast<uint8_t*>(win[r]);
  }
  for (int r = rank0; r < rank0 + ranks; ++r) {
    if (!x[r] || !out[r]) return static_cast<int>(cudaErrorInvalidValue);
    a.x[r] = static_cast<const float*>(x[r]);
    a.out[r] = static_cast<float*>(out[r]);
    a.deq[r] = deq ? static_cast<float*>(deq[r]) : nullptr;
  }
  a.nb = nb;
  a.slot_bytes = slot_bytes;
  a.flags_off = 2LL * (n - 1) * slot_bytes;
  a.timeout_ns = static_cast<unsigned long long>(timeout_s * 1e9);
  a.n = n;
  a.rank0 = rank0;
  a.block = block;
  a.epoch = epoch;
  a.inv_qmax = inv_qmax;
  return 0;
}

bool all_aligned(const RingArgs& a, int rank0, int ranks, bool with_deq) {
  for (int r = rank0; r < rank0 + ranks; ++r) {
    if (!aligned16(a.x[r]) || !aligned16(a.out[r]) || (with_deq && !aligned16(a.deq[r])))
      return false;
  }
  return true;
}

template <int W>
const void* rs_kernel(bool deq, bool vec) {
  if (deq) {
    return vec ? reinterpret_cast<const void*>(rs_ring_kernel<W, true, true>)
               : reinterpret_cast<const void*>(rs_ring_kernel<W, true, false>);
  }
  return vec ? reinterpret_cast<const void*>(rs_ring_kernel<W, false, true>)
             : reinterpret_cast<const void*>(rs_ring_kernel<W, false, false>);
}

template <int W>
const void* ag_kernel(int path) {
  if (path == kPath16) return reinterpret_cast<const void*>(ag_ring_kernel<W, kPath16>);
  if (path == kPath4) return reinterpret_cast<const void*>(ag_ring_kernel<W, kPath4>);
  return reinterpret_cast<const void*>(ag_ring_kernel<W, kPath1>);
}

}  // namespace

// Every entry returns a cudaError_t (0 on success).  The kernels launch
// on `stream` without synchronising.

extern "C" const char* hvd_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of one rank's window for a world of n: two parity sets of n - 1
// slots of `slot_bytes`, then the flags and the barrier words.
extern "C" long long hvd_ring_window_bytes(int n, long long slot_bytes) {
  if (n < 2 || n > kMaxRanks || slot_bytes < 0 || slot_bytes % kSlotAlign != 0) return -1;
  const long long flags = (2LL * (n - 1) * kMaxStripes + kMaxRanks) * 4;
  return 2LL * (n - 1) * slot_bytes + round_up(flags, kSlotAlign);
}

extern "C" long long hvd_ring_slot_align() { return kSlotAlign; }

// A zeroed window of `bytes` on the current device.
extern "C" int hvd_ring_alloc(long long bytes, void** ptr) {
  *ptr = nullptr;
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e != cudaSuccess && *ptr) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(e);
}

extern "C" int hvd_ring_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

extern "C" int hvd_ring_handle_size() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

extern "C" int hvd_ring_export(void* ptr, void* handle) {
  return static_cast<int>(cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr));
}

extern "C" int hvd_ring_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int hvd_ring_close(void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(ptr)); }

// B6 for ranks rank0 .. rank0 + ranks - 1 of a world of n.  x, acc and
// deq (deq may be null) are tables of n pointers of which those ranks'
// are used; win holds every rank's window as mapped here.
extern "C" int hvd_rs_ring(void* const* x, void* const* acc, void* const* deq,
                           void* const* win, int n, int rank0, int ranks, long long nb,
                           int block, int wire, float inv_qmax, unsigned epoch,
                           long long slot_bytes, double timeout_s, void* stream) {
  RingArgs a;
  int e = make_args(a, x, acc, deq, win, n, rank0, ranks, nb, block, inv_qmax, epoch,
                    slot_bytes, timeout_s);
  if (e != 0) return e;
  const bool with_deq = deq != nullptr;
  const bool vec = block % 4 == 0 && all_aligned(a, rank0, ranks, with_deq);
  const void* k;
  if (wire == kInt8) k = rs_kernel<kInt8>(with_deq, vec);
  else if (wire == kFp8) k = rs_kernel<kFp8>(with_deq, vec);
  else return static_cast<int>(cudaErrorInvalidValue);
  e = launch(k, a, ranks, stream);
  return e != 0 ? e : static_cast<int>(cudaGetLastError());
}

// B7, as hvd_rs_ring: x holds shards (nb, block), out (n, nb, block).
extern "C" int hvd_ag_ring(void* const* x, void* const* out, void* const* win, int n,
                           int rank0, int ranks, long long nb, int block, int wire,
                           float inv_qmax, unsigned epoch, long long slot_bytes,
                           double timeout_s, void* stream) {
  RingArgs a;
  int e = make_args(a, x, out, nullptr, win, n, rank0, ranks, nb, block, inv_qmax, epoch,
                    slot_bytes, timeout_s);
  if (e != 0) return e;
  a.trace = g_ag_trace;
  int path = kPath1;
  if (block % 4 == 0 && all_aligned(a, rank0, ranks, false)) {
    path = (block % 16 == 0 && block <= 512) ? kPath16 : kPath4;
  }
  const void* k;
  if (wire == kInt8) k = ag_kernel<kInt8>(path);
  else if (wire == kFp8) k = ag_kernel<kFp8>(path);
  else return static_cast<int>(cudaErrorInvalidValue);
  e = launch(k, a, ranks, stream);
  return e != 0 ? e : static_cast<int>(cudaGetLastError());
}

// B7's trace buffer for later launches: `buf` holds kTraceEvents uint64
// for each of kMaxStripes (2048) blocks of each launched rank; null
// turns the trace off.
extern "C" void hvd_ag_ring_trace(void* buf) {
  g_ag_trace = static_cast<unsigned long long*>(buf);
}
