// Kernels B6 and B7: the single-kernel quantized rings over NVLink.
//
// B6, rs_ring: one quantized reduce-scatter per launch.  Per rank, n
//   chunks of c = nb * block float32 go in; out come the float32 sum of
//   this rank's chunk over all ranks (`acc`, c) and, for error feedback,
//   B3's dequant of every chunk in chunk order (`deq`, n * c).  Each
//   chunk is quantized once, by its producer; chunk (my + t) % n is
//   stored straight into receive slot t of rank (my + t) % n through its
//   peer-mapped pointer; the arrivals are summed in hop order (own chunk,
//   then sources my - 1, my - 2, ...), each product and each sum rounded
//   as B4 rounds them.  Replaces horovod_tpu/ops/pallas_quant.py::
//   _rs_ring_tpu (:477, body _rs_ring_kernel :371).
// B7, ag_ring: one quantized all-gather per launch.  The shard (c
//   float32) is quantized once, stored into every peer's receive slot
//   for this source and its dequant into out[my]; each arrival is
//   dequantized into out[src].  Bitwise equal to B3 + an all-gather +
//   B5: the result does not depend on order.  Replaces
//   pallas_quant.py::_ag_ring_tpu (:563, body _ag_ring_kernel :515).
//
// Bound.  Both kernels do a few operations per byte: the least time is
// the larger of the device-memory bytes over 3.35 TB/s and the bytes a
// rank stores into its peers over NVLink's 450 GB/s each way.  B6 with
// the dequant reads n * c * 4 bytes, writes n * c * 4 (deq) + c * 4
// (acc), receives and reads (n - 1) quantized chunks; B7 reads c * 4 and
// writes n * c * 4.  Each sends (n - 1) quantized chunks of c * (1 + 4 /
// block) bytes.  At a world of 4 the device bytes bound both.
//
// Design against that bound.  The TPU kernel stages chunks through VMEM
// with double-buffered DMAs and keeps the float32 sum in VMEM.  Here a
// persistent grid of G thread blocks (at most the co-resident capacity,
// so the spins below cannot deadlock) cuts every chunk into G stripes of
// quantization blocks; block s owns stripe s of every chunk on every
// rank.  One warp quantizes one quantization block at a time with the
// device functions B3 uses (quant_math.cuh) and stores it straight into
// the peer's slot: no staging copy.  A block stores its stripe into
// every peer, then does the local work that needs no arrival while those
// stores drain over NVLink, then fences once and raises its flags at
// every peer; the sums and dequants of the arrivals follow.  The slots
// keep the q bytes apart from the scales (below), so on the main path a
// lane stores 16 bytes into a peer and a warp whole lines.  The
// quantized payload is 1/4 of the float32 bytes, so the kernels move
// about the bytes B3 + B4 (B3 + B5) move, in one launch, without the
// all-to-all's own pass over device memory.
//
// Synchronisation.  Each rank's window (ops/peer.py allocates it, CUDA
// IPC maps it into the peers) holds two epoch-parity sets of n - 1
// receive slots and one flag per (parity, slot, stripe).  Every launch
// carries a new epoch; flags hold epochs, so nothing is ever reset.  The
// epoch lives in device memory, one word per launched rank (ops/peer.py
// allocates it with the window): a one-thread kernel queued before each
// ring launch on the same stream advances it (bump_epochs), and every
// block of the launch reads it at its start.  So a launch captured into
// a CUDA graph takes a new epoch on every replay, and eager launches and
// replays count on from one word.  A sender's block fences its stores
// to system scope and then stores the epoch into the flag of its stripe
// at the receiver with st.release.sys;
// the receiver's block spins on ld.acquire.sys and reads the slot
// through L2 (ld.cg).  There is no entry barrier (the TPU kernel's
// barrier semaphore, :378-385): the previous launch already proves that
// the slots a launch stores into are free (the comment on
// rs_ring_kernel).  Every spin is bounded by %globaltimer (the process
// group's timeout, so a late peer is waited for as long as the group
// waits): past the bound the block prints which flag it waited on and
// traps, so a broken protocol is a CUDA error and not a hung card.
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
  unsigned* epoch;            // the launched ranks' epoch words, rank0 + i at [i]
  float inv_qmax;
  unsigned long long* trace;  // trace_events timestamps per block, or null
  int trace_events;
};

__device__ __forceinline__ uint8_t* slot(const RingArgs& a, int r, int parity, int hop) {
  return a.win[r] + static_cast<long long>(parity * (a.n - 1) + hop - 1) * a.slot_bytes;
}

__device__ __forceinline__ unsigned* flag(const RingArgs& a, int r, int parity, int hop,
                                          int stripe) {
  return reinterpret_cast<unsigned*>(a.win[r] + a.flags_off) +
         static_cast<long long>(parity * (a.n - 1) + hop - 1) * kMaxStripes + stripe;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool landed(const unsigned* p, unsigned epoch) {
  return static_cast<int>(load_acquire(p) - epoch) >= 0;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Past the deadline: say which flag this block waited on, and trap.
__device__ void trap_late(const RingArgs& a, const char* kernel, int rank, int hop,
                          unsigned epoch, const unsigned* p) {
  printf("%s: rank %d block %d timed out after %llu ns waiting for the slot of hop %d "
         "(epoch %u, flag holds %u)\n",
         kernel, rank, static_cast<int>(blockIdx.x), a.timeout_ns, hop, epoch,
         load_acquire(p));
  __trap();
}

// Advances the epoch word of each of `ranks` launched ranks: queued
// before every ring launch, on its stream.  0 is skipped (the flags start
// at 0, so epoch 0 would read as landed); 2 follows 0xffffffff, so the
// parity still alternates.  A separate kernel rather than the ring
// kernel advancing its own word: that would have to wait until every
// block of the launch had read it (a grid-wide count per rank); this
// costs one more launch per collective, ~3 us on the card.
__global__ void bump_epochs(unsigned* epoch, int ranks) {
  const int i = static_cast<int>(threadIdx.x);
  if (i < ranks) {
    const unsigned e = epoch[i] + 1u;
    epoch[i] = e == 0u ? 2u : e;
  }
}

// Thread 0 reads this launch's epoch for rank `my` into shared memory
// (the 16-byte kernels are at their register cap); an epoch of 0 means
// no bump ran before the launch: trap.  Ends with a __syncthreads().
__device__ __forceinline__ void read_epoch(const RingArgs& a, int my, const char* kernel,
                                           unsigned* epoch_smem) {
  if (threadIdx.x == 0) {
    const unsigned e = a.epoch[my - a.rank0];
    if (e == 0u) {
      printf("%s: rank %d launched with epoch 0\n", kernel, my);
      __trap();
    }
    *epoch_smem = e;
  }
  __syncthreads();
}

// After this block's stores into every peer: make them visible at
// system scope once, then raise the n - 1 flags of this stripe at once.
__device__ __forceinline__ void publish_all(const RingArgs& a, int my, unsigned epoch) {
  __threadfence_system();
  __syncthreads();
  const int t = threadIdx.x;
  const int parity = static_cast<int>(epoch & 1u);
  if (t >= 1 && t < a.n) store_release(flag(a, (my + t) % a.n, parity, t, blockIdx.x), epoch);
}

// The per-block timelines: thread 0 of each block stores %globaltimer at
// these points into trace[((rank - rank0) * kMaxStripes + blockIdx.x) *
// trace_events + event].  B6's "sent 1" is after the first peer's
// stripe, "first arrival" after hop 1's.
constexpr int kTraceEvents = 7;
enum TraceEvent { kStart, kQuantized, kSent, kPublished, kOwn, kFirstArrival, kEnd };
constexpr int kRsTraceEvents = 8;
enum RsTraceEvent { kRsStart, kRsSent1, kRsSent, kRsPublished, kRsOwn, kRsFirstArrival,
                    kRsAllArrivals, kRsEnd };

__device__ __forceinline__ void trace_event(const RingArgs& a, int my, int event) {
  if (a.trace != nullptr && threadIdx.x == 0) {
    a.trace[((my - a.rank0) * static_cast<long long>(kMaxStripes) + blockIdx.x) *
                a.trace_events + event] = now_ns();
  }
}

// ---------------------------------------------------------------- slots
//
// A receive slot holds one chunk (B6) or shard (B7) of nb blocks: their
// q bytes first, block b's at byte b * block, then the nb float32
// scales, block b's at byte nb * block + 4 * b; nb * (block + 4) bytes.
// On the 16-byte path (block % 16 == 0, block <= 512, tensors 16-byte
// aligned; L = block / 16 lanes per block) the q bytes of a block are in
// lane order: 16-byte word l holds the q words of the block's float4s l,
// l + L, l + 2L and l + 3L.  A warp then reads x, stores into a peer's slot,
// reads its own slot and stores its outputs in whole contiguous 128-byte
// lines, 512 bytes per instruction at block 512.

constexpr int kPath16 = 16;  // block % 16 == 0, block <= 512, tensors 16-byte aligned
constexpr int kPath4 = 4;    // block % 4 == 0, tensors 16-byte aligned
constexpr int kPath1 = 1;    // anything else: byte by byte
constexpr int kBatch = 2;    // arrivals whose loads a lane issues before it uses them

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

// 16-byte path: the four float4s of lane l's q word, in the order of
// its words.
template <int W>
__device__ __forceinline__ void dequant16(uint4 q, float s, float4 (&d)[4]) {
  d[0] = dequant_word<W>(q.x, s);
  d[1] = dequant_word<W>(q.y, s);
  d[2] = dequant_word<W>(q.z, s);
  d[3] = dequant_word<W>(q.w, s);
}

// 16-byte path: lane l's four float4s into block ob.
__device__ __forceinline__ void store16(float* ob, int block, int lane, const float4 (&d)[4]) {
  const int L = block / 16;
  if (lane < L) {
    float4* o = reinterpret_cast<float4*>(ob);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[lane + k * L] = d[k];
  }
}

// 16-byte path: lane l's dequant of a q word into block ob.
template <int W>
__device__ __forceinline__ void dequant_store16(float* ob, int block, int lane, uint4 q, float s) {
  float4 d[4];
  dequant16<W>(q, s, d);
  store16(ob, block, lane, d);
}

// 16-byte path: lane l's q word of block b in slot r, and the scale.
__device__ __forceinline__ void load16(const RingArgs& a, const uint8_t* r, long long b,
                                       int lane, uint4& q, float& s) {
  q = __ldcg(reinterpret_cast<const uint4*>(r + b * a.block) + lane);
  s = __uint_as_float(__ldcg(reinterpret_cast<const unsigned*>(r + a.nb * a.block + 4 * b)));
}

// The scale of block b in slot r (the other paths: nb * block need not
// be 4-aligned on the byte path).
template <int PATH>
__device__ __forceinline__ float load_slot_scale(const RingArgs& a, const uint8_t* r,
                                                 long long b) {
  const uint8_t* p = r + a.nb * a.block + 4 * b;
  if (PATH != kPath1) return __uint_as_float(__ldcg(reinterpret_cast<const unsigned*>(p)));
  uint32_t bits = 0;
  for (int k = 0; k < 4; ++k) bits |= static_cast<uint32_t>(__ldcg(p + k)) << (8 * k);
  return __uint_as_float(bits);
}

// Block b into `nd` slots, slot k at dst(k) (B7: every peer's slot for
// this source; B6: one peer's).  The 16-byte path stores the q word the
// caller quantized; the other paths quantize xb here (reading it twice,
// as B3 does) and store its dequant into `own` unless that is null.
template <int W, int PATH, class Dst>
__device__ __forceinline__ void put_block(const RingArgs& a, long long b, int lane, int nd,
                                          Dst dst, uint4 q, float scale, const float* xb,
                                          float* own) {
  const int block = a.block;
  const long long qoff = b * block;
  const long long soff = a.nb * block + 4 * b;
  if (PATH == kPath16) {
    if (lane < block / 16) {
      for (int k = 0; k < nd; ++k) *reinterpret_cast<uint4*>(dst(k) + qoff + 16 * lane) = q;
    }
    if (lane == 0) {
      for (int k = 0; k < nd; ++k) *reinterpret_cast<float*>(dst(k) + soff) = scale;
    }
  } else if (PATH == kPath4) {
    const BlockScale bs = warp_block_scale<true>(xb, block, a.inv_qmax, lane);
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    for (int g = lane; g < block / 4; g += 32) {
      float4 d;
      const uint32_t w = quant_word<W>(x4[g], bs, d);
      for (int k = 0; k < nd; ++k) reinterpret_cast<uint32_t*>(dst(k) + qoff)[g] = w;
      if (own) reinterpret_cast<float4*>(own)[g] = d;
    }
    if (lane == 0) {
      for (int k = 0; k < nd; ++k) *reinterpret_cast<float*>(dst(k) + soff) = bs.scale;
    }
  } else {
    const BlockScale bs = warp_block_scale<false>(xb, block, a.inv_qmax, lane);
    for (int i = lane; i < block; i += 32) {
      const uint32_t v = bs.bad ? 0u : quantize<W>(xb[i], bs.safe);
      for (int k = 0; k < nd; ++k) dst(k)[qoff + i] = static_cast<uint8_t>(v);
      if (own) own[i] = dequant<W>(v, bs.scale);
    }
    if (lane < 4) {  // the scale's bytes: nb * block need not be 4-aligned here
      const uint8_t byte = static_cast<uint8_t>(__float_as_uint(bs.scale) >> (8 * lane));
      for (int k = 0; k < nd; ++k) dst(k)[soff + lane] = byte;
    }
  }
}

// The path of a launch: 16-byte or word stores need block % 4 == 0 and
// every tensor 16-byte aligned.
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int ring_path(const RingArgs& a, int rank0, int ranks, bool with_deq) {
  if (a.block % 4 != 0) return kPath1;
  for (int r = rank0; r < rank0 + ranks; ++r) {
    if (!aligned16(a.x[r]) || !aligned16(a.out[r]) || (with_deq && !aligned16(a.deq[r])))
      return kPath1;
  }
  return (a.block % 16 == 0 && a.block <= 512) ? kPath16 : kPath4;
}

// ------------------------------------------------------------------ B6

// Wait until every hop of this block's stripe has landed (thread 0, in
// hop order).  Ends with a __syncthreads().
__device__ void await_all(const RingArgs& a, int my, unsigned epoch,
                          unsigned long long deadline) {
  if (threadIdx.x == 0) {
    const int parity = static_cast<int>(epoch & 1u);
    for (int h = 1; h < a.n; ++h) {
      const unsigned* p = flag(a, my, parity, h, blockIdx.x);
      while (!landed(p, epoch)) {
        if (now_ns() > deadline) trap_late(a, "rs_ring", my, h, epoch, p);
        __nanosleep(32);
      }
      if (h == 1) trace_event(a, my, kRsFirstArrival);
    }
    __threadfence();
  }
  __syncthreads();
}

// 16-byte path: add every hop's block b to lane l's sum, in hop order,
// up to kBatch hops' loads in flight at once.
template <int W>
__device__ __forceinline__ void add_hops16(const RingArgs& a, int my, int parity, long long b,
                                           int lane, float4 (&sum)[4]) {
  for (int h0 = 1; h0 < a.n; h0 += kBatch) {
    uint4 q[kBatch];
    float s[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (h0 + k < a.n) load16(a, slot(a, my, parity, h0 + k), b, lane, q[k], s[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (h0 + k < a.n) {
        float4 d[4];
        dequant16<W>(q[k], s[k], d);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[j] = add_rn(sum[j], d[j]);
      }
    }
  }
}

// The other paths: block b's sum of its own dequant (xb quantized here,
// and stored into `own` unless that is null) and every hop's, in hop
// order, into ab.
template <int W, int PATH>
__device__ __forceinline__ void sum_block(const RingArgs& a, int my, int parity, long long b,
                                          int lane, const float* xb, float* own, float* ab) {
  const int n = a.n;
  const int block = a.block;
  const long long qoff = b * block;
  if (PATH == kPath4) {
    const BlockScale bs = warp_block_scale<true>(xb, block, a.inv_qmax, lane);
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    for (int g = lane; g < block / 4; g += 32) {
      float4 sum;
      quant_word<W>(x4[g], bs, sum);
      if (own) reinterpret_cast<float4*>(own)[g] = sum;
      for (int h = 1; h < n; ++h) {
        const uint8_t* r = slot(a, my, parity, h);
        const uint32_t w = __ldcg(reinterpret_cast<const unsigned*>(r + qoff) + g);
        sum = add_rn(sum, dequant_word<W>(w, load_slot_scale<PATH>(a, r, b)));
      }
      reinterpret_cast<float4*>(ab)[g] = sum;
    }
  } else {
    const BlockScale bs = warp_block_scale<false>(xb, block, a.inv_qmax, lane);
    for (int i = lane; i < block; i += 32) {
      const uint32_t q = bs.bad ? 0u : quantize<W>(xb[i], bs.safe);
      float sum = dequant<W>(q, bs.scale);
      if (own) own[i] = sum;
      for (int h = 1; h < n; ++h) {
        const uint8_t* r = slot(a, my, parity, h);
        sum = __fadd_rn(sum, dequant<W>(__ldcg(r + qoff + i), load_slot_scale<PATH>(a, r, b)));
      }
      ab[i] = sum;
    }
  }
}

// B6.  Warp w of a block takes blocks lo + w, lo + w + kWarps, ... of the
// block's stripe of every chunk.  First it stores chunk (my + t) % n's
// blocks into that rank's slot t, and their dequants into deq, for t =
// 1 .. n - 1.  Then one fence and the flags; then, while the peers'
// stores are still landing, it quantizes its own chunk and stores that
// dequant, keeping the first block in registers (the 16-byte path; the
// other paths store their own dequant with the sum).  The sum follows
// once every hop has landed, in hop order.  Measured at
// world 4 on H100s (PERF.md, Findings), each slower: the own chunk before
// the fence (the fence then waits for its stores too); each block's
// stores into all peers before any of their dequants (more registers
// held, later first stores); summing each hop as it lands (the hops
// land within ~3 us of each other).
//
// B6 and B7 wait at no entry barrier; they need none.  Launch e (the
// e-th ring launch of this window, which reads epoch e: bump_epochs
// before it on the same stream advanced the word from e - 1, and every
// rank runs the same collectives, so every rank's word reads e) stores
// into the peers' slots and flags of parity e & 1, which only launch
// e - 2 used.  Launch e - 1 on this card, B6 or B7, ended after it had
// taken every peer's arrivals of epoch e - 1, so every peer had started
// launch e - 1 and had therefore ended launch e - 2, reads of those
// slots included.  Launches 1 and 2 store into slots no launch has used.
// This holds whether a launch was issued eagerly or replayed from a
// CUDA graph: the bump and the launch are two nodes of the graph in
// stream order, one word serves both, and the launches of a window stay
// on one stream (the exchange stream, or the capturing one), in order.
// A late peer is waited for in the arrival spins, up to the bound.
template <int W, bool DEQ, int PATH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rs_ring_kernel(const __grid_constant__ RingArgs a) {
  __shared__ unsigned long long deadline;
  __shared__ unsigned epoch;
  const int n = a.n;
  const int my = a.rank0 + static_cast<int>(blockIdx.y);
  read_epoch(a, my, "rs_ring", &epoch);
  const int parity = static_cast<int>(epoch & 1u);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = a.block;
  const long long chunk = a.nb * block;
  const long long lo = a.nb * blockIdx.x / gridDim.x;
  const long long hi = a.nb * (blockIdx.x + 1) / gridDim.x;
  const long long b0 = lo + warp;
  const float* x = a.x[my];
  const float* xo = x + my * chunk;
  float* deq = a.deq[my];
  float* acc = a.out[my];
  // In shared memory, read by thread 0 alone: the 16-byte kernels are at
  // their register cap.
  if (threadIdx.x == 0) deadline = now_ns() + a.timeout_ns;

  trace_event(a, my, kRsStart);
  for (int t = 1; t < n; ++t) {
    const int dest = (my + t) % n;
    uint8_t* dst = slot(a, dest, parity, t);
    const float* xd = x + dest * chunk;
    for (long long b = b0; b < hi; b += kWarps) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      float s = 0.0f;
      float* own = DEQ ? deq + dest * chunk + b * block : nullptr;
      if (PATH == kPath16) quant16<W>(xd + b * block, block, a.inv_qmax, lane, q, s);
      put_block<W, PATH>(a, b, lane, 1, [dst](int) { return dst; }, q, s, xd + b * block, own);
      if (PATH == kPath16 && DEQ) dequant_store16<W>(own, block, lane, q, s);
    }
    if (t == 1) trace_event(a, my, kRsSent1);
  }
  trace_event(a, my, kRsSent);
  publish_all(a, my, epoch);
  trace_event(a, my, kRsPublished);

  uint4 q0 = make_uint4(0u, 0u, 0u, 0u);
  float s0 = 0.0f;
  if (PATH == kPath16 && b0 < hi) quant16<W>(xo + b0 * block, block, a.inv_qmax, lane, q0, s0);
  if (PATH == kPath16 && DEQ) {
    for (long long b = b0; b < hi; b += kWarps) {
      float* own = deq + my * chunk + b * block;
      if (b == b0) {
        dequant_store16<W>(own, block, lane, q0, s0);
      } else {
        uint4 q;
        float s;
        quant16<W>(xo + b * block, block, a.inv_qmax, lane, q, s);
        dequant_store16<W>(own, block, lane, q, s);
      }
    }
  }
  trace_event(a, my, kRsOwn);

  await_all(a, my, epoch, deadline);
  trace_event(a, my, kRsAllArrivals);
  for (long long b = b0; b < hi; b += kWarps) {
    if (PATH == kPath16) {
      uint4 q = q0;
      float s = s0;
      if (b != b0) quant16<W>(xo + b * block, block, a.inv_qmax, lane, q, s);
      float4 sum[4];
      dequant16<W>(q, s, sum);
      if (lane < block / 16) add_hops16<W>(a, my, parity, b, lane, sum);
      store16(acc + b * block, block, lane, sum);
    } else {
      sum_block<W, PATH>(a, my, parity, b, lane, xo + b * block,
                         DEQ ? deq + my * chunk + b * block : nullptr, acc + b * block);
    }
  }
  trace_event(a, my, kRsEnd);
}

// ------------------------------------------------------------------ B7

// Wait until at least one arrival of this stripe not in `done` has
// landed; returns every such arrival that has (bit h: slot h), on every
// thread.  Ends with a __syncthreads().
__device__ unsigned await_any(const RingArgs& a, int my, unsigned epoch, unsigned done,
                              unsigned long long deadline, unsigned* ready_smem) {
  if (threadIdx.x == 0) {
    const int parity = static_cast<int>(epoch & 1u);
    unsigned ready = 0;
    for (;;) {
      for (int h = 1; h < a.n; ++h) {
        if (!((done >> h) & 1u) && landed(flag(a, my, parity, h, blockIdx.x), epoch)) {
          ready |= 1u << h;
        }
      }
      if (ready) break;
      if (now_ns() > deadline) {
        const int h = __ffs(~done & ~1u) - 1;
        trap_late(a, "ag_ring", my, h, epoch, flag(a, my, parity, h, blockIdx.x));
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
  if (PATH == kPath16) {
    // Up to kBatch arrivals at a time: every load, then every store.
    while (ready) {
      int hop[kBatch];
      uint4 q[kBatch];
      float s[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        hop[k] = 0;
        if (ready) {
          hop[k] = __ffs(ready) - 1;
          ready &= ready - 1;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (hop[k] && lane < block / 16) {
          load16(a, slot(a, my, parity, hop[k]), b, lane, q[k], s[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (hop[k]) {
          const int src = (my + n - hop[k]) % n;
          dequant_store16<W>(out + src * chunk + qoff, block, lane, q[k], s[k]);
        }
      }
    }
  } else {
    for (; ready; ready &= ready - 1) {
      const int h = __ffs(ready) - 1;
      const uint8_t* r = slot(a, my, parity, h);
      float* ob = out + ((my + n - h) % n) * chunk + qoff;
      const float s = load_slot_scale<PATH>(a, r, b);
      if (PATH == kPath4) {
        for (int g = lane; g < block / 4; g += 32) {
          const uint32_t w = __ldcg(reinterpret_cast<const unsigned*>(r + qoff) + g);
          reinterpret_cast<float4*>(ob)[g] = dequant_word<W>(w, s);
        }
      } else {
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
// order they land.  Like B6 it waits at no entry barrier (the comment on
// rs_ring_kernel).
template <int W, int PATH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ag_ring_kernel(const __grid_constant__ RingArgs a) {
  __shared__ unsigned ready_smem;
  __shared__ unsigned epoch;
  const int n = a.n;
  const int my = a.rank0 + static_cast<int>(blockIdx.y);
  const unsigned long long deadline = now_ns() + a.timeout_ns;
  read_epoch(a, my, "ag_ring", &epoch);
  const int parity = static_cast<int>(epoch & 1u);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = a.block;
  const long long chunk = a.nb * block;
  const long long lo = a.nb * blockIdx.x / gridDim.x;
  const long long hi = a.nb * (blockIdx.x + 1) / gridDim.x;
  const float* x = a.x[my];
  float* own = a.out[my] + my * chunk;
  const long long b0 = lo + warp;
  const auto peers = [&a, my, n, parity](int k) {
    return slot(a, (my + k + 1) % n, parity, k + 1);
  };

  trace_event(a, my, kStart);
  uint4 q0 = make_uint4(0u, 0u, 0u, 0u);
  float s0 = 0.0f;
  if (PATH == kPath16 && b0 < hi) quant16<W>(x + b0 * block, block, a.inv_qmax, lane, q0, s0);
  trace_event(a, my, kQuantized);

  for (long long b = b0; b < hi; b += kWarps) {
    uint4 q = q0;
    float s = s0;
    if (PATH == kPath16 && b != b0) quant16<W>(x + b * block, block, a.inv_qmax, lane, q, s);
    put_block<W, PATH>(a, b, lane, n - 1, peers, q, s, x + b * block, own + b * block);
    if (PATH == kPath16 && b != b0) dequant_store16<W>(own + b * block, block, lane, q, s);
  }
  trace_event(a, my, kSent);
  publish_all(a, my, epoch);
  trace_event(a, my, kPublished);
  if (PATH == kPath16 && b0 < hi) dequant_store16<W>(own + b0 * block, block, lane, q0, s0);
  trace_event(a, my, kOwn);

  const unsigned all = ((1u << n) - 1u) & ~1u;
  for (unsigned done = 0; done != all;) {
    const unsigned ready = await_any(a, my, epoch, done, deadline, &ready_smem);
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

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// B6's and B7's trace buffers for later launches (hvd_rs_ring_trace,
// hvd_ag_ring_trace), or null.
unsigned long long* g_rs_trace = nullptr;
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
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  bump_epochs<<<1, 32, 0, s>>>(a.epoch, ranks);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(g), static_cast<unsigned>(ranks)), dim3(kThreads),
      params, 0, s));
}

// Fills `a` from the C arguments; returns a cudaError_t.
int make_args(RingArgs& a, void* const* x, void* const* out, void* const* deq,
              void* const* win, int n, int rank0, int ranks, long long nb, int block,
              float inv_qmax, void* epoch, long long slot_bytes, double timeout_s) {
  if (n < 2 || n > kMaxRanks || ranks < 1 || rank0 < 0 || rank0 + ranks > n || nb < 1 ||
      block < 1 || epoch == nullptr || timeout_s <= 0.0 ||
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
  a.epoch = static_cast<unsigned*>(epoch);
  a.inv_qmax = inv_qmax;
  return 0;
}

template <int W, bool DEQ>
const void* rs_kernel(int path) {
  if (path == kPath16) return reinterpret_cast<const void*>(rs_ring_kernel<W, DEQ, kPath16>);
  if (path == kPath4) return reinterpret_cast<const void*>(rs_ring_kernel<W, DEQ, kPath4>);
  return reinterpret_cast<const void*>(rs_ring_kernel<W, DEQ, kPath1>);
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
// slots of `slot_bytes`, then the flags, one uint32 per (parity, slot,
// stripe), rounded up to the slot alignment.
extern "C" long long hvd_ring_window_bytes(int n, long long slot_bytes) {
  if (n < 2 || n > kMaxRanks || slot_bytes < 0 || slot_bytes % kSlotAlign != 0) return -1;
  const long long flags = 2LL * (n - 1) * kMaxStripes * 4;
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
// are used; win holds every rank's window as mapped here; epoch points to
// the launched ranks' epoch words in device memory, which the launch
// advances (two kernels: bump_epochs, then the ring).  The tables are
// copied into the kernel's arguments by value.
extern "C" int hvd_rs_ring(void* const* x, void* const* acc, void* const* deq,
                           void* const* win, int n, int rank0, int ranks, long long nb,
                           int block, int wire, float inv_qmax, void* epoch,
                           long long slot_bytes, double timeout_s, void* stream) {
  RingArgs a;
  int e = make_args(a, x, acc, deq, win, n, rank0, ranks, nb, block, inv_qmax, epoch,
                    slot_bytes, timeout_s);
  if (e != 0) return e;
  a.trace = g_rs_trace;
  a.trace_events = kRsTraceEvents;
  const bool with_deq = deq != nullptr;
  const int path = ring_path(a, rank0, ranks, with_deq);
  const void* k;
  if (wire == kInt8) k = with_deq ? rs_kernel<kInt8, true>(path) : rs_kernel<kInt8, false>(path);
  else if (wire == kFp8) k = with_deq ? rs_kernel<kFp8, true>(path) : rs_kernel<kFp8, false>(path);
  else return static_cast<int>(cudaErrorInvalidValue);
  e = launch(k, a, ranks, stream);
  return e != 0 ? e : static_cast<int>(cudaGetLastError());
}

// B7, as hvd_rs_ring: x holds shards (nb, block), out (n, nb, block).
extern "C" int hvd_ag_ring(void* const* x, void* const* out, void* const* win, int n,
                           int rank0, int ranks, long long nb, int block, int wire,
                           float inv_qmax, void* epoch, long long slot_bytes,
                           double timeout_s, void* stream) {
  RingArgs a;
  int e = make_args(a, x, out, nullptr, win, n, rank0, ranks, nb, block, inv_qmax, epoch,
                    slot_bytes, timeout_s);
  if (e != 0) return e;
  a.trace = g_ag_trace;
  a.trace_events = kTraceEvents;
  const int path = ring_path(a, rank0, ranks, false);
  const void* k;
  if (wire == kInt8) k = ag_kernel<kInt8>(path);
  else if (wire == kFp8) k = ag_kernel<kFp8>(path);
  else return static_cast<int>(cudaErrorInvalidValue);
  e = launch(k, a, ranks, stream);
  return e != 0 ? e : static_cast<int>(cudaGetLastError());
}

// The trace buffers for later launches: `buf` holds kRsTraceEvents (B6)
// or kTraceEvents (B7) uint64 for each of kMaxStripes (2048) blocks of
// each launched rank; null turns the trace off.
extern "C" void hvd_rs_ring_trace(void* buf) {
  g_rs_trace = static_cast<unsigned long long*>(buf);
}

extern "C" void hvd_ag_ring_trace(void* buf) {
  g_ag_trace = static_cast<unsigned long long*>(buf);
}
