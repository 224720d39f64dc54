#!/usr/bin/env python3
"""Drive horovod_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc``; it exits non-zero, printing no result, without
them or outside a checkout.  Phases, one line each or more (any failure
exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off
   for float32 matmuls and convolutions (stated).
2. build: ``horovod_tpu_torch/csrc/scale_cast.cu`` (kernel B1),
   ``quant.cu`` (B3, B4, B5), ``flash_attn_sm90.cu`` (B2's wgmma
   route), ``flash_attn.cu`` (B2's retained mma route) and
   ``quant_ring.cu`` (B6, B7) compiled with ``nvcc`` for sm_90a, one
   ``nvcc`` per source, started together; ptxas's register and spill
   lines, and the wgmma route's shared memory per block.
3. kernel: B1 against its plain PyTorch version, bitwise, at the
   ResNet-50 bf16 wire's bucket sizes and at 1 / 127 / 65 537 elements,
   for f32->bf16, bf16->f32, bf16->bf16 at scale 1/3 and f32->f16 with
   NaN, infinities, f16 overflow and subnormals, and at the smaller
   bucket beside ``x.to``; then B3 (int8 and fp8,
   with and without the dequant), B4 (1, 2 and 4 arrivals) and B5,
   bitwise, at the int8 wire's padded bucket sizes and at a ragged size
   for blocks 64 / 128 / 512 / 96, with an all-zero, an inf, a NaN and a
   subnormal block.  Each with the kernel's, the plain version's and
   (where one call computes the same function) the library call's time,
   and the memory bound.  Then B6 (with and without the dequant) and B7,
   the quantized rings, bitwise against their plain versions on 2 and 4
   virtual ranks of the one card (every rank's blocks in one grid, the
   windows all on this card), at the 32 MiB plan's bucket sizes padded
   to n·512 and at a ragged size for blocks 64 / 512 / 96 / 36 / 33 (the
   rings' 16-byte, 4-byte and byte paths), int8 and fp8, with the special
   blocks; the times at world 4 on the largest bucket beside the bound
   (this run's inputs and outputs over 3.35 TB/s: on one card the
   "peer" stores stay in its memory) and, as the yardstick, the B3 + B4
   (B3 + B5) kernels of the NCCL lowering for the same ranks; and B6's
   and B7's per-block timelines (``ring_trace``).  B6 and B7 are also
   captured into one CUDA graph on 2 and 4 virtual ranks and replayed
   three times on fresh inputs, with an eager launch before and after,
   each bitwise (the epoch words on the card carry across).
   Then B2, flash attention, each case on the route that serves its
   dtype and head dim, against its plain version at that route's key
   tile (``FLASH_TOL``): at the GPT slice's shape (B 16, T 1024, H 12,
   D 64, bf16, the wgmma route) causal dense, causal packed,
   non-causal, ragged T 1000; bf16 at D 128 (6 heads, wgmma); float32 at
   ``gpt_tiny``'s heads (4 x 16, T 256) and bf16 at D 32 (the mma
   route); and the mma route held and timed at the causal dense GPT
   shape too.  Each with the kernel's and the plain version's time, and
   for causal dense ``scaled_dot_product_attention``'s, each beside the
   bound from the bytes and the operations this run's masks need.
4. slice bf16: ``init`` on NCCL (world of one), full-width ResNet-50 at
   224x224, batch 32, bf16 compute, ``HVD_TPU_SCHED_WIRE=bf16``,
   ``build_dp_step``; 2 warm-up + 5 timed steps with finite losses, B1
   launched exactly twice per bucket per step (world of one: ``_scale``
   skips the factor 1.0).
5. slice int8: the same model, weights and batch with
   ``HVD_TPU_SCHED_WIRE=int8`` and error feedback: 2 warm-up + 5 timed
   steps, finite losses, the first equal to the bf16 run's (rtol 1e-5:
   the same forward before any update), every bucket on int8, non-zero
   residuals, and per bucket per step B3 twice, B4 and B5 once, B1, B6
   and B7 never (a world of one falls back from the ring).  Then fp8
   for 1 warm-up + 2 steps, with its counts.
   Each bucket's exchange runs after the backward (the default).
   Then slice overlap: the same model at world one on bf16 and on int8,
   each bucket's exchange launched from the backward, on the exchange
   worker thread and stream (``HVD_TPU_SCHED_BARRIERS=1``), and after it
   (``=0``), in turns (on, off, off, on), 2 warm-up
   + 10 timed steps and one traced step each: the four runs' weights and
   losses bitwise equal, exact launches in each, every bucket launched
   from the backward in the overlapped runs and none in the others;
   step ms, img/s and, from CUDA events, each bucket's exchange start
   and end against the end of the backward's kernels.
   Then slice onestep: the same model at world one on bf16 and on int8,
   eager (``HVD_TPU_ONESTEP=off``), captured as one CUDA graph (``on``)
   and captured with ``HVD_TPU_SCHED_BARRIERS=1``, 2 warm-up + 5 steps
   each from seed 0: weights and losses bitwise equal, exact launches
   with the replays counted (inferred: a replay adds its capture's
   counts; the bitwise equality shows it ran), one capture
   (``xir.onestep.steps``) and no
   exchange run from Python after it; then windows of 10 steps, captured
   against eager (A/B/B/A) and captured with the barriers on against off
   (A/B/B/A): step ms, img/s and peak memory.  Every other phase pins
   ``HVD_TPU_ONESTEP=off``, so it runs as before.
6. reference: a small float32 ResNet on the card against the CPU path
   (plain versions), three steps on the bf16 wire and three on int8, to
   stated tolerances.
   Then slice eager: ``init`` on NCCL (world of one) and every op of
   the eager API (``ops/eager.py``) once (``eager_checks``): allreduce
   with every ReduceOp but Adasum on float32, bf16 and int32, grouped
   allreduce (fused and not), allgather, allgather_v, broadcast,
   reducescatter, even and uneven alltoall, barrier, join, an async
   allreduce polled until done, and the gradients of allreduce and
   allgather, each bitwise with what the rank computes itself on the
   CPU from seed 0's dyadic inputs; B1 launched exactly twice by a bf16
   allreduce with a pre- and a postscale, and bitwise with its plain
   version; a bf16 ``allreduce_`` with both scales captured into a CUDA
   graph and replayed three times bitwise with eager, ``poll`` refused
   under capture; one line per group with its host ms per call.
7. slice ring: the same model in a world of processes on the int8 wire
   with error feedback, ``HVD_TPU_QUANT_BACKEND=fused`` and
   ``HVD_TPU_FUSION_THRESHOLD=33554432`` (32 MiB: four buckets, each
   packed payload under the ring's 8 MiB cap), batch 32 per rank, 2
   warm-up + 5 timed steps: per bucket per step B6 and B7 once, B1 once
   (the 1/size postscale), B3, B4 and B5 never, no fallback; the first
   loss equal to a ``phase`` run's from the same weights; bitwise-equal
   weights on every rank; img/s.  With two or more cards, min(count, 4)
   ranks, one per card, on NCCL, the stores crossing NVLink, and each
   bucket's exchange timed on the ring and on the NCCL lowering; with
   one card, two ranks sharing it on gloo (NCCL refuses two ranks on
   one card), the stores staying on the card.  In either, B6 (with and
   without the dequant) and B7 bitwise against their plain versions on
   every rank at the largest bucket and at blocks 96 / 64 / 36 / 33;
   across cards also B6's and B7's timelines on rank 0, and the overlap
   runs of phase 5 at this world on the int8 ring and on bf16 over
   NCCL: every rank's weights bitwise equal in each run and across the
   four, with B6's and B7's device time per launch beside the backward
   and after it (``torch.profiler``, one step each of the int8 runs);
   then the step captured against eager on the int8 ring (B6 and B7 in
   the graph) and on bf16 over NCCL, every rank bitwise with exact
   launches, and its A/B/B/A windows.  On one shared card (gloo)
   ``HVD_TPU_ONESTEP=on`` must refuse the step.  Every rank first runs
   the slice eager checks at this world (the capture only on NCCL).
   Then slice sets: a world of four ranks (four sharing the one card on
   gloo; one per card on NCCL with four cards) registers the process
   sets {0,1} (tiling the world with {2,3}), {1,3} (with {0,2}) and
   {0,1,2} (which does not tile) at ``init``.  Every rank runs every
   eager op on each set, bitwise with what it computes itself on the CPU
   for its row, member or not (``set_eager_checks``; a bf16 allreduce
   with a pre- and a postscale launches B1 exactly twice on a member and
   never off the set); ``quantized_allreduce_ef`` on {0,1} and {1,3},
   int8 and fp8, fused backend, every rank in its tile: B3 twice, B4 and
   B5 once, B6 and B7 never (two ``quant.fused_fallback`` per call: the
   ring's window spans the world), result and residual bitwise with the
   plain versions' NCCL lowering on the CPU, each tile's ranks equal, and
   {0,1,2} raising ``ProcessSetTilingError`` (``set_quant_checks``);
   then full-width ResNet-50 (224x224, batch 32 per rank, bf16 compute,
   each rank its own data) with ``DistributedOptimizer(process_set=
   {0,1})`` for 2 warm-up + 3 steps on the bf16 wire and on int8 with
   error feedback: finite losses, exact launches per bucket per step
   (bf16: B1 three times on a member, never off the set; int8 on every
   rank: B3 twice, B1, B4 and B5 once), ranks 0 and 1 bitwise equal, on
   bf16 each non-member bitwise equal to its own solo step (the same SGD
   on its own batch, cuDNN deterministic), on int8 ranks 2 and 3 (one
   tile) bitwise equal.  On NCCL also each run captured
   (``HVD_TPU_ONESTEP=on``), bitwise with eager on every rank with one
   capture; windows of 10 steps of the step on the set and on the world,
   captured and eager, in turns; and ``remove_process_set`` of the set
   under a captured step, which drops its graph, the set added again
   under a new id and captured anew.
8. slice gpt: ``init`` on NCCL (world of one), GPT-2 small at its
   published widths (vocab 50304, 12 layers, width 768, 12 heads x 64,
   ff 3072, seq 1024, bf16 compute), batch 16, ``build_lm_step`` with
   AdamW (``capturable=True`` on the card) and ``Compression.bf16``
   (``HVD_TPU_SCHED_WIRE=off``, as ``bench_gpt``); dense rows for 2
   warm-up + 5 timed steps, packed rows (``packed_lm_batch``) for 1 + 2;
   finite losses, the first dense one within 1 of ln(50304), B2 launched
   exactly 12 times per step, all on the wgmma route, and no other
   kernel; step ms, tokens/s and peak memory.  Each row kind again with
   the step captured as one CUDA graph (``HVD_TPU_ONESTEP=on``) for as
   many steps from the same weights: losses and weights bitwise equal
   to the eager run's, one capture, B2 12 times per step counted on the
   replays; then windows of 5 steps, captured and eager in turns
   (A/B/B/A), with step ms and tokens/s.
   Then slice gpt remat: the same model and batch with ``remat=True``
   against off, eager, in turns (on, off, off, on), then remat captured,
   4 steps each: losses and weights bitwise equal in all five runs, B2
   24 times per step with remat (each block's forward again in the
   backward) and 12 without; peak allocated memory and step ms.
   Then slice hybrid: GPT-2 small at the same widths in a world of four
   ranks (four sharing the one card on gloo; one per card on NCCL with
   four cards, ``--only ring``), seq 1024, batch 2 per dp rank, the bf16
   wire of ``sync_gradients``, over three meshes for 1 + 3 steps each:
   ``dp2 x tp2`` with flash attention (B2 at 6 heads), ``sp2 x tp2``
   with ring attention (no B2) and ``sp4`` with Ulysses (B2 at 3 heads
   over T 1024); then ``dp2 x tp2`` for 2 steps on int8, where the tp
   shards' mean is over dp alone (B3 twice, B4, B5 and B1 once per such
   bucket).  Checks: finite losses; each mesh's first loss within 2^-8
   of the unsharded flash step on the same tokens and weights; replicated
   parameters bitwise equal on every rank and each tp shard across its
   replicas; B2 and B1 launches per step exactly as the mesh implies
   (B1 three times per bf16 bucket: the down-cast, the 1/n mean and the
   up-cast); B2 at the tp and Ulysses shapes against its plain version;
   step ms and tokens/s.
   Then slice moe: GPT-2 small with a mixture-of-experts FFN in every
   second block (4 experts of 768, top-2, capacity factor 1.25), world
   one, batch 4 x 1024, ``build_lm_step``: eager and captured for 4
   steps each, bitwise (losses and weights, one capture), B2 12 per
   step; step ms and peak memory.  Then, in a world of four ranks (four
   sharing the one card on gloo; one per card on NCCL with four cards,
   ``--only ring``), the meshes ``ep4`` (2 experts a rank, 8 of 1536)
   and ``dp2 x ep2``: on every rank the MoE layer over ep in float32 on
   its own 2 x 1024 tokens against the layer the rank computes alone
   over every expert's weights (output, aux, the input's, router's and
   experts' gradients; ``MOE_LAYER_RTOL``), then the GPT step over the
   mesh (``build_hybrid_lm_step``, bf16 wire) for 1 + 3 steps: finite
   losses, replicas bitwise, B2 12 per step and B1 3 per bucket
   exchange; step ms.
   Then slice pipeline: ``pipeline_apply`` over ``pp4`` (the same two
   layouts), GPT-2 small's 12 blocks 3 a stage (flash, bf16), 8
   microbatches of [2, 1024, 768], with ``remat_stage`` off and on:
   outputs bitwise with each rank applying the 12 blocks in sequence,
   every stage's gradients within ``PIPE_GRAD_RTOL``, remat bitwise with
   off, B2 3 x (8 + 4 - 1) launches per stage (doubled with remat); ms.
   Then slice fsdp: GPT-2 small, flash, batch 2 x 1024 per rank, AdamW,
   in the same layouts: the replicated data-parallel step (dense and
   ``Compression.bf16``), ``fsdp_train_step`` (dense and bf16) and
   ``zero_train_step`` on the int8 wire with error feedback, 3 steps
   each from the same weights: first losses equal, weights after 3 steps
   within ``ADAM_APART`` and the ``FSDP_RATIO`` mean move of the
   replicated step's; on int8 every B3/B4/B5 call of the first step's
   reduce-scatter bitwise with its plain version and the shard within
   the int8 grid of the dense mean, B3 2, B4 1 and B5 1 per step (or B6
   and B7 once where the ring serves; the dispatch printed); persistent
   bytes per rank and step ms.
   Then slice topo: a world of four ranks (the same layouts) with
   ``HVD_TPU_TOPO=2x2`` (domains {0,1} and {2,3}).  The hierarchical
   allreduce (``topo/hierarchical.py``) of 16,489,448 dyadic float32
   elements (the largest ResNet-50 bucket) on the off, bf16 and int8
   cross-domain hops: bitwise with the plain kernels' chain on the CPU
   and, off and bf16, with the flat allreduce; B1 exactly twice on bf16;
   B3 twice, B4 and B5 once on int8, each call bitwise with its plain
   version, two ``quant.fused_fallback`` (groups never take the ring);
   every rank equal; ms per call against the flat allreduce.  Adasum of
   4,194,305 normal float32 elements flat over the world, over {0,1,2}
   (rank 3 keeps its input) and ``hier_adasum``, each on rank 0 within
   ``TOPO_ADASUM_RTOL`` of a float64 NumPy Adasum written as the
   recursive pairwise definition, the members bitwise equal; ms per
   call.  Then full-width ResNet-50 (224x224, batch 32 per rank, seed 0,
   each rank its own batch) for 2 warm-up + 3 steps: the replicated
   step's first loss, then ``op=Adasum`` on bf16 (every bucket
   ``hier_adasum``), ``sync_bn=True`` on bf16 (flat) and
   ``HVD_TPU_TOPO_LOWER=hier`` on int8: exact launches per bucket per
   step (``topo_expected``), replicas bitwise, the first loss equal to
   the replicated step's (SyncBatchNorm's: within
   ``TOPO_SYNC_BN_RTOL`` of one forward over the four batches
   concatenated), step ms; on NCCL each run captured
   (``HVD_TPU_ONESTEP=on``) bitwise with eager, one capture; on gloo
   ``on`` refuses, its reason printed.
9. reference gpt: a small bf16 GPT (2 layers, width 128, 2 heads x 64,
   seq 256) for three steps on the card against the CPU path, to stated
   tolerances.
10. examples: ``examples/torch_port_mnist.py`` (one epoch of 4096
   samples), ``examples/torch_synthetic_benchmark.py --num-iters 1`` and
   ``examples/torch_fsdp_gpt.py --steps 3`` run as a user starts them,
   each checked for its last lines.
11. slice tune: the native core built (``native.available()``) and
   taking ResNet-50's bucket plan; the full-width ResNet-50 (bf16 wire,
   world of one) under ``HVD_TPU_AUTOTUNE=1`` until the driver converges:
   each window's threshold, lowering, wire, score and device ms per step
   (CUDA events), every timed step a replay, B1 exactly twice per bucket
   per replay of each variant, graphs held while exploring (at most
   ``MAX_GRAPHS``) and after the drop (1) with the reserved memory
   before and after it, and the frozen variant's captured step bitwise
   with a fresh step at ``HVD_TPU_FUSION_THRESHOLD`` of the frozen
   threshold from the same state over three batches; then
   ``ScheduleTuner`` with ``HVD_TPU_TUNE_DB`` in a temporary directory:
   the first tuner explores and stores, a second hits
   (``sched.tune.db_hit`` 1, converged at window 0), each window's
   registry score beside its device time.  On four cards
   (``--only tune``) four NCCL ranks instead: the autotuned step with
   the int8 probe (exact B3-B7 launches per replay, replicas bitwise),
   ``HVD_TPU_HIERARCHICAL_ALLREDUCE`` Sum and Average of 16,489,448
   float32 on ``HVD_TPU_TOPO=2x2`` bitwise with flat, the measured cost
   model's fit beside CUDA-event times, a ``topo.dcn_phase`` fault plan
   (capture refused, fired on rank 1 only) and ``metric_average``.
12. result: the card line, the kernels JSON line (each kernel with its
   launches on every path, ``paths``), then
   ``{"ok": true, "device": {...}}`` as the last line.

Every kernel time is given three ways (``split_ms``): the device time
(``ms``: the calls queued behind a spin kernel that outlasts their
issue, so the events bracket device work only), the host-paced time of
earlier runs (``paced_ms``: events around back-to-back calls on an idle
stream, the host's issue rate where that is slower) and the host's cost
per call while the stream is busy (``host_ms``).  A device time below
the host cost means the main path's calls of that kernel are paced by
the host.

``--out PATH`` also writes every measurement as JSON.  ``--only ring``
runs phases 1, 2 and 7 (slice ring, then slice sets), then, with two
cards or more, the GPT step at world min(count, 4) eager and captured
(``tools/torch_lm_multi.py``: every rank bitwise, captured bitwise with
eager, exact launches, a pair of windows) and slice hybrid (the phases
that need more than one card, for a run on several), then the
four-rank worlds of slice moe, slice pipeline, slice fsdp and slice topo; ``--only
sets``, ``hybrid``, ``moe`` (world one and the meshes), ``pipeline``,
``fsdp``, ``remat`` and ``topo`` phases 1, 2 and that phase (``topo``
is also among ``--only ring``'s four-rank worlds), ``--only tune``
phases 1, 2 and 11 (its four-rank world with four cards or more),
``--only kernel`` phases 1 to 3; none prints a kernels line.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor core; FFMA
WARMUP, TIMED = 2, 5
OVERLAP_TIMED = 10  # timed steps of each overlap run
FP8_WARMUP, FP8_TIMED = 1, 2
PACKED_WARMUP, PACKED_TIMED = 1, 2
BLOCK = 512  # HVD_TPU_QUANT_BLOCK default
GPT_BATCH, GPT_SEQ, GPT_LAYERS, GPT_VOCAB = 16, 1024, 12, 50304
# Windows of the captured GPT step against eager, in turns.
GPT_WINDOWS, GPT_WINDOW_STEPS = ["captured", "eager", "eager", "captured"], 5
# Phase slice hybrid: the meshes (degrees, attention), rows per dp rank,
# timed steps after the first, int8 steps on dp2 x tp2.  The first loss
# of each mesh against the unsharded flash model on the same tokens and
# weights: the loss is a float32 mean over 2048 or 4096 tokens of
# logits from a bf16 residual stream that tensor parallelism rounds
# once more (each rank's partial product, before the sum); on an H100
# the gaps were at most 5e-6 of the loss, and the limit is 20 times
# that.  The gradients after ``sync_gradients`` against the unsharded
# model's, both models computing in float32 (each parameter's shard, by
# the norm of the difference over the norm of the unsharded gradient):
# the bf16 wire rounds each element twice (the cast, the sum), to 2^-8
# of itself, and the limit is 4 times that (float32 compute keeps the
# models' own rounding far below it).  A wrong sum or routing of
# cotangents moves whole gradients: the worst parameter by 0.92 with
# the row layer's backward sum left out (gpt_tiny on the CPU), by 0.75
# with the ring's staged hop cutting the gradient of K and V (an H100).
HYBRID_MESHES = {"dp2_tp2": ({"dp": 2, "tp": 2}, "flash"),
                 "sp2_tp2": ({"sp": 2, "tp": 2}, "ring"),
                 "sp4": ({"sp": 4}, "ulysses")}
HYBRID_BATCH, HYBRID_TIMED, HYBRID_INT8 = 2, 3, 2
HYBRID_LOSS_RTOL = 1e-4
HYBRID_GRAD_RTOL = 2.0 ** -6
SOURCES = ["scale_cast", "quant", "flash_attn", "flash_attn_sm90", "quant_ring"]
RING_THRESHOLD = 32 * 1024 * 1024  # HVD_TPU_FUSION_THRESHOLD of the ring slice
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way
REPLACES = {
    "scale_cast": "horovod_tpu/ops/pallas_kernels.py:56",
    "quant_pack": "horovod_tpu/ops/pallas_quant.py:139",
    "dequant_accum": "horovod_tpu/ops/pallas_quant.py:174",
    "dequant_rows": "horovod_tpu/ops/pallas_quant.py:197",
    "flash_fwd": "horovod_tpu/ops/pallas_kernels.py:144",
    "rs_ring": "horovod_tpu/ops/pallas_quant.py:371",
    "ag_ring": "horovod_tpu/ops/pallas_quant.py:515",
}
# B2 against its plain version at the kernel's key tile: (out rtol, out
# atol, lse atol).  The kernel sums its dot products and row sums in
# another order than the plain version's matmuls; in bf16 a score that
# moves by a float32 ulp can round p, and the output, to the other bf16
# neighbour, so out agrees to 2^-7 of itself + 2^-9; lse (about 7 at
# T 1024) to 1e-4, some 100 float32 ulps.  float32: 1e-5 (FFMA sums).
FLASH_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -9, 1e-4),
             "float32": (1e-5, 1e-5, 1e-5)}
# Two runs of three AdamW steps (lr 3e-4, weight decay 1e-4 on weights
# below 1) can differ by at most this much (``reference_gpt_phase``).
ADAM_APART = 2 * 3 * 3e-4 * (1.004 + 1e-4) + 1e-6
# Phase slice gpt remat: steps of each run (the captured run's third is
# its capture, its fourth a replay).
REMAT_STEPS = 4
# Phase slice moe, world of one: GPT-2 small with an MoE FFN in every
# second block, its batch and steps (1 + 3, the captured run's capture
# being the third).  Batch 4, not 16: the dense [S, E, C] combine
# grows as 2.5·S² floats, ~170 MB per MoE layer at S 4096.
MOE_CFG = {"moe_every": 2, "num_experts_local": 4, "moe_k": 2, "moe_capacity_factor": 1.25}
MOE_BATCH, MOE_STEPS = 4, 4
# Phases slice moe (meshes), pipeline and fsdp: ranks of each world.
MESH_WORLD = 4
# The meshes of phase slice moe, experts per rank, rows per rank, timed
# steps after the first.  The layer over ep against the rank's lone
# layer, both in float32 (TF32 off): the products and sums run in other
# orders and shapes, some float32 ulps of each tensor's largest
# element (4.1e-7 on the CPU); a token sent to the wrong expert or rank
# moves whole rows, O(1) of it.  The limit is 1e-4.
MOE_MESHES = {"ep4": {"ep": 4}, "dp2_ep2": {"dp": 2, "ep": 2}}
MOE_MESH_EXPERTS, MOE_MESH_BATCH, MOE_MESH_TIMED = 2, 2, 3
MOE_LAYER_RTOL = 1e-4
# Phase slice pipeline: microbatches and their rows.  The outputs are
# the same kernels on the same inputs as the sequential blocks' (a hop
# is a copy, the broadcast adds zeros), so they must agree bitwise.
# Each rank's loss is sum(out · wts) / 4, so the broadcast's backward
# sums four bf16 cotangents of wts / 4, which can round once (2^-9 of
# each element), and the stages add the microbatches' gradients in
# another order: the gradients agree to 2^-6 of their norm
# (HYBRID_GRAD_RTOL's limit); a lost or misrouted hop moves them O(1).
PIPE_M, PIPE_ROWS = 8, 2
PIPE_OUT_ATOL = 0.0
PIPE_GRAD_RTOL = 2.0 ** -6
# Phase slice fsdp: rows per rank, steps checked, then steps timed.  The first loss is the same
# forward on the same weights as the replicated step's; float32 rounding
# of the loss average aside it is equal (rtol 1e-6).  After three AdamW
# steps two runs whose gradients round differently are at most
# ADAM_APART apart, and (``reference_gpt_phase``'s check) the mean
# difference of each tensor is at most this share of its mean move: the
# dense and bf16 wires differ from the replicated step only in the order
# of their sums (0.25); the int8 wire's quantization noise turns the
# sign of Adam's first steps on the elements whose gradient is below it,
# and the limit there only says that most elements step the same way
# (1.0; two runs of independent signs would give about 1.3).
FSDP_BATCH, FSDP_STEPS, FSDP_TIMED = 2, 3, 3
FSDP_LOSS_RTOL = 1e-6
FSDP_RATIO = {"dense": 0.25, "int8": 1.0}


def time_ms(fn, iters: int = 20) -> float:
    """Host-paced time of ``fn``: CUDA events around ``iters``
    back-to-back calls on an idle stream.  Where the host takes longer
    to issue a call than the device takes to run it, this is the host's
    issue rate, not the kernel's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# A spin of torch.cuda._sleep(cycles) sized at this rate lasts at least
# the seconds asked for: it is above the H100's highest SM clock (1.98
# GHz), and a slower clock only lengthens the spin.
SLEEP_CYCLES_PER_S = 2.0e9


def split_ms(fn, iters: int = 20, before_start=None, agree=None,
             required: bool = True) -> dict:
    """Three times per call of ``fn``, in ms:

    - ``ms``, device time: a spin kernel (``torch.cuda._sleep``) is
      queued first, long enough to outlast the host's issue of all
      ``iters`` calls, so the CUDA events around the calls bracket
      device work only;
    - ``paced_ms``: :func:`time_ms`, the host-paced figure of earlier
      runs;
    - ``host_ms``: the host's time per call during that issue, against a
      stream that is busy: the wrapper's own cost.

    ``before_start`` is queued after the spin and before the first event
    (the ring worker aligns its ranks there); ``agree`` turns this
    rank's "the spin covered the issue" into every rank's.  If the spin
    ends before the last call is issued, it is lengthened four-fold and
    the run repeated; after four tries the device time is None, or the
    check fails if ``required``."""
    import torch

    paced = time_ms(fn, iters)
    sleep_s = 2e-3 + 2.0 * iters * paced / 1e3
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        if before_start is not None:
            before_start()
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        covered = not start.query()
        end.synchronize()
        if agree is not None:
            covered = agree(covered)
        if covered:
            return {"ms": start.elapsed_time(end) / iters, "paced_ms": paced,
                    "host_ms": host_s / iters * 1e3}
        sleep_s *= 4
    if required:
        fail(f"a {sleep_s / 4:.3f} s spin did not outlast the issue of {iters} calls")
    return {"ms": None, "paced_ms": paced, "host_ms": host_s / iters * 1e3}


def fmt_split(t: dict) -> str:
    """``device X ms (host-paced Y ms, host Z ms per call)``."""
    dev = "not measured" if t["ms"] is None else f"{t['ms']:.4f} ms"
    return (f"device {dev} (host-paced {t['paced_ms']:.4f} ms, host "
            f"{t['host_ms']:.4f} ms per call)")


def bits(t):
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def finite_err(got, want) -> float:
    both = got.isfinite() & want.isfinite()
    if not both.any():
        return 0.0
    return float((got.float()[both] - want.float()[both]).abs().max())


def kernel_phase(kernels, sizes, log):
    """B1 vs its plain version at ``sizes`` plus ragged sizes; returns
    the timing record of the main path's largest launch."""
    import torch

    specials = torch.tensor(
        [float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 65504.0,
         65520.0, -7e4, 3.0e38, 6e-8, -3e-6, 1e-7, 1.2e-38, 1e-40, -3e-39,
         1 / 3, 1.00390625],
        dtype=torch.float32, device="cuda",
    )
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("f32->bf16", torch.float32, torch.bfloat16, 1.0),
        ("bf16->f32", torch.bfloat16, torch.float32, 1.0),
        ("bf16->bf16*1/3", torch.bfloat16, torch.bfloat16, 1.0 / 3.0),
        ("f32->f16", torch.float32, torch.float16, 1.0),
    ]
    largest = max(sizes)
    record = None
    compare_launches = kernels.scale_cast.launches
    max_err = 0.0
    for name, din, dout, scale in cases:
        case_launches = kernels.scale_cast.launches
        for n in sorted(set(sizes) | {1, 127, 65537}):
            x = torch.randn(n, generator=g, device="cuda") * 8.0
            k = min(n, specials.numel())
            x[:k] = specials[:k]
            x = x.to(din)
            got = kernels.scale_cast(x, scale, dout)
            want = kernels.scale_cast_reference(x, scale, dout)
            torch.cuda.synchronize()
            if not torch.equal(bits(got), bits(want)):
                bad = int((bits(got) != bits(want)).sum())
                fail(f"B1 {name} n={n}: {bad} elements differ from the plain version")
            max_err = max(max_err, finite_err(got, want))
        case_launches = kernels.scale_cast.launches - case_launches
        x = (torch.randn(largest, generator=g, device="cuda")).to(din)
        kt = split_ms(lambda: kernels.scale_cast(x, scale, dout))
        pt = split_ms(lambda: kernels.scale_cast_reference(x, scale, dout))
        if scale == 1.0:
            lt = split_ms(lambda: x.to(dout))
        else:
            lt = split_ms(lambda: x * scale)
        ms, plain_ms, lib_ms = kt["ms"], pt["ms"], lt["ms"]
        nbytes = largest * (x.element_size() + torch.empty(0, dtype=dout).element_size())
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        rec = {"case": name, "n": largest, "ms": ms, "paced_ms": kt["paced_ms"],
               "host_ms": kt["host_ms"], "plain_ms": plain_ms,
               "plain_paced_ms": pt["paced_ms"], "library_ms": lib_ms,
               "library_paced_ms": lt["paced_ms"], "library_host_ms": lt["host_ms"],
               "bound_ms": bound_ms, "bytes": nbytes}
        log["kernel_cases"].append(rec)
        print(f"phase kernel: B1 {name} bitwise at n in {sorted(set(sizes) | {1, 127, 65537})}; "
              f"n={largest}: kernel {fmt_split(kt)}; plain {fmt_split(pt)}; "
              f"library {fmt_split(lt)}; bound {bound_ms:.4f} ms "
              f"(device time {bound_ms / ms:.1%} of bound, library's "
              f"{bound_ms / lib_ms:.1%}); {case_launches} launches", flush=True)
        if name == "f32->bf16":
            record = rec
    # The smallest bucket, where the wrapper's host cost weighs most.
    small = min(sizes)
    x = torch.randn(small, generator=g, device="cuda")
    kt = split_ms(lambda: kernels.scale_cast(x, 1.0, torch.bfloat16))
    lt = split_ms(lambda: x.to(torch.bfloat16))
    log["kernel_cases"].append({"case": "f32->bf16 smallest bucket", "n": small,
                                "ms": kt["ms"], "paced_ms": kt["paced_ms"],
                                "host_ms": kt["host_ms"], "library_ms": lt["ms"],
                                "library_paced_ms": lt["paced_ms"],
                                "library_host_ms": lt["host_ms"]})
    print(f"phase kernel: B1 f32->bf16 at the smallest bucket, n={small}: kernel "
          f"{fmt_split(kt)}; library {fmt_split(lt)}", flush=True)
    compare_launches = kernels.scale_cast.launches - compare_launches
    print(f"phase kernel: {compare_launches} launches for comparison and timing "
          f"(not counted for the main path); max abs error {max_err}",
          flush=True)
    record["max_abs_err"] = max_err
    return record


def quant_input(m, nb, block, g, specials=True):
    """(m, nb, block) float32, magnitudes 1e-3 to 1e3 per block; with
    ``specials`` the first blocks are all zero, hold an inf, a NaN, only
    subnormals, and subnormals beside normals."""
    import torch

    x = torch.randn(m, nb, block, generator=g, device="cuda")
    x *= 10.0 ** torch.randint(-3, 4, (m, nb, 1), generator=g, device="cuda")
    flat = x.view(-1, block)
    if specials and flat.shape[0] >= 5:
        flat[0] = 0.0
        flat[1, 3] = float("inf")
        flat[2, 5] = float("nan")
        flat[3] = torch.linspace(-1e-39, 1e-39, block, device="cuda")
        flat[4, :3] = torch.tensor([1e-40, -3e-39, 1.2e-38], device="cuda")
    return x


def quant_kernel_phase(qk, sizes, log):
    """B3, B4 and B5 against their plain versions, bitwise, at the int8
    wire's padded bucket sizes (``sizes``, elements) and at a ragged size
    for several blocks; times at the largest bucket.  Returns the records
    for the kernels line."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    max_err = {"quant_pack": 0.0, "dequant_accum": 0.0, "dequant_rows": 0.0}

    def check(name, what, got, want):
        torch.cuda.synchronize()
        if got.dtype == torch.int8:
            same = torch.equal(got, want)
        else:
            same = torch.equal(bits(got), bits(want))
        if not same:
            fail(f"{name} {what}: differs from the plain version")
        if got.dtype != torch.int8:
            max_err[name] = max(max_err[name], finite_err(got, want))

    cases = [(BLOCK, v // BLOCK) for v in sizes]
    for block in (64, 128, 512, 96):  # ragged V = 65 537, zero-padded
        v = 65537
        nb = -(-v // block)
        cases.append((block, nb))
    shapes = []
    for block, nb in cases:
        ragged = block * nb not in sizes
        for wire in ("int8", "fp8"):
            m = 4 if ragged else 1
            x = quant_input(m, nb, block, g)
            if ragged:
                x.view(m, -1)[:, 65537:] = 0.0
            for want_deq in (False, True):
                p, d = qk.quant_packed(x, wire, want_deq)
                rp, rd = qk.quant_packed_reference(x, wire, want_deq)
                what = f"{wire} block {block} nb {nb} m {m} deq {want_deq}"
                check("quant_pack", what, p, rp)
                if want_deq:
                    check("quant_pack", what + " (dequant)", d, rd)
            for n in ((1, 2, 4) if ragged else (1,)):
                check("dequant_accum", f"{wire} block {block} n {n}",
                      qk.dequant_accum(p[:n], wire),
                      qk.dequant_accum_reference(p[:n], wire))
            check("dequant_rows", f"{wire} block {block} rows {m}",
                  qk.dequant_rows(p, wire), qk.dequant_rows_reference(p, wire))
        shapes.append(f"{nb}x{block}{' ragged' if ragged else ''}")
    print(f"phase kernel: B3 (int8, fp8; with and without dequant), B4 (1, 2, 4 "
          f"arrivals on ragged sizes), B5 bitwise with their plain versions at "
          f"{shapes}, with zero, inf, NaN and subnormal blocks; max abs error "
          f"{max_err}", flush=True)

    # Times at the largest bucket, as the main path launches them.
    v = max(sizes)
    nb = v // BLOCK
    x = torch.randn(1, nb, BLOCK, generator=g, device="cuda")
    packed, _ = qk.quant_packed(x, "int8")
    row = BLOCK + 4
    q_view = packed[..., :BLOCK]
    s_view = packed[..., BLOCK:].view(torch.float32)  # no copy
    records = {}
    timings = [
        ("quant_pack", "B3 int8 with dequant", 4 * v + nb * row + 4 * v,
         lambda: qk.quant_packed(x, "int8", True),
         lambda: qk.quant_packed_reference(x, "int8", True), None),
        ("quant_pack", "B3 int8 without dequant", 4 * v + nb * row,
         lambda: qk.quant_packed(x, "int8", False),
         lambda: qk.quant_packed_reference(x, "int8", False), None),
        ("quant_pack", "B3 fp8 with dequant", 4 * v + nb * row + 4 * v,
         lambda: qk.quant_packed(x, "fp8", True),
         lambda: qk.quant_packed_reference(x, "fp8", True), None),
        # One arrival, as at a world of one: q·s, which torch.mul of
        # the int8 view and the scale view computes in one call.
        ("dequant_accum", "B4 int8 one arrival", nb * row + 4 * v,
         lambda: qk.dequant_accum(packed, "int8"),
         lambda: qk.dequant_accum_reference(packed, "int8"),
         lambda: torch.mul(q_view, s_view)),
        ("dequant_rows", "B5 int8 one row", nb * row + 4 * v,
         lambda: qk.dequant_rows(packed, "int8"),
         lambda: qk.dequant_rows_reference(packed, "int8"),
         lambda: torch.mul(q_view, s_view)),
    ]
    before = (qk.quant_packed.launches, qk.dequant_accum.launches,
              qk.dequant_rows.launches)
    for name, what, nbytes, kern, plain, lib in timings:
        kt, pt = split_ms(kern), split_ms(plain)
        lt = split_ms(lib) if lib is not None else None
        ms, plain_ms = kt["ms"], pt["ms"]
        lib_ms = lt["ms"] if lt is not None else None
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        rec = {"kernel": name, "case": what, "elements": v, "ms": ms,
               "paced_ms": kt["paced_ms"], "host_ms": kt["host_ms"],
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bytes": nbytes}
        log["kernel_cases"].append(rec)
        lib_txt = fmt_split(lt) if lt is not None else "none"
        print(f"phase kernel: {what}, {v} elements: kernel {fmt_split(kt)}; plain "
              f"{fmt_split(pt)}; library {lib_txt}; bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB; device time {bound_ms / ms:.1%} of bound)",
              flush=True)
        if name not in records:
            records[name] = dict(rec, max_abs_err=max_err[name])
    after = (qk.quant_packed.launches, qk.dequant_accum.launches,
             qk.dequant_rows.launches)
    print(f"phase kernel: {[a - b for a, b in zip(after, before)]} B3/B4/B5 "
          "launches for timing (not counted for the main path)", flush=True)
    return records


# The events of each ring kernel's per-block timeline, in the order of
# its trace buffer (csrc/quant_ring.cu, RsTraceEvent and TraceEvent).
TRACE_EVENTS = {
    "rs_ring": ("start", "sent 1", "sent", "published", "own chunk", "first arrival",
                "all arrivals", "end"),
    "ag_ring": ("start", "quantized", "sent", "published", "own dequant", "first arrival",
                "end"),
}


def ring_trace(peer, name, launch, ranks):
    """The timeline of ring kernel ``name`` (``hvd_rs_ring_trace``,
    ``hvd_ag_ring_trace``): per launched rank and per event, the median
    and the largest time over the grid's blocks, in us from the earliest
    block's start, in the last of five back-to-back launches of
    ``launch``; None for an event the kernel does not record."""
    import torch

    events = TRACE_EVENTS[name]
    set_trace = getattr(peer.library(), f"hvd_{name}_trace")
    buf = torch.zeros(ranks, 2048, len(events), dtype=torch.int64, device="cuda")
    set_trace(buf.data_ptr())
    try:
        for _ in range(5):
            launch()
        torch.cuda.synchronize()
    finally:
        set_trace(None)
    out = []
    for t in buf.cpu():
        rows = t[t[:, 0] != 0].double()
        rel = (rows - rows[:, 0].min()) / 1e3
        rec = {}
        for k, ev in enumerate(events):
            seen = rel[rows[:, k] != 0, k]
            rec[ev] = ([round(float(seen.median()), 2), round(float(seen.max()), 2)]
                       if seen.numel() else None)
        out.append(rec | {"blocks": rows.shape[0]})
    return out


def ring_input(n, cols, block, g):
    """(n, cols) float32 as ``quant_input`` makes it, the special blocks
    copied into one chunk of every rank, so every rank's sum meets them."""
    x = quant_input(n, cols // block, block, g).view(n, cols)
    chunks = x.view(n, n, -1, block)
    for r in range(1, n):
        chunks[r, (r + 1) % n, :5] = chunks[0, 0, :5]
    return x


def ring_kernel_phase(rk, peer, qk, sizes, log):
    """B6 and B7 against their plain versions, bitwise, on 2 and 4
    virtual ranks at the 32 MiB plan's bucket sizes (``sizes``, elements)
    and at a ragged size; times at world 4 on the largest bucket.
    Returns the records for the kernels line."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(3)
    max_err = {"rs_ring": 0.0, "ag_ring": 0.0}

    def check(name, what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(want)):
            fail(f"{name} {what}: differs from the plain version")
        max_err[name] = max(max_err[name], finite_err(got, want))

    before = (rk.rs_ring.launches, rk.ag_ring.launches)
    shapes = []
    for n in (2, 4):
        window = peer.PeerWindow.virtual(n)
        try:
            cases = [(BLOCK, v) for v in sizes] + [(b, 65537) for b in (64, 512, 96, 36, 33)]
            for block, v in cases:
                c = -(-v // (n * block)) * block
                for wire in ("int8", "fp8"):
                    x = ring_input(n, n * c, block, g)
                    x[:, v:] = 0.0  # the padding of a bucket of v elements
                    for want_deq in (False, True):
                        acc, deq = rk.rs_ring(x, window, wire, block, want_deq)
                        racc, rdeq = rk.rs_ring_reference(x, wire, block, want_deq)
                        what = f"n {n} {wire} block {block} c {c} deq {want_deq}"
                        check("rs_ring", what, acc, racc)
                        if want_deq:
                            check("rs_ring", what + " (dequant)", deq, rdeq)
                        del acc, deq, racc, rdeq
                    shards = x[:, :c].contiguous()
                    check("ag_ring", f"n {n} {wire} block {block} c {c}",
                          rk.ag_ring(shards, window, wire, block),
                          rk.ag_ring_reference(shards, wire, block))
                    del x, shards
                shapes.append(f"n{n}:{c}x{block}")
        finally:
            window.close()
        torch.cuda.empty_cache()
    print(f"phase kernel: B6 (with and without the dequant) and B7 bitwise with their "
          f"plain versions on virtual ranks at {shapes} (per-rank chunk c), int8 and "
          f"fp8, with zero, inf, NaN and subnormal blocks; max abs error {max_err}",
          flush=True)

    # B6 and B7 captured into one CUDA graph at the largest bucket, after
    # an eager launch of each: three replays on fresh inputs copied into
    # the graph's static buffers, then one eager launch of each, every one
    # bitwise.  Each replay takes a new epoch from the window's epoch
    # words, and the eager launches after it go on from there.
    v = max(sizes)
    for n in (2, 4):
        window = peer.PeerWindow.virtual(n)
        try:
            c = -(-v // (n * BLOCK)) * BLOCK

            def fresh():
                x = ring_input(n, n * c, BLOCK, g)
                x[:, v:] = 0.0
                return x

            def held(what, x, shards, acc, deq, out):
                racc, rdeq = rk.rs_ring_reference(x, "int8", BLOCK, True)
                check("rs_ring", f"{what} n {n}", acc, racc)
                check("rs_ring", f"{what} n {n} (dequant)", deq, rdeq)
                check("ag_ring", f"{what} n {n}", out, rk.ag_ring_reference(shards, "int8", BLOCK))

            x = fresh()
            shards = x[:, :c].contiguous()
            held("eager before the capture", x, shards,
                 *rk.rs_ring(x, window, "int8", BLOCK, True),
                 rk.ag_ring(shards, window, "int8", BLOCK))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                acc, deq = rk.rs_ring(x, window, "int8", BLOCK, True)
                out = rk.ag_ring(shards, window, "int8", BLOCK)
            for i in range(3):
                new = fresh()
                x.copy_(new)
                shards.copy_(new[:, :c])
                graph.replay()
                held(f"replay {i + 1}", x, shards, acc, deq, out)
            x = fresh()
            shards = x[:, :c].contiguous()
            held("eager after the replays", x, shards,
                 *rk.rs_ring(x, window, "int8", BLOCK, True),
                 rk.ag_ring(shards, window, "int8", BLOCK))
            graph.reset()
            del graph, acc, deq, out, x, shards
        finally:
            window.close()
        torch.cuda.empty_cache()
    print(f"phase kernel: B6 (with the dequant) and B7 captured into one CUDA graph on 2 "
          f"and 4 virtual ranks at {v} elements: an eager launch, three replays on fresh "
          f"inputs and an eager launch after them, each bitwise with the plain versions",
          flush=True)

    # Times at world 4 on the largest bucket, every rank's blocks in one
    # launch; the bound is this launch's inputs and outputs over the
    # card's memory rate (the slots stay on the card).
    n, v = 4, max(sizes)
    c = -(-v // (n * BLOCK)) * BLOCK
    nb = c // BLOCK
    packed = nb * (BLOCK + 4)
    window = peer.PeerWindow.virtual(n)
    records = {}
    try:
        x = torch.randn(n, n * c, generator=g, device="cuda")
        acc, _ = rk.rs_ring(x, window, "int8", BLOCK)
        views = [x[r].view(n, nb, BLOCK) for r in range(n)]

        def lowering_rs():  # B3 + B4 per rank, no transfer
            for r in range(n):
                qk.dequant_accum(qk.quant_packed(views[r], "int8", True)[0], "int8")

        def lowering_ag():  # B3 + B5 per rank, no transfer
            for r in range(n):
                qk.dequant_rows(qk.quant_packed(acc[r].view(1, nb, BLOCK), "int8")[0]
                                .expand(n, nb, BLOCK + 4).contiguous(), "int8")

        timings = [
            ("rs_ring", "B6 int8 with dequant", n * (4 * n * c * 2 + 4 * c),
             lambda: rk.rs_ring(x, window, "int8", BLOCK, True),
             lambda: rk.rs_ring_reference(x, "int8", BLOCK, True), lowering_rs),
            ("rs_ring", "B6 int8 without dequant", n * (4 * n * c + 4 * c),
             lambda: rk.rs_ring(x, window, "int8", BLOCK, False),
             lambda: rk.rs_ring_reference(x, "int8", BLOCK, False), None),
            ("ag_ring", "B7 int8", n * (4 * c + 4 * n * c),
             lambda: rk.ag_ring(acc, window, "int8", BLOCK),
             lambda: rk.ag_ring_reference(acc, "int8", BLOCK), lowering_ag),
        ]
        for name, what, nbytes, kern, plain, lowering in timings:
            kt, pt = split_ms(kern), split_ms(plain, iters=5)
            lt = split_ms(lowering) if lowering is not None else None
            ms, plain_ms = kt["ms"], pt["ms"]
            low_ms = lt["ms"] if lt is not None else None
            bound_ms = nbytes / H100_BYTES_PER_S * 1e3
            rec = {"kernel": name, "case": what, "ranks": n, "elements": v, "chunk": c,
                   "ms": ms, "paced_ms": kt["paced_ms"], "host_ms": kt["host_ms"],
                   "plain_ms": plain_ms, "lowering_kernels_ms": low_ms,
                   "library_ms": None, "bound_ms": bound_ms, "bound_by": "bytes",
                   "bytes": nbytes, "packed_chunk_bytes": packed}
            log["kernel_cases"].append(rec)
            low_txt = fmt_split(lt) if lt is not None else "not timed"
            print(f"phase kernel: {what}, {n} virtual ranks x {v} elements (c {c}): kernel "
                  f"{fmt_split(kt)}; plain {fmt_split(pt)}; the NCCL lowering's kernels "
                  f"{low_txt}; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB; "
                  f"device time {bound_ms / ms:.1%} of bound)", flush=True)
            if name not in records:
                records[name] = dict(rec, max_abs_err=max_err[name])
        for name, what, launch in (
                ("rs_ring", "B6", lambda: rk.rs_ring(x, window, "int8", BLOCK, True)),
                ("ag_ring", "B7", lambda: rk.ag_ring(acc, window, "int8", BLOCK))):
            trace = ring_trace(peer, name, launch, n)
            log[name + "_trace"] = trace
            print(f"phase kernel: {what} timeline, {n} virtual ranks, rank 0 (us from the "
                  f"first block's start, median / largest over the blocks): {trace[0]}",
                  flush=True)
    finally:
        window.close()
    after = (rk.rs_ring.launches, rk.ag_ring.launches)
    print(f"phase kernel: {[a - b for a, b in zip(after, before)]} B6/B7 launches for "
          "comparison and timing (not counted for the main path)", flush=True)
    return records


def slice_phase(hvd, tresnet, build_dp_step, timed_throughput, kernels, qk, rk,
                wire, warmup, timed, card):
    """One run of the main path on the full-width ResNet-50: returns the
    losses, timings, schedule and the launch count of every kernel."""
    import torch

    os.environ["HVD_TPU_SCHED_WIRE"] = wire
    hvd.init("cuda")
    try:
        model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                                 device="cuda")
        step, opt = build_dp_step(hvd, model)
        g = torch.Generator(device="cuda").manual_seed(0)
        batch = (torch.rand(32, 224, 224, 3, generator=g, device="cuda"),
                 torch.randint(0, 1000, (32,), generator=g, device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = (kernels.scale_cast, qk.quant_packed, qk.dequant_accum,
                    qk.dequant_rows, rk.rs_ring, rk.ag_ring)
        for c in counters:
            c.launches = 0
        seconds, losses = timed_throughput(step, batch, iters=timed, warmup=warmup)
        launches = dict(zip(("scale_cast", "quant_pack", "dequant_accum",
                             "dequant_rows", "rs_ring", "ag_ring"),
                            (c.launches for c in counters)))
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        schedule = opt.schedule
        residual = (None if opt.residuals is None else
                    sum(float(r.abs().sum()) for r in opt.residuals))
    finally:
        hvd.shutdown()
    if schedule is None or not all(b.wire == wire for b in schedule.buckets):
        fail(f"the step did not plan the {wire} wire on every bucket")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{wire}: non-finite losses {losses}")
    steps = warmup + timed
    buckets = len(schedule)
    if wire == "bf16":
        expected = {"scale_cast": 2 * buckets * steps, "quant_pack": 0,
                    "dequant_accum": 0, "dequant_rows": 0, "rs_ring": 0, "ag_ring": 0}
    else:
        # Per bucket per step: B3 for the reduce-scatter (with the
        # dequant, for the residual) and for the all-gather, B4 and B5
        # once each; no B1 at a world of one, and no ring (a world of
        # one falls back from it).
        expected = {"scale_cast": 0, "quant_pack": 2 * buckets * steps,
                    "dequant_accum": buckets * steps,
                    "dequant_rows": buckets * steps, "rs_ring": 0, "ag_ring": 0}
    if launches != expected:
        fail(f"{wire}: launches {launches}; the schedule implies {expected} "
             f"({buckets} buckets x {steps} steps)")
    step_ms = seconds / timed * 1e3
    img_s = 32 * timed / seconds
    actual = [b.nbytes // 4 for b in schedule.buckets]
    print(f"phase slice {wire}: ResNet-50 224x224 batch 32 bf16, {wire} wire, "
          f"{buckets} buckets {actual} elements; losses "
          f"{[round(v, 5) for v in losses]}; launches {launches} (= expected); "
          f"residual L1 {residual}; step {step_ms:.2f} ms, {img_s:.1f} img/s, "
          f"peak {peak_gib:.2f} GiB on {card}", flush=True)
    return {"wire": wire, "losses": losses, "step_ms": step_ms, "img_s": img_s,
            "peak_gib": peak_gib, "buckets": actual, "launches": launches,
            "residual_l1": residual}


def expected_launches(wire, buckets, steps, world=1):
    """Kernel launches of ``steps`` ResNet steps of ``buckets`` buckets:
    bf16, B1 twice per bucket per step (and once more for the 1/size
    postscale at world > 1); int8 at world 1, B3 twice (with the dequant
    for the residual, and for the all-gather), B4 and B5 once; int8 on
    the ring, B6 and B7 once and B1 once (the postscale)."""
    zero = {"scale_cast": 0, "quant_pack": 0, "dequant_accum": 0,
            "dequant_rows": 0, "rs_ring": 0, "ag_ring": 0}
    n = buckets * steps
    if wire == "bf16":
        return dict(zero, scale_cast=(2 if world == 1 else 3) * n)
    if world == 1:
        return dict(zero, quant_pack=2 * n, dequant_accum=n, dequant_rows=n)
    return dict(zero, scale_cast=n, rs_ring=n, ag_ring=n)


def profile_step(step, batch):
    """One step under ``torch.profiler``: per launch, B6's and B7's device
    ms (a wait for a late peer included), and the device ms of the step's
    NCCL kernels (waits for peers included), of its other exchange
    kernels (B1, B3-B5) and of every other kernel, the model's forward
    and backward (None when the profiler records no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step(batch))
        torch.cuda.synchronize()
    kinds = (("rs_ring", "rs_ring_kernel"), ("ag_ring", "ag_ring_kernel"),
             ("nccl", "nccl"), ("exchange", "scale_cast"), ("exchange", "quant"))
    times = {"rs_ring": [], "ag_ring": [], "nccl": [], "exchange": [], "compute": []}
    for e in prof.events():
        if getattr(e, "device_type", None) is None or \
                not str(e.device_type).endswith("CUDA") or \
                e.time_range.end <= e.time_range.start:
            continue
        key = next((k for k, pat in kinds if pat in e.name.lower()), "compute")
        times[key].append((e.time_range.end - e.time_range.start) / 1e3)
    if not any(times.values()):
        return None
    return {"rs_ring_ms": times["rs_ring"], "ag_ring_ms": times["ag_ring"],
            "nccl_ms": sum(times["nccl"]), "exchange_ms": sum(times["exchange"]),
            "compute_ms": sum(times["compute"]), "compute_kernels": len(times["compute"])}


def overlap_run(hvd, tresnet, build_dp_step, timed_throughput, counters, batch,
                barriers, timed, profile=False):
    """One run of the ResNet-50 step with each bucket's exchange launched
    from the backward (``barriers``) or after it: ``WARMUP`` + ``timed``
    steps through ``TrainStep``, then one traced step (its chain's launch
    log, where ``from_hook`` means launched from the backward, before
    ``step()``; each bucket's exchange on CUDA events), then,
    with ``profile``, one step under the profiler (after the launch
    counts are read).  Returns the run's record with a digest of the
    final weights and buffers."""
    import torch
    from horovod_tpu_torch.sched import execute

    os.environ["HVD_TPU_SCHED_BARRIERS"] = "1" if barriers else "0"
    dev = hvd.device()
    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0, device=dev)
    step, opt = build_dp_step(hvd, model)
    for c in counters.values():
        c.launches = 0
    seconds, losses = timed_throughput(step, batch, iters=timed, warmup=WARMUP)
    with execute.traced() as chains:  # each bucket on CUDA events
        losses.append(float(step(batch)))
    chain = chains[-1]
    timeline = chain.timeline()
    launches = {k: c.launches for k, c in counters.items()}
    prof = profile_step(step, batch) if profile else None
    under = sum(max(0.0, min(end, 0.0) - start) for start, end in timeline)
    rec = {"barriers": barriers, "losses": losses, "seconds": seconds,
           "step_ms": seconds / timed * 1e3, "launches": launches,
           "buckets": [b.nbytes // 4 for b in opt.schedule.buckets],
           "from_hooks": sum(1 for _, hook in chain.log if hook), "timeline": timeline,
           "ended_before": sum(1 for _, end in timeline if end < 0),
           "exchange_ms": sum(end - start for start, end in timeline),
           "under_ms": under, "profile": prof, "digest": state_digest(model)}
    del model, step, opt
    os.environ.pop("HVD_TPU_SCHED_BARRIERS")
    torch.cuda.empty_cache()
    return rec


def state_digest(model) -> str:
    """SHA-256 of the model's weights and buffers, bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_overlap(runs, what, world):
    """Every run of an A/B set bitwise equal, with exact launches; the
    overlapped runs launched every bucket from the backward, the others
    none."""
    steps = WARMUP + OVERLAP_TIMED + 1
    for r in runs:
        nb = len(r["buckets"])
        want = expected_launches(what, nb, steps, world)
        if r["launches"] != want:
            fail(f"overlap {what} world {world}: launches {r['launches']}; the "
                 f"schedule implies {want} ({nb} buckets x {steps} steps)")
        if r["from_hooks"] != (nb if r["barriers"] else 0):
            fail(f"overlap {what} world {world}: {r['from_hooks']} of {nb} buckets "
                 f"launched from the backward with the barriers "
                 f"{'on' if r['barriers'] else 'off'}")
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"overlap {what} world {world}: non-finite losses {r['losses']}")
    if len({r["digest"] for r in runs}) != 1 or \
            len({tuple(r["losses"]) for r in runs}) != 1:
        fail(f"overlap {what} world {world}: the overlapped and after-backward runs "
             f"differ: digests {[r['digest'][:12] for r in runs]}, losses "
             f"{[r['losses'] for r in runs]}")


def fmt_overlap(r, images):
    """One run's line: step time, img/s and each bucket's exchange."""
    spans = ", ".join(f"{a:+.2f}..{b:+.2f}" for a, b in r["timeline"])
    return (f"{'overlapped' if r['barriers'] else 'after backward'}: step "
            f"{r['step_ms']:.2f} ms, {images * OVERLAP_TIMED / r['seconds']:.1f} img/s; "
            f"buckets' exchange (ms from the backward's end) [{spans}]; "
            f"{r['ended_before']}/{len(r['timeline'])} ended before it, "
            f"{r['under_ms']:.3f} of {r['exchange_ms']:.3f} ms under the backward")


def overlap_phase(hvd, tresnet, build_dp_step, timed_throughput, counters, card, log):
    """Phase slice overlap: the full-width ResNet-50 at world one on the
    bf16 and int8 wires, each bucket's exchange launched from the
    backward and after it, in turns (on, off, off, on)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    batch = (torch.rand(32, 224, 224, 3, generator=g, device="cuda"),
             torch.randint(0, 1000, (32,), generator=g, device="cuda"))
    out = {}
    for wire in ("bf16", "int8"):
        os.environ["HVD_TPU_SCHED_WIRE"] = wire
        runs = []
        for barriers in (True, False, False, True):
            hvd.init("cuda")
            try:
                runs.append(overlap_run(hvd, tresnet, build_dp_step, timed_throughput,
                                        counters, batch, barriers, OVERLAP_TIMED))
            finally:
                hvd.shutdown()
        check_overlap(runs, wire, 1)
        print(f"phase slice overlap {wire}: ResNet-50 224x224 batch 32 bf16, world 1, "
              f"{len(runs[0]['buckets'])} buckets; overlapped, after, after, overlapped: "
              f"weights bitwise equal, launches {runs[0]['launches']} (= expected) in "
              f"each, losses {[round(v, 5) for v in runs[0]['losses']]} on {card}",
              flush=True)
        for r in runs:
            print(f"phase slice overlap {wire}: {fmt_overlap(r, 32)}", flush=True)
        out[wire] = runs
    log["overlap"] = out
    return out


def onestep_run(hvd, tresnet, build_dp_step, timed_throughput, counters, batch,
                onestep, barriers=False):
    """One run of the ResNet-50 step from seed 0 with ``HVD_TPU_ONESTEP``
    at ``onestep`` (``off``: eager; ``on``: ``CAPTURE_WARMUP`` eager steps
    on a side stream, then one captured step replayed), ``WARMUP`` +
    ``TIMED`` steps inside ``execute.traced()``.  Returns the losses, the
    digest of the final weights and buffers, the launch counts (a replay's
    included), the chains made (a captured run makes them in its warm-up
    and its capture only), the buckets the last chain launched from the
    backward, and ``xir.onestep.steps``."""
    import torch
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.sched import execute

    os.environ["HVD_TPU_ONESTEP"] = onestep
    os.environ["HVD_TPU_SCHED_BARRIERS"] = "1" if barriers else "0"
    dev = hvd.device()
    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0, device=dev)
    step, opt = build_dp_step(hvd, model)
    for c in counters.values():
        c.launches = 0
    metrics.reset("xir.")
    with execute.traced() as chains:
        _, losses = timed_throughput(step, batch, iters=TIMED, warmup=WARMUP)
    rec = {"onestep": onestep, "barriers": barriers, "losses": losses,
           "launches": {k: c.launches for k, c in counters.items()},
           "buckets": [b.nbytes // 4 for b in opt.schedule.buckets],
           "chains": len(chains), "from_hooks": sum(1 for _, h in chains[-1].log if h),
           "captures": metrics.get_counter("xir.onestep.steps"),
           "digest": state_digest(model)}
    del model, step, opt, chains
    os.environ["HVD_TPU_ONESTEP"] = "off"
    os.environ.pop("HVD_TPU_SCHED_BARRIERS")
    torch.cuda.empty_cache()
    return rec


def check_onestep(runs, what, world):
    """The eager run, the captured run and (where present) the captured
    run with the barriers on: exact launches in each, one capture per
    captured run and no chain after it, bitwise-equal weights and
    losses."""
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP

    steps = WARMUP + TIMED
    for r in runs:
        nb = len(r["buckets"])
        want = expected_launches(what, nb, steps, world)
        if r["launches"] != want:
            fail(f"onestep {what} world {world} ({r['onestep']}, barriers "
                 f"{r['barriers']}): launches {r['launches']}; the schedule implies "
                 f"{want} ({nb} buckets x {steps} steps, replays included)")
        captured = r["onestep"] == "on"
        chains = CAPTURE_WARMUP + 1 if captured else steps
        if r["captures"] != int(captured) or r["chains"] != chains:
            fail(f"onestep {what} world {world} ({r['onestep']}): {r['captures']} "
                 f"captures and {r['chains']} exchanges run from Python, expected "
                 f"{int(captured)} and {chains}")
        if r["from_hooks"] != (nb if r["barriers"] else 0):
            fail(f"onestep {what} world {world}: {r['from_hooks']} of {nb} buckets "
                 f"launched from the backward with the barriers "
                 f"{'on' if r['barriers'] else 'off'}")
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"onestep {what} world {world}: non-finite losses {r['losses']}")
    if len({r["digest"] for r in runs}) != 1 or len({tuple(r["losses"]) for r in runs}) != 1:
        fail(f"onestep {what} world {world}: the captured and eager steps differ: "
             f"digests {[r['digest'][:12] for r in runs]}, losses "
             f"{[r['losses'] for r in runs]}")


def onestep_windows(hvd, tresnet, build_dp_step, batch, labels, images):
    """Timing windows of ``OVERLAP_TIMED`` steps on one fresh model, in
    the order given (``benchmarks.timed_window``: a captured window's
    warm-up steps and its capture run before its clock starts).  Per
    window: step ms, img/s, and the peak of ``max_memory_allocated`` and
    ``max_memory_reserved`` from its first step (the capture included)."""
    import torch
    from horovod_tpu_torch.utils.benchmarks import timed_window

    dev = hvd.device()
    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0, device=dev)
    step, _ = build_dp_step(hvd, model)
    out = []
    for label in labels:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds, _ = timed_window(step, batch, label, OVERLAP_TIMED)
        out.append({"label": label, "step_ms": seconds / OVERLAP_TIMED * 1e3,
                    "img_s": images * OVERLAP_TIMED / seconds,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30})
    del model, step
    os.environ["HVD_TPU_ONESTEP"] = "off"
    os.environ.pop("HVD_TPU_SCHED_BARRIERS")
    torch.cuda.empty_cache()
    return out


def fmt_windows(windows) -> str:
    return "; ".join(
        f"{w['label'].split('/')[1]} {w['step_ms']:.2f} ms {w['img_s']:.1f} img/s peak "
        f"{w['peak_gib']:.2f} GiB (reserved {w['peak_reserved_gib']:.2f})" for w in windows)


# Windows of phase slice onestep: captured against eager (A/B/B/A), then
# captured with the barriers on against off (A/B/B/A).
ONESTEP_WINDOWS = ["captured", "eager", "eager", "captured", "captured+barriers",
                   "captured", "captured", "captured+barriers"]


def onestep_phase(hvd, tresnet, build_dp_step, timed_throughput, counters, card, log):
    """Phase slice onestep: the full-width ResNet-50 at world one on the
    bf16 and int8 wires, eager, captured as one CUDA graph, and captured
    with the barriers on, each from seed 0: bitwise-equal weights and
    losses, exact launches; then the timing windows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    batch = (torch.rand(32, 224, 224, 3, generator=g, device="cuda"),
             torch.randint(0, 1000, (32,), generator=g, device="cuda"))
    out = {}
    for wire in ("bf16", "int8"):
        os.environ["HVD_TPU_SCHED_WIRE"] = wire
        hvd.init("cuda")
        try:
            runs = [onestep_run(hvd, tresnet, build_dp_step, timed_throughput, counters,
                                batch, mode, barriers)
                    for mode, barriers in (("off", False), ("on", False), ("on", True))]
            check_onestep(runs, wire, 1)
            windows = onestep_windows(hvd, tresnet, build_dp_step, batch,
                                      [f"{wire}/{m}" for m in ONESTEP_WINDOWS], 32)
        finally:
            hvd.shutdown()
        print(f"phase slice onestep {wire}: ResNet-50 224x224 batch 32 bf16, world 1, "
              f"{len(runs[0]['buckets'])} buckets; eager, captured, captured with the "
              f"barriers on: weights and losses bitwise equal, launches "
              f"{runs[1]['launches']} (= expected; a replay's counts are inferred from its "
              f"capture's, the bitwise equality shows it ran) in each, one capture "
              f"(xir.onestep.steps 1); losses {[round(v, 5) for v in runs[0]['losses']]} "
              f"on {card}", flush=True)
        print(f"phase slice onestep {wire}: {fmt_windows(windows)} on {card}", flush=True)
        out[wire] = {"runs": runs, "windows": windows}
    log["onestep"] = out
    return out


def eager_checks(n: int) -> dict:
    """Every op of the eager API (``horovod_tpu_torch.ops.eager``) once on
    this rank's tensors, in an initialized world of ``n`` ranks, each
    held bitwise against what this rank computes itself on the CPU: the
    inputs of every rank come from one numpy generator (seed 0), dyadic
    (multiples of 1/4 in [-2, 2]) or small integers, so every sum,
    product and scale is exact or rounds once.  Checked: allreduce with
    every ReduceOp but Adasum on float32, bf16 and int32; a bf16
    Average with a pre- and a postscale (kernel B1 launched exactly
    twice, and B1 bitwise with its plain version); grouped allreduce,
    fused and under ``HVD_TPU_DISABLE_GROUP_FUSION``; allgather,
    allgather_v with ragged rows, broadcast from rank n-1,
    reducescatter (Sum, Average), even and uneven alltoall with the
    received splits; barrier; an async allreduce polled until done; the
    gradients of allreduce and allgather; join, with rank 0 joining
    0.2 s late (it must be the answer; not timed).  On NCCL, a synchronous bf16
    ``allreduce_`` with both scales captured into a CUDA graph and
    replayed three times on fresh values, bitwise with eager, and
    ``poll`` refused under capture.  Returns the host ms per call of
    each group (a host clock around its calls, each fenced by a
    synchronize) and the backend; raises at the first mismatch."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import kernels

    rank, dev = hvd.rank(), hvd.device()
    backend = hvd.runtime.get_runtime().backend
    rng = np.random.default_rng(0)

    def dyadic(*shape):
        return torch.from_numpy((rng.integers(-8, 9, (n,) + shape) / 4).astype(np.float32))

    xs = {torch.float32: dyadic(64, 8), torch.bfloat16: dyadic(64, 8).to(torch.bfloat16),
          torch.int32: torch.from_numpy(rng.integers(-50, 51, (n, 64, 8)).astype(np.int32))}
    y = dyadic(40)
    w, wg = dyadic(64, 8), dyadic(64 * n, 8)
    ragged = [dyadic(r + 1, 3)[0] for r in range(n)]
    splits = rng.integers(0, 5, (n, n))
    sent = [dyadic(int(splits[r].sum()), 3)[0] for r in range(n)]

    def mine(t):
        return t[rank].to(dev, copy=True)

    def check(what, got, want):
        got, want = got.detach().cpu(), want.cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"rank {rank}: eager {what}: {got.dtype} {tuple(got.shape)}, "
                               f"want {want.dtype} {tuple(want.shape)}")
        if want.is_floating_point():
            got, want = bits(got), bits(want)
        if not torch.equal(got, want):
            raise RuntimeError(f"rank {rank}: eager {what} differs from the expected values")

    def f32(v):
        return float(np.float32(v))

    def total(x):
        return x.double().sum(0).to(x.dtype)

    def average(x, post=1.0):
        return (total(x).float() * f32(post / n)).to(x.dtype)

    times = {}

    def group(name, fn):
        calls = []

        def call(f, *args, **kwargs):
            out = f(*args, **kwargs)
            if torch.is_tensor(out) and out.is_cuda:
                torch.cuda.synchronize()
            calls.append(1)
            return out

        t0 = time.perf_counter()
        fn(call)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3 / max(1, len(calls))

    def allreduce(call):
        for dt, x in xs.items():
            want = {hvd.Sum: total(x), hvd.Average: average(x), hvd.Min: x.amin(0),
                    hvd.Max: x.amax(0), hvd.Product: x.double().prod(0).to(dt)}
            for op, expect in want.items():
                check(f"allreduce op {op} {dt}", call(hvd.allreduce, mine(x), op=op), expect)
            z = mine(x)
            check(f"allreduce_ {dt}", call(hvd.allreduce_, z, op=hvd.Max), want[hvd.Max])
            check(f"allreduce_ in place {dt}", z, want[hvd.Max])

    def scaled(call):
        x = xs[torch.bfloat16]
        half = (x.float() * 0.5).to(torch.bfloat16)
        kernels.scale_cast.launches = 0
        got = call(hvd.allreduce, mine(x), op=hvd.Average, prescale_factor=0.5,
                   postscale_factor=3.0)
        if dev.type == "cuda" and kernels.scale_cast.launches != 2:
            raise RuntimeError(f"rank {rank}: a bf16 allreduce with a pre- and a postscale "
                               f"launched B1 {kernels.scale_cast.launches} times, not 2")
        check("allreduce bf16 pre/postscale", got, average(half, 3.0))
        for scale, dt in ((0.5, torch.bfloat16), (f32(3.0 / n), torch.bfloat16),
                          (1.0 / 3.0, torch.float32)):
            check(f"B1 against its plain version, scale {scale}",
                  kernels.scale_cast(mine(x), scale, dt),
                  kernels.scale_cast_reference(x[rank], scale, dt))

    def grouped(call):
        tensors = [xs[torch.float32], xs[torch.bfloat16], xs[torch.int32], y]
        for fuse in ("0", "1"):
            os.environ["HVD_TPU_DISABLE_GROUP_FUSION"] = fuse
            try:
                outs = call(hvd.grouped_allreduce, [mine(t) for t in tensors])
            finally:
                os.environ.pop("HVD_TPU_DISABLE_GROUP_FUSION")
            for t, got in zip(tensors, outs):
                check(f"grouped allreduce (unfused {fuse}) {t.dtype}", got, average(t))

    def gathers(call):
        for dt, x in xs.items():
            check(f"allgather {dt}", call(hvd.allgather, mine(x)), x.reshape(-1, 8))
            check(f"broadcast {dt}", call(hvd.broadcast, mine(x), n - 1), x[n - 1])
            z = mine(x)
            call(hvd.broadcast_, z, n - 1)
            check(f"broadcast_ {dt}", z, x[n - 1])
        check("allgather_v", call(hvd.allgather_v, ragged[rank].to(dev, copy=True)), torch.cat(ragged))

    def reducescatter(call):
        c = 64 // n
        for dt, x in xs.items():
            check(f"reducescatter Sum {dt}", call(hvd.reducescatter, mine(x)),
                  total(x)[rank * c:(rank + 1) * c])
            check(f"reducescatter Average {dt}",
                  call(hvd.reducescatter, mine(x), op=hvd.Average),
                  average(x)[rank * c:(rank + 1) * c])

    def alltoall(call):
        c = 64 // n
        for dt, x in xs.items():
            check(f"alltoall {dt}", call(hvd.alltoall, mine(x)),
                  torch.cat([x[j, rank * c:(rank + 1) * c] for j in range(n)]))
        out, recv = call(hvd.alltoall, sent[rank].to(dev, copy=True), splits=splits[rank].tolist())
        offs = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(splits, 1)], 1)
        check("uneven alltoall", out,
              torch.cat([sent[j][offs[j, rank]:offs[j, rank + 1]] for j in range(n)]))
        check("uneven alltoall's received splits", recv, torch.from_numpy(splits[:, rank]))

    def barrier(call):
        call(hvd.barrier)

    def handles(call):
        x = xs[torch.float32]
        h = call(hvd.allreduce_async, mine(x), op=hvd.Sum)
        while not hvd.poll(h):
            time.sleep(1e-4)
        check("allreduce_async", hvd.synchronize(h), total(x))

    def grads(call):
        x = mine(xs[torch.float32]).requires_grad_()
        (call(hvd.allreduce, x, op=hvd.Sum) * mine(w)).sum().backward()
        check("allreduce's gradient", x.grad, total(w))
        x.grad = None
        (call(hvd.allgather, x) * mine(wg)).sum().backward()
        check("allgather's gradient", x.grad, average(wg)[rank * 64:(rank + 1) * 64])

    hvd.allreduce(torch.zeros(1, device=dev))  # untimed: makes the communicators
    for name, fn in (("allreduce", allreduce), ("bf16 pre/postscale", scaled),
                     ("grouped", grouped), ("allgather, allgather_v, broadcast", gathers),
                     ("reducescatter", reducescatter), ("alltoall", alltoall),
                     ("barrier", barrier), ("async", handles), ("gradients", grads)):
        group(name, fn)
    if rank == 0:
        time.sleep(0.2)
    last = hvd.join()
    if last != 0:
        raise RuntimeError(f"rank {rank}: join returned {last}; rank 0 joined last")
    record = {"backend": backend, "world": n, "host_ms": times, "captured": None}
    if backend == "nccl":
        record["captured"] = eager_capture(xs[torch.bfloat16], average)
    return record


def eager_capture(x, average) -> dict:
    """A bf16 ``allreduce_`` with a pre- and a postscale of a static
    tensor captured into a CUDA graph, then replayed three times on
    fresh values (``x`` scaled by 1, 2, 4, rank r's row), each bitwise
    with the eager op; ``poll`` must refuse under capture.  Returns B1's
    launches per replay (inferred from the capture's)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import kernels

    rank, dev = hvd.rank(), hvd.device()
    static = x[rank].to(dev)
    kw = {"op": hvd.Average, "prescale_factor": 0.5, "postscale_factor": 3.0}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hvd.allreduce_(static.clone(), **kw)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernels.scale_cast.launches
    with torch.cuda.graph(graph):
        hvd.allreduce_(static, **kw)
    launches = kernels.scale_cast.launches - before
    if launches != 2:
        raise RuntimeError(f"rank {rank}: the captured allreduce_ recorded {launches} B1 "
                           "launches, not 2")
    handle = hvd.allreduce_async(static.clone())
    hvd.synchronize(handle)
    refused = None
    probe = torch.cuda.CUDAGraph()
    with torch.cuda.graph(probe):
        try:
            hvd.poll(handle)
        except RuntimeError as e:
            refused = str(e)
        torch.zeros(1, device=dev).add_(1)  # a graph with one node
    probe.reset()
    if refused is None:
        raise RuntimeError(f"rank {rank}: poll ran under capture")
    for k in range(3):
        fresh = x * (2 ** k)
        static.copy_(fresh[rank])
        graph.replay()
        eager = hvd.allreduce(fresh[rank].to(dev), **kw)
        torch.cuda.synchronize()
        half = (fresh.float() * 0.5).to(torch.bfloat16)
        want = average(half, 3.0)
        for what, got in (("replay", static), ("eager", eager)):
            if not torch.equal(bits(got.cpu()), bits(want)):
                raise RuntimeError(f"rank {rank}: captured allreduce_ ({what} {k}) differs "
                                   "from the expected values")
    graph.reset()
    return {"b1_launches_in_graph": launches, "replays": 3, "poll_refused": refused}


def ring_worker(args) -> None:
    """One rank of the ring slice (phase 7), started by ``ring_slice_phase``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import resnet as tresnet
    from horovod_tpu_torch.ops import kernels, peer
    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.ops import quantized as tq
    from horovod_tpu_torch.ops import ring_kernels as rk
    from horovod_tpu_torch.utils.benchmarks import build_dp_step, timed_throughput

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["HVD_TPU_SCHED_WIRE"] = "int8"
    os.environ["HVD_TPU_FUSION_THRESHOLD"] = str(RING_THRESHOLD)
    os.environ["HVD_TPU_ONESTEP"] = "off"  # each phase's own mode, eager unless set
    rank, n = args.ring_rank, args.ring_size
    hvd.init("cuda", init_method=f"file://{args.ring_store}", rank=rank, size=n,
             backend=args.ring_backend)
    eager = eager_checks(n)  # raises at the first mismatch
    counters = {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
                "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
                "rs_ring": rk.rs_ring, "ag_ring": rk.ag_ring}
    try:
        dev = hvd.device()
        g = torch.Generator(device=dev).manual_seed(100 + rank)
        batch = (torch.rand(32, 224, 224, 3, generator=g, device=dev),
                 torch.randint(0, 1000, (32,), generator=g, device=dev))

        def run(backend, warmup, timed):
            os.environ["HVD_TPU_QUANT_BACKEND"] = backend
            model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                                     device=dev)
            step, opt = build_dp_step(hvd, model)
            for c in counters.values():
                c.launches = 0
            metrics.reset("quant.")
            seconds, losses = timed_throughput(step, batch, iters=timed, warmup=warmup)
            launches = {k: c.launches for k, c in counters.items()}
            return (model, opt, seconds, losses, launches,
                    metrics.get_counter("quant.fused_fallback"))

        _, _, _, phase_losses, _, _ = run("phase", 1, 0)
        torch.cuda.empty_cache()
        model, opt, seconds, losses, launches, fallback = run("fused", WARMUP, TIMED)
        digests = [None] * n
        dist.all_gather_object(digests, state_digest(model))
        buckets = [b.nbytes // 4 for b in opt.schedule.buckets]
        del model, opt
        torch.cuda.empty_cache()

        # Each bucket's exchange launched from the backward and after it,
        # in turns, on the int8 ring and on bf16 over NCCL (across cards
        # only: on one shared card the ranks take turns on it).
        overlap = {}
        if args.ring_backend == "nccl":
            for what in ("int8", "bf16"):
                os.environ["HVD_TPU_SCHED_WIRE"] = what
                os.environ["HVD_TPU_QUANT_BACKEND"] = "fused"
                runs = []
                for barriers in (True, False, False, True):
                    metrics.reset("quant.")
                    r = overlap_run(hvd, tresnet, build_dp_step, timed_throughput,
                                    counters, batch, barriers, OVERLAP_TIMED,
                                    profile=True)
                    r["fallback"] = metrics.get_counter("quant.fused_fallback")
                    r["digests"] = [None] * n
                    dist.all_gather_object(r["digests"], r["digest"])
                    runs.append(r)
                overlap[what] = runs
            os.environ["HVD_TPU_SCHED_WIRE"] = "int8"

        # The step captured as one CUDA graph against the eager step, on
        # the int8 ring (B6 and B7 inside the graph) and on bf16 over
        # NCCL: every rank bitwise, exact launches, then the windows.  On
        # one shared card (gloo) the step cannot be captured, and
        # HVD_TPU_ONESTEP=on must raise rather than run it eagerly.
        onestep = {}
        if args.ring_backend == "nccl":
            for what in ("int8", "bf16"):
                os.environ["HVD_TPU_SCHED_WIRE"] = what
                os.environ["HVD_TPU_QUANT_BACKEND"] = "fused"
                runs = []
                for mode in ("off", "on"):
                    metrics.reset("quant.")
                    r = onestep_run(hvd, tresnet, build_dp_step, timed_throughput,
                                    counters, batch, mode)
                    r["fallback"] = metrics.get_counter("quant.fused_fallback")
                    r["digests"] = [None] * n
                    dist.all_gather_object(r["digests"], r["digest"])
                    runs.append(r)
                windows = onestep_windows(hvd, tresnet, build_dp_step, batch,
                                          [f"{what}/{m}" for m in ONESTEP_WINDOWS[:4]],
                                          32 * n)
                onestep[what] = {"runs": runs, "windows": windows}
            os.environ["HVD_TPU_SCHED_WIRE"] = "int8"
        else:
            from horovod_tpu_torch.exceptions import HorovodTpuError

            os.environ["HVD_TPU_ONESTEP"] = "on"
            model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                                     device=dev)
            step, _ = build_dp_step(hvd, model)
            try:
                step(batch)
            except HorovodTpuError as e:
                onestep["refused"] = str(e)
            else:
                raise SystemExit(f"rank {rank}: HVD_TPU_ONESTEP=on ran a gloo step")
            finally:
                os.environ["HVD_TPU_ONESTEP"] = "off"
            del model, step

        # B6 and B7 bitwise against their plain versions in this world:
        # every rank makes every rank's rows from one seed and launches its
        # own; B7 gathers the plain B6 sums, so its inputs are known too.
        # Blocks 512, 96 and 64 take the 16-byte path, 36 the 4-byte path,
        # 33 the byte path.
        window = peer.world_window(hvd.runtime.get_runtime())
        gen = torch.Generator(device="cuda").manual_seed(11)
        held = []
        for block, cols in ((BLOCK, max(buckets)), (96, 65537), (64, 65537), (36, 65537),
                            (33, 65537)):
            c = -(-cols // (n * block)) * block
            for wire in ("int8", "fp8"):
                allx = ring_input(n, n * c, block, gen)
                mine = allx[rank:rank + 1].contiguous()
                acc, deq = rk.rs_ring(mine, window, wire, block, True)
                acc_only, _ = rk.rs_ring(mine, window, wire, block, False)
                racc, rdeq = rk.rs_ring_reference(allx, wire, block, True)
                out = rk.ag_ring(racc[rank:rank + 1].contiguous(), window, wire, block)
                rout = rk.ag_ring_reference(racc, wire, block)
                torch.cuda.synchronize()
                for what, got, want in (("B6", acc[0], racc[rank]),
                                        ("B6 dequant", deq[0], rdeq[rank]),
                                        ("B6 without the dequant", acc_only[0], racc[rank]),
                                        ("B7", out[0], rout[rank])):
                    if not torch.equal(bits(got), bits(want)):
                        raise SystemExit(f"rank {rank}: {what} {wire} block {block} c {c} "
                                         "differs from the plain version")
                held.append(f"{wire} {c}x{block}")
                del allx, mine, acc, deq, acc_only, racc, rdeq, out, rout
        torch.cuda.empty_cache()

        # Each bucket's exchange (reduce-scatter with error feedback, then
        # all-gather) on the ring and on the NCCL lowering, then B6 and B7
        # alone on the largest bucket.  Across cards only: on one shared
        # card the ranks take turns on it.
        exchange = {}
        kernel_ms = {}
        if args.ring_backend == "nccl":
            token = torch.zeros(1, device=dev)

            def align():  # queued after the spin: the ranks' streams meet here
                dist.all_reduce(token)

            def agree(covered):
                flag = torch.tensor([1.0 if covered else 0.0], device=dev)
                dist.all_reduce(flag, op=dist.ReduceOp.MIN)
                return bool(flag.item())

            def timed(fn, iters, required=True):
                fn()
                torch.cuda.synchronize()
                dist.barrier()
                return split_ms(fn, iters, before_start=align, agree=agree,
                                required=required)

            gen = torch.Generator(device=dev).manual_seed(7 + rank)
            for v in buckets:
                e = torch.randn(v, generator=gen, device=dev)
                for backend in ("fused", "phase"):
                    def exchange_once(backend=backend, e=e):
                        shard, _ = tq.quantized_reduce_scatter(e, tq.Sum, ef=True,
                                                               backend=backend)
                        tq.quantized_all_gather(shard, backend=backend)
                    exchange.setdefault(backend, []).append(
                        timed(exchange_once, 10, required=False))
            v = max(buckets)
            c = -(-v // (n * BLOCK)) * BLOCK
            window = peer.world_window(hvd.runtime.get_runtime())
            x = torch.randn(1, n * c, generator=gen, device=dev)
            shard = x[:, :c].contiguous()
            kernel_ms["rs_ring"] = timed(lambda: rk.rs_ring(x, window, "int8", BLOCK, True), 20)
            kernel_ms["ag_ring"] = timed(lambda: rk.ag_ring(shard, window, "int8", BLOCK), 20)
            kernel_ms["chunk"] = c
            kernel_ms["rs_ring_trace"] = ring_trace(
                peer, "rs_ring", lambda: rk.rs_ring(x, window, "int8", BLOCK, True), 1)[0]
            kernel_ms["ag_ring_trace"] = ring_trace(
                peer, "ag_ring", lambda: rk.ag_ring(shard, window, "int8", BLOCK), 1)[0]
        if rank == 0:
            with open(args.ring_out, "w") as f:
                json.dump({"world": n, "backend": args.ring_backend, "buckets": buckets,
                           "losses": losses, "phase_first_loss": phase_losses[0],
                           "seconds": seconds, "launches": launches,
                           "fallback": fallback, "digests": digests, "held": held,
                           "exchange_ms": exchange, "kernel_ms": kernel_ms,
                           "overlap": overlap, "onestep": onestep, "eager": eager}, f)
        if len(set(digests)) != 1:
            raise SystemExit(f"rank {rank}: ranks hold different weights: {digests}")
    finally:
        hvd.shutdown()


def print_eager(rec, card) -> None:
    """The lines of a slice eager run (:func:`eager_checks`)."""
    where = f"world {rec['world']} ({rec['backend']})"
    print(f"phase slice eager: {where}: every op of the eager API bitwise with the "
          f"expected values on every rank; B1 launched exactly twice by a bf16 allreduce "
          f"with a pre- and a postscale, and bitwise with its plain version", flush=True)
    for name, ms in rec["host_ms"].items():
        print(f"phase slice eager: {where}: {name}: {ms:.3f} ms per call (host clock, "
              f"each call synchronized) on {card}", flush=True)
    cap = rec["captured"]
    if cap is None:
        print(f"phase slice eager: {where}: no capture (a gloo collective waits on the "
              f"host)", flush=True)
    else:
        print(f"phase slice eager: {where}: a bf16 allreduce_ with both scales captured "
              f"({cap['b1_launches_in_graph']} B1 launches in the graph) and replayed "
              f"{cap['replays']} times on fresh values, bitwise with eager; poll under "
              f"capture refused: {cap['poll_refused']}", flush=True)


def eager_phase(hvd, card, log):
    """Phase slice eager at world one on NCCL (this process): every op of
    the eager API, and a captured allreduce_ (:func:`eager_checks`)."""
    hvd.init("cuda")
    try:
        rec = eager_checks(1)
    except RuntimeError as e:
        fail(str(e))
    finally:
        hvd.shutdown()
    print_eager(rec, card)
    log["eager"] = rec


def ring_slice_phase(card, count, log):
    """Phase 7: the ResNet-50 int8 step on the fused ring in a world of
    processes; returns the run's record (rank 0's launch counts)."""
    import tempfile

    n = min(count, 4) if count >= 2 else 2
    backend = "nccl" if count >= 2 else "gloo"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ring.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--ring-size", str(n),
               "--ring-backend", backend, "--ring-store", os.path.join(tmp, "store"),
               "--ring-out", out]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--ring-rank", str(r)], env=env)
                 for r in range(n)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(rcs):
            fail(f"ring slice: ranks exited with {rcs}")
        with open(out) as f:
            rec = json.load(f)
    steps = WARMUP + TIMED
    nb = len(rec["buckets"])
    expected = {"scale_cast": nb * steps, "quant_pack": 0, "dequant_accum": 0,
                "dequant_rows": 0, "rs_ring": nb * steps, "ag_ring": nb * steps}
    if rec["launches"] != expected:
        fail(f"ring slice: launches {rec['launches']}; the schedule implies {expected} "
             f"({nb} buckets x {steps} steps)")
    if rec["fallback"] != 0:
        fail(f"ring slice: {rec['fallback']} collectives fell back from the ring")
    losses, first = rec["losses"], rec["phase_first_loss"]
    if not all(math.isfinite(v) for v in losses):
        fail(f"ring slice: non-finite losses {losses}")
    if abs(losses[0] - first) > 1e-5 * abs(first):
        fail(f"ring slice: first loss {losses[0]} != the phase run's {first}")
    rec["step_ms"] = rec["seconds"] / TIMED * 1e3
    rec["img_s"] = 32 * n * TIMED / rec["seconds"]
    layout = (f"{n} ranks on {n} cards, NCCL" if backend == "nccl"
              else f"{n} ranks sharing the one card, gloo")
    print(f"phase slice ring: ResNet-50 224x224 batch 32 per rank bf16, int8 wire with "
          f"error feedback, fused, 32 MiB buckets {rec['buckets']}; {layout}; losses "
          f"{[round(v, 5) for v in losses]} (first = phase run's {round(first, 5)}); "
          f"launches {rec['launches']} (= expected), no fallback; weights bitwise equal "
          f"on every rank; step {rec['step_ms']:.2f} ms, {rec['img_s']:.1f} img/s "
          f"(world) on {card}; {wall:.0f} s with start-up", flush=True)
    print(f"phase slice ring: B6 (with and without the dequant) and B7 bitwise with their plain "
          f"versions on every rank at world {n}: {rec['held']}", flush=True)
    print_eager(rec["eager"], card)
    if rec["exchange_ms"]:
        c = rec["kernel_ms"]["chunk"]
        packed = c // BLOCK * (BLOCK + 4)
        out_bytes = (n - 1) * packed
        for name in ("rs_ring", "ag_ring"):
            print(f"phase slice ring: {name} timeline at world {n}, rank 0 (us from its "
                  f"first block's start, median / largest over the blocks): "
                  f"{rec['kernel_ms'][name + '_trace']}", flush=True)
        for name, local in (("rs_ring", 4 * n * c * 2 + 4 * c + out_bytes),
                            ("ag_ring", 4 * c + 4 * n * c + out_bytes)):
            bound = max(local / H100_BYTES_PER_S, out_bytes / NVLINK_BYTES_PER_S) * 1e3
            by = "bytes" if local / H100_BYTES_PER_S >= out_bytes / NVLINK_BYTES_PER_S \
                else "NVLink bytes"
            rec["kernel_ms"][name + "_bound_ms"] = bound
            t = rec["kernel_ms"][name]
            print(f"phase slice ring: {name} at world {n}, c {c}: {fmt_split(t)} per "
                  f"launch on rank 0; bound {bound:.4f} ms by {by} ({local / 1e6:.1f} MB on "
                  f"the card, {out_bytes / 1e6:.1f} MB out over NVLink; device time "
                  f"{bound / t['ms']:.1%} of bound)", flush=True)
        for v, ring, low in zip(rec["buckets"], rec["exchange_ms"]["fused"],
                                rec["exchange_ms"]["phase"]):
            print(f"phase slice ring: bucket {v} elements: exchange on the ring "
                  f"{fmt_split(ring)}; on the NCCL lowering (B3 + all_to_all + B4, "
                  f"B3 + all_gather + B5) {fmt_split(low)}", flush=True)
        for what, runs in rec["overlap"].items():
            check_overlap(runs, what, n)
            for r in runs:
                if len(set(r["digests"])) != 1:
                    fail(f"overlap {what} world {n}: ranks hold different weights")
                if what == "int8" and r["fallback"]:
                    fail(f"overlap int8 world {n}: {r['fallback']} collectives fell back")
            print(f"phase slice ring overlap {what}: world {n}, {len(runs[0]['buckets'])} "
                  f"buckets; overlapped, after, after, overlapped: every rank's weights "
                  f"bitwise equal, and equal across the four runs; launches "
                  f"{runs[0]['launches']} (= expected) in each on {card}", flush=True)
            for r in runs:
                print(f"phase slice ring overlap {what}: {fmt_overlap(r, 32 * n)}",
                      flush=True)
                p = r["profile"]
                if p is not None:
                    print(f"phase slice ring overlap {what}: profiled step "
                          f"({'overlapped' if r['barriers'] else 'after backward'}), "
                          f"rank 0: B6 device ms per launch "
                          f"{[round(v, 4) for v in p['rs_ring_ms']]}, B7 "
                          f"{[round(v, 4) for v in p['ag_ring_ms']]}; NCCL "
                          f"{p['nccl_ms']:.3f} ms, B1/B3-B5 {p['exchange_ms']:.3f} ms, "
                          f"forward and backward {p['compute_ms']:.3f} ms "
                          f"({p['compute_kernels']} kernels)", flush=True)
        for what, rec_w in rec["onestep"].items():
            runs = rec_w["runs"]
            check_onestep(runs, what, n)
            for r in runs:
                if len(set(r["digests"])) != 1:
                    fail(f"onestep {what} world {n}: ranks hold different weights")
                if what == "int8" and r["fallback"]:
                    fail(f"onestep int8 world {n}: {r['fallback']} collectives fell back")
            print(f"phase slice ring onestep {what}: world {n}, {len(runs[0]['buckets'])} "
                  f"buckets; eager and captured: every rank's weights bitwise equal, and "
                  f"equal across the two; launches {runs[1]['launches']} (= expected; a "
                  f"replay's counts are inferred from its capture's), one capture on {card}", flush=True)
            print(f"phase slice ring onestep {what}: world {n}, rank 0: "
                  f"{fmt_windows(rec_w['windows'])} (img/s of the world) on {card}",
                  flush=True)
    else:
        print(f"phase slice ring: HVD_TPU_ONESTEP=on refused the gloo step: "
              f"{rec['onestep']['refused']}", flush=True)
        print("phase slice ring: the per-bucket exchange times and the NVLink bound "
              "need two or more cards; on one card B6 and B7 were held against their "
              "plain versions on virtual ranks (phase kernel)", flush=True)
    log["ring_slice"] = rec
    return rec


# Phase slice sets: the process sets registered in its world (ranks), the
# steps of its ResNet-50 runs, and its batch per rank.
SETS = {"s01": [0, 1], "s13": [1, 3], "s012": [0, 1, 2]}
SET_WARMUP, SET_TIMED = 2, 3
SET_BATCH = 32
SET_WINDOWS = ["set/captured", "world/captured", "world/captured", "set/captured",
               "set/eager", "world/eager", "world/eager", "set/eager"]


def set_eager_checks(n: int, sets: dict) -> dict:
    """Every eager op on each set of ``sets`` (name: registered
    ``ProcessSet``) in an initialized world of ``n`` ranks, each rank's
    result held bitwise against what it computes itself on the CPU for
    its row, member or not: the inputs of every rank come from one numpy
    generator (seed 0), dyadic or small integers.  A member gets the
    set's reduction, gather, broadcast (from the set's rank 1), shard or
    exchange; a non-member its own tensor (allreduce, grouped allreduce,
    broadcast) or zeros (allgather, reducescatter, alltoall), no rows
    from allgather_v or an uneven alltoall.  A bf16 Average with a pre-
    and a postscale launches B1 exactly twice on a member and never on a
    non-member.  Returns the host ms per call of each set's ops; raises
    at the first mismatch."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import kernels

    rank, dev = hvd.rank(), hvd.device()
    rng = np.random.default_rng(0)

    def dyadic(*shape):
        return torch.from_numpy((rng.integers(-8, 9, (n,) + shape) / 4).astype(np.float32))

    xs = {torch.float32: dyadic(12, 4), torch.bfloat16: dyadic(12, 4).to(torch.bfloat16),
          torch.int32: torch.from_numpy(rng.integers(-50, 51, (n, 12, 4)).astype(np.int32))}
    ragged = [dyadic(r + 1, 3)[0] for r in range(n)]

    def mine(t):
        return t[rank].to(dev, copy=True)

    def check(what, got, want):
        got, want = got.detach().cpu(), want.cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"rank {rank}: {what}: {got.dtype} {tuple(got.shape)}, "
                               f"want {want.dtype} {tuple(want.shape)}")
        if want.is_floating_point():
            got, want = bits(got), bits(want)
        if not torch.equal(got, want):
            raise RuntimeError(f"rank {rank}: {what} differs from the expected values")

    def f32(v):
        return float(np.float32(v))

    times = {}
    for name, ps in sets.items():
        members = list(ps.ranks)
        k, member = len(members), rank in members
        p = members.index(rank) if member else -1
        c = 12 // k
        calls = 0
        t0 = time.perf_counter()

        def call(f, *args, **kwargs):
            nonlocal calls
            out = f(*args, process_set=ps, **kwargs)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            calls += 1
            return out

        for dt, x in xs.items():
            rows = x[members]
            total = rows.double().sum(0).to(dt)
            average = (total.float() * f32(1 / k)).to(dt)
            own = x[rank]
            want = {hvd.Sum: total, hvd.Average: average, hvd.Min: rows.amin(0),
                    hvd.Max: rows.amax(0), hvd.Product: rows.double().prod(0).to(dt)}
            for op, expect in want.items():
                check(f"{name} allreduce op {op} {dt}", call(hvd.allreduce, mine(x), op=op),
                      expect if member else own)
            gather = torch.cat(list(rows))
            check(f"{name} allgather {dt}", call(hvd.allgather, mine(x)),
                  gather if member else torch.zeros_like(gather))
            check(f"{name} broadcast {dt}", call(hvd.broadcast, mine(x), 1),
                  x[members[1]] if member else own)
            shard = slice(p * c, (p + 1) * c)
            for op, expect in ((hvd.Sum, total), (hvd.Average, average)):
                check(f"{name} reducescatter {op} {dt}",
                      call(hvd.reducescatter, mine(x), op=op),
                      expect[shard] if member else torch.zeros(c, 4, dtype=dt))
            check(f"{name} alltoall {dt}", call(hvd.alltoall, mine(x)),
                  torch.cat([x[m, shard] for m in members]) if member
                  else torch.zeros_like(own))
        group = [xs[torch.float32], xs[torch.bfloat16], xs[torch.int32]]
        for fuse in ("0", "1"):
            os.environ["HVD_TPU_DISABLE_GROUP_FUSION"] = fuse
            try:
                outs = call(hvd.grouped_allreduce, [mine(t) for t in group])
            finally:
                os.environ.pop("HVD_TPU_DISABLE_GROUP_FUSION")
            for t, got in zip(group, outs):
                avg = (t[members].double().sum(0).to(t.dtype).float() * f32(1 / k)).to(t.dtype)
                check(f"{name} grouped allreduce (unfused {fuse}) {t.dtype}", got,
                      avg if member else t[rank])
        check(f"{name} allgather_v", call(hvd.allgather_v, ragged[rank].to(dev, copy=True)),
              torch.cat([ragged[m] for m in members]) if member else torch.zeros(0, 3))
        splits = rng.integers(0, 4, (k, k))
        sent = [dyadic(int(splits[m].sum()), 2)[0] for m in range(k)]
        offs = np.concatenate([np.zeros((k, 1), np.int64), np.cumsum(splits, 1)], 1)
        if member:
            out, recv = call(hvd.alltoall, sent[p].to(dev, copy=True),
                             splits=splits[p].tolist())
            check(f"{name} uneven alltoall", out, torch.cat(
                [sent[j][offs[j, p]:offs[j, p + 1]] for j in range(k)]))
            check(f"{name} uneven alltoall's received splits", recv,
                  torch.from_numpy(splits[:, p]))
        else:
            out, recv = call(hvd.alltoall, torch.zeros(0, 2, device=dev), splits=[0] * k)
            check(f"{name} uneven alltoall off the set", out, torch.zeros(0, 2))
            check(f"{name} uneven alltoall's counts off the set", recv,
                  torch.zeros(k, dtype=torch.int64))
        x = xs[torch.bfloat16]
        half = (x[members].float() * 0.5).to(torch.bfloat16)
        kernels.scale_cast.launches = 0
        # A postscale of 6: 6/k is not 1 at k = 2, 3 or 4, so B1 runs twice.
        got = call(hvd.allreduce, mine(x), op=hvd.Average, prescale_factor=0.5,
                   postscale_factor=6.0)
        want_b1 = 2 if member else 0
        if dev.type == "cuda" and kernels.scale_cast.launches != want_b1:
            raise RuntimeError(f"rank {rank}: {name}: a bf16 allreduce with a pre- and a "
                               f"postscale launched B1 {kernels.scale_cast.launches} times, "
                               f"not {want_b1}")
        check(f"{name} allreduce bf16 pre/postscale", got,
              (half.double().sum(0).to(torch.bfloat16).float() * f32(6.0 / k))
              .to(torch.bfloat16) if member else x[rank])
        h = hvd.allreduce_async(mine(xs[torch.float32]), op=hvd.Sum, process_set=ps)
        check(f"{name} allreduce_async", hvd.synchronize(h),
              xs[torch.float32][members].sum(0) if member else xs[torch.float32][rank])
        call(hvd.barrier)
        times[name] = (time.perf_counter() - t0) * 1e3 / calls
    return times


def plain_quantized_allreduce_ef(xs, rs, wire, block=BLOCK):
    """The NCCL lowering of ``quantized_allreduce_ef`` (Average) for one
    group, on the CPU through the plain versions of B3, B4 and B5
    (``ops/quant_kernels.py``): ``xs``/``rs`` are the group's members'
    flat float32 inputs and residuals in group order; returns each
    member's (result, new residual)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.ops.collectives import f32_reciprocal

    n, V = len(xs), xs[0].numel()
    c = -(-V // (n * block)) * block
    flats = [F.pad(x.float() + r.float(), (0, c * n - V)) for x, r in zip(xs, rs)]
    packed, deqs = zip(*[qk.quant_packed_reference(f.view(n, c // block, block), wire, True)
                         for f in flats])
    shards = [qk.dequant_accum_reference(torch.stack([packed[m][j] for m in range(n)]),
                                         wire).view(c) for j in range(n)]
    rows = torch.cat([qk.quant_packed_reference(s.view(1, c // block, block), wire)[0]
                      for s in shards])
    out = qk.dequant_rows_reference(rows, wire).reshape(-1)[:V] * f32_reciprocal(n)
    return [(out, (f[:V] - d.reshape(-1)[:V])) for f, d in zip(flats, deqs)]


def set_quant_checks(n: int, sets: dict) -> dict:
    """``quantized_allreduce_ef`` (Average, ``HVD_TPU_QUANT_BACKEND=fused``)
    on the tiling sets {0,1} and {1,3}, int8 and fp8, every rank in its
    tile on the card: B3 twice, B4 and B5 once, B1, B6 and B7 never, and
    ``quant.fused_fallback`` counting both collectives (groups never take
    the ring); the result and the residual bitwise with the NCCL
    lowering through the plain versions on the CPU
    (:func:`plain_quantized_allreduce_ef`); a tile's ranks bitwise
    equal.  {0,1,2} must raise ``ProcessSetTilingError``.  Returns the
    launches of each call and the error."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.exceptions import ProcessSetTilingError
    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.ops import quantized as tq
    from horovod_tpu_torch.ops import ring_kernels as rk
    from horovod_tpu_torch.process_sets import tiling_groups

    rank, dev = hvd.rank(), hvd.device()
    rng = np.random.default_rng(1)
    V = 3 * 65536 + 1000
    xs = torch.from_numpy(rng.standard_normal((n, V)).astype(np.float32))
    rs = torch.from_numpy((rng.standard_normal((n, V)) * 1e-3).astype(np.float32))
    counters = {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
                "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
                "rs_ring": rk.rs_ring, "ag_ring": rk.ag_ring}
    want = {"scale_cast": 0, "quant_pack": 2, "dequant_accum": 1, "dequant_rows": 1,
            "rs_ring": 0, "ag_ring": 0, "fallback": 2}
    # On the card the fused backend falls back for groups (counted); off
    # the card (a rehearsal) the phase backend takes the same lowering.
    os.environ["HVD_TPU_QUANT_BACKEND"] = "fused" if dev.type == "cuda" else "phase"
    rec = {}
    for name in ("s01", "s13"):
        ps = sets[name]
        tile = [t for t in tiling_groups(ps.ranks, n) if rank in t][0]
        for wire in ("int8", "fp8"):
            for ctr in counters.values():
                ctr.launches = 0
            metrics.reset("quant.")
            out, r_new = tq.quantized_allreduce_ef(xs[rank].to(dev), rs[rank].to(dev),
                                                   hvd.Average, ps, wire=wire)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items()}
            got["fallback"] = metrics.get_counter("quant.fused_fallback")
            if dev.type == "cuda" and got != want:
                raise RuntimeError(f"rank {rank}: {name} {wire}: launches {got}, expected "
                                   f"{want}")
            plain = plain_quantized_allreduce_ef([xs[m] for m in tile], [rs[m] for m in tile],
                                                 wire)[tile.index(rank)]
            for what, a, b in (("result", out, plain[0]), ("residual", r_new, plain[1])):
                if not torch.equal(bits(a.cpu()), bits(b)):
                    raise RuntimeError(f"rank {rank}: {name} {wire}: the {what} differs from "
                                       "the plain versions' NCCL lowering")
            digests = [None] * n
            dist.all_gather_object(digests, bits(out.cpu()).sum().item())
            if len({digests[m] for m in tile}) != 1:
                raise RuntimeError(f"rank {rank}: {name} {wire}: tile {tile} disagrees")
            rec[f"{name} {wire}"] = got
    try:
        tq.quantized_allreduce(xs[rank].to(dev), hvd.Average, sets["s012"])
    except ProcessSetTilingError as e:
        rec["s012"] = str(e)
    else:
        raise RuntimeError(f"rank {rank}: the quantized wire served {{0,1,2}}")
    return rec


def param_digest(model) -> str:
    """SHA-256 of the model's parameters, bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in model.parameters():
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def solo_digest(tresnet, batch, steps, dev) -> str:
    """The ResNet-50 from seed 0 after ``steps`` SGD steps (lr 0.01,
    momentum 0.9, as ``build_dp_step``) on ``batch`` alone: what a rank
    off the set must hold on a dense wire, which it leaves untouched."""
    import torch
    import torch.nn.functional as F

    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0, device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    model.train()
    for _ in range(steps):
        F.cross_entropy(model(batch[0]), batch[1]).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    digest = param_digest(model)
    del model, opt
    torch.cuda.empty_cache()
    return digest


def set_expected(wire, buckets, steps, member) -> dict:
    """Launches of ``steps`` steps of ``buckets`` buckets on the set
    {0,1}: bf16, B1 three times per bucket per step on a member (the
    casts and the 1/2 postscale) and never off the set; int8, on every
    rank (each reduces in its tile of two), B3 twice, B4, B5 and B1 (the
    postscale) once, B6 and B7 never."""
    zero = {"scale_cast": 0, "quant_pack": 0, "dequant_accum": 0,
            "dequant_rows": 0, "rs_ring": 0, "ag_ring": 0}
    m = buckets * steps
    if wire == "bf16":
        return dict(zero, scale_cast=3 * m if member else 0)
    return dict(zero, scale_cast=m, quant_pack=2 * m, dequant_accum=m, dequant_rows=m)


def sets_worker(args) -> None:
    """One rank of phase slice sets, started by ``sets_slice_phase``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import resnet as tresnet
    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.ops import ring_kernels as rk
    from horovod_tpu_torch.utils.benchmarks import build_dp_step, timed_throughput

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the solo step is compared bitwise
    os.environ["HVD_TPU_ONESTEP"] = "off"
    os.environ["HVD_TPU_QUANT_BACKEND"] = "fused"
    rank, n = args.sets_rank, args.sets_size
    registered = [hvd.ProcessSet(r) for r in SETS.values()]
    hvd.init("cuda", init_method=f"file://{args.sets_store}", rank=rank, size=n,
             backend=args.sets_backend, process_sets=registered)
    sets = dict(zip(SETS, registered))
    counters = {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
                "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
                "rs_ring": rk.rs_ring, "ag_ring": rk.ag_ring}
    try:
        eager_ms = set_eager_checks(n, sets)
        quant = set_quant_checks(n, sets)
        dev = hvd.device()
        g = torch.Generator(device=dev).manual_seed(300 + rank)
        batch = (torch.rand(args.sets_batch, 224, 224, 3, generator=g, device=dev),
                 torch.randint(0, 1000, (args.sets_batch,), generator=g, device=dev))
        ps, member = sets["s01"], rank in SETS["s01"]
        steps = SET_WARMUP + SET_TIMED
        runs = {}
        modes = ("off", "on") if args.sets_backend == "nccl" else ("off",)
        for wire in ("bf16", "int8"):
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            for mode in modes:
                os.environ["HVD_TPU_ONESTEP"] = mode
                model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                                         device=dev)
                step, opt = build_dp_step(hvd, model, process_set=ps)
                for c in counters.values():
                    c.launches = 0
                metrics.reset("quant.")
                metrics.reset("xir.")
                seconds, losses = timed_throughput(step, batch, iters=SET_TIMED,
                                                   warmup=SET_WARMUP)
                nb = len(opt.schedule.buckets)
                rec = {"losses": losses, "seconds": seconds, "buckets": nb,
                       "launches": {k: c.launches for k, c in counters.items()},
                       "fallback": metrics.get_counter("quant.fused_fallback"),
                       "captures": metrics.get_counter("xir.onestep.steps"),
                       "digest": param_digest(model)}
                if not all(math.isfinite(v) for v in losses):
                    raise SystemExit(f"rank {rank}: {wire} {mode}: losses {losses}")
                want = set_expected(wire, nb, steps, member)
                if dev.type == "cuda" and rec["launches"] != want:
                    raise SystemExit(f"rank {rank}: {wire} {mode}: launches "
                                     f"{rec['launches']}, expected {want}")
                if (dev.type == "cuda" and mode == "off" and wire == "int8"
                        and rec["fallback"] != 2 * nb * steps):
                    raise SystemExit(f"rank {rank}: int8: {rec['fallback']} fallbacks, "
                                     f"expected {2 * nb * steps}")
                if rec["captures"] != int(mode == "on"):
                    raise SystemExit(f"rank {rank}: {wire} {mode}: {rec['captures']} captures")
                rec["digests"] = [None] * n
                dist.all_gather_object(rec["digests"], rec["digest"])
                runs[f"{wire}/{mode}"] = rec
                del model, step, opt
                torch.cuda.empty_cache()
            if len({runs[f"{wire}/{m}"]["digest"] for m in modes}) != 1:
                raise SystemExit(f"rank {rank}: {wire}: the captured and eager steps differ")
            d = runs[f"{wire}/off"]["digests"]
            if d[0] != d[1]:
                raise SystemExit(f"{wire}: ranks 0 and 1 hold different weights")
            if wire == "int8" and d[2] != d[3]:
                raise SystemExit("int8: ranks 2 and 3 (one tile) hold different weights")
        os.environ["HVD_TPU_ONESTEP"] = "off"
        solo = None
        if not member:  # bf16: its own step alone, launching nothing
            solo = solo_digest(tresnet, batch, steps, dev)
            if solo != runs["bf16/off"]["digest"]:
                raise SystemExit(f"rank {rank}: bf16: off the set, the weights differ from "
                                 "its own solo step's")
        windows, recapture = {}, None
        torch.backends.cudnn.deterministic = False  # the windows time the default
        if args.sets_backend == "nccl":
            # The step on the set against the world's, in turns, then the
            # set removed under a captured step and added again.
            for wire in ("bf16", "int8"):
                os.environ["HVD_TPU_SCHED_WIRE"] = wire
                steps_by = {}
                for where in ("set", "world"):
                    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                                             seed=0, device=dev)
                    steps_by[where] = build_dp_step(
                        hvd, model, process_set=ps if where == "set" else None)[0]
                windows[wire] = set_windows(steps_by, batch, n)
                del steps_by
                torch.cuda.empty_cache()
            recapture = remove_under_capture(hvd, tresnet, build_dp_step, batch, ps)
        if rank == 0:
            with open(args.sets_out, "w") as f:
                json.dump({"world": n, "backend": args.sets_backend,
                           "batch": args.sets_batch, "eager_ms": eager_ms, "quant": quant,
                           "runs": runs, "windows": windows, "recapture": recapture}, f)
    finally:
        hvd.shutdown()


def set_windows(steps_by, batch, n) -> list:
    """``SET_WINDOWS``: ``OVERLAP_TIMED`` steps each on the set's step or
    the world's, captured or eager, in turns (a captured window's warm-up
    steps and capture run before its clock starts)."""
    from horovod_tpu_torch.utils.benchmarks import timed_window

    out = []
    for label in SET_WINDOWS:
        where, mode = label.split("/")
        wire = os.environ["HVD_TPU_SCHED_WIRE"]
        seconds, _ = timed_window(steps_by[where], batch, f"{wire}/{mode}", OVERLAP_TIMED)
        out.append({"label": label, "step_ms": seconds / OVERLAP_TIMED * 1e3,
                    "img_s": batch[0].shape[0] * n * OVERLAP_TIMED / seconds})
    os.environ["HVD_TPU_ONESTEP"] = "off"
    os.environ.pop("HVD_TPU_SCHED_BARRIERS", None)
    return out


def remove_under_capture(hvd, tresnet, build_dp_step, batch, ps) -> dict:
    """A bf16 step on ``ps`` captured (``on``), then ``remove_process_set``:
    the step's graphs are dropped; the set added again (dynamic) gets a new
    id and the next steps warm up and capture anew."""
    import torch

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP

    os.environ["HVD_TPU_SCHED_WIRE"] = "bf16"
    os.environ["HVD_TPU_ONESTEP"] = "on"
    os.environ["HVD_TPU_DYNAMIC_PROCESS_SETS"] = "1"
    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                             device=hvd.device())
    step, _ = build_dp_step(hvd, model, process_set=ps)
    metrics.reset("xir.")
    for _ in range(CAPTURE_WARMUP + 2):
        float(step(batch))
    before = (len(step._graphs), ps.process_set_id)
    hvd.remove_process_set(ps)
    dropped = len(step._graphs)
    hvd.add_process_set(ps)
    for _ in range(CAPTURE_WARMUP + 2):
        float(step(batch))
    rec = {"graphs_before": before[0], "id_before": before[1], "graphs_after_remove": dropped,
           "id_after": ps.process_set_id, "graphs_after": len(step._graphs),
           "captures": metrics.get_counter("xir.onestep.steps")}
    if (rec["graphs_before"], rec["graphs_after_remove"], rec["graphs_after"],
            rec["captures"]) != (1, 0, 1, 2) or rec["id_after"] == rec["id_before"]:
        raise SystemExit(f"rank {hvd.rank()}: remove_process_set under a captured step: {rec}")
    del model, step
    os.environ["HVD_TPU_ONESTEP"] = "off"
    torch.cuda.empty_cache()
    return rec


def sets_slice_phase(card, count, log):
    """Phase slice sets: a world of four ranks with the sets of ``SETS``:
    on one card four ranks sharing it on gloo (NCCL refuses two ranks on
    one card), on four cards one rank per card on NCCL.  Returns the
    run's record (rank 0's)."""
    import tempfile

    n = 4
    backend = "nccl" if count >= 4 else "gloo"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sets.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--sets-size", str(n),
               "--sets-backend", backend, "--sets-store", os.path.join(tmp, "store"),
               "--sets-out", out, "--sets-batch", str(SET_BATCH)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--sets-rank", str(r)], env=env)
                 for r in range(n)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(rcs):
            fail(f"slice sets: ranks exited with {rcs}")
        with open(out) as f:
            rec = json.load(f)
    print_sets(rec, card)
    print(f"phase slice sets: {wall:.0f} s with start-up", flush=True)
    log["sets_slice"] = rec
    return rec


def print_sets(rec, card) -> None:
    """The lines of a slice sets run (rank 0's record)."""
    n, backend = rec["world"], rec["backend"]
    layout = (f"{n} ranks on {n} cards, NCCL" if backend == "nccl"
              else f"{n} ranks sharing the one card, gloo")
    print(f"phase slice sets: {layout}; sets {SETS} registered at init (ids 1-3): every "
          f"eager op on each set bitwise on every rank, members and non-members; B1 "
          f"launched exactly twice by a bf16 allreduce with a pre- and a postscale on a "
          f"member, never off the set; host ms per call (each synchronized) "
          f"{ {k: round(v, 3) for k, v in rec['eager_ms'].items()} } on {card}", flush=True)
    print(f"phase slice sets: quantized_allreduce_ef (fused backend) on the tiling sets, "
          f"every rank in its tile: launches per call {rec['quant']['s01 int8']} (B6 and "
          f"B7 never: groups fall back, counted); result and residual bitwise with the "
          f"plain versions' NCCL lowering, each tile's ranks equal, int8 and fp8 on "
          f"{{0,1}} and {{1,3}}; {{0,1,2}} raised: {rec['quant']['s012']}", flush=True)
    print(f"phase slice sets: ResNet-50 224x224 batch {rec['batch']} per rank bf16 "
          f"compute, DistributedOptimizer(process_set={{0,1}}), {SET_WARMUP} warm-up + "
          f"{SET_TIMED} steps per run, each rank its own data", flush=True)
    for key, r in rec["runs"].items():
        wire, mode = key.split("/")
        step_ms = r["seconds"] / SET_TIMED * 1e3
        print(f"phase slice sets: {wire} ({'captured' if mode == 'on' else 'eager'}): "
              f"losses {[round(v, 5) for v in r['losses']]}; rank 0 launches "
              f"{r['launches']} (= expected, {r['buckets']} buckets); ranks 0 and 1 bitwise "
              f"equal{', ranks 2 and 3 (one tile) bitwise equal' if wire == 'int8' else ', ranks 2 and 3 each bitwise equal to its own solo step'}; "
              f"step {step_ms:.2f} ms, {rec['batch'] * n * 1e3 / step_ms:.1f} img/s "
              f"(world) on {card}", flush=True)
    if backend == "nccl":
        for wire in ("bf16", "int8"):
            print(f"phase slice sets: {wire} eager and captured bitwise on every rank, one "
                  "capture", flush=True)
        for wire, ws in rec["windows"].items():
            print(f"phase slice sets windows {wire}: " + "; ".join(
                f"{w['label']} {w['step_ms']:.2f} ms {w['img_s']:.1f} img/s" for w in ws)
                + f" (rank 0, {OVERLAP_TIMED} steps each) on {card}", flush=True)
        rc = rec["recapture"]
        print(f"phase slice sets: remove_process_set under a captured step: graphs "
              f"{rc['graphs_before']} -> {rc['graphs_after_remove']}; added again as id "
              f"{rc['id_after']} (was {rc['id_before']}), captured anew "
              f"({rc['captures']} captures in all)", flush=True)


def _block_steps(absflat, block=BLOCK):
    """Per element of a flat bucket, one quantization step: the block
    maximum / 127 for int8 (``tests/test_torch_train_step.py``)."""
    import torch

    pad = torch.zeros(-(-absflat.numel() // block) * block)
    pad[:absflat.numel()] = absflat
    bmax = pad.view(-1, block).amax(-1).repeat_interleave(block)[:absflat.numel()]
    return bmax / 127


def reference_phase(hvd, tresnet, build_dp_step, wire):
    """The step on the card against the CPU path (plain versions) on a
    small float32 ResNet for three steps.  cuDNN's and the CPU's float32
    convolutions differ in the last bits; BatchNorm amplifies that in
    later steps.

    bf16 wire: first loss to rtol 1e-5, later losses to rtol 1e-4,
    weights to 15% of their tensor's move + 1e-5 (a gradient element
    may round the other way in bf16).

    int8 wire: both runs quantize the same blocks, so a gradient element
    can land one quantization step S (its block's maximum / 127) apart
    in each of the two quantizations.  After the first step each weight
    agrees to 2·S + 4e-4 of its tensor's largest update + 1e-7; after
    three to 12·S + 60% of its tensor's move + 1e-5; losses after the
    first update to rtol 1e-2 (``tests/test_torch_train_step.py`` holds
    the CPU path against the JAX package to the same kind of bound)."""
    import torch

    os.environ["HVD_TPU_SCHED_WIRE"] = wire
    rng = torch.Generator().manual_seed(1)
    batches = [
        (torch.randn(4, 32, 32, 3, generator=rng),
         torch.randint(0, 10, (4,), generator=rng))
        for _ in range(3)
    ]
    runs = {}
    for dev in ("cuda", "cpu"):
        hvd.init(dev)
        try:
            model = tresnet.ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                                   dtype=torch.float32, seed=3, device=dev)
            start = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
            step, opt = build_dp_step(hvd, model)
            states, losses = [], []
            for x, y in batches:
                losses.append(float(step((x.to(dev), y.to(dev)))))
                states.append({k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()})
            names = [n for n, _ in model.named_parameters()]
            buckets = [[names[i] for i in b.indices] for b in opt.schedule.buckets]
            if not all(b.wire == wire for b in opt.schedule.buckets):
                fail(f"reference: the {dev} run did not plan {wire} on every bucket")
        finally:
            hvd.shutdown()
        runs[dev] = (losses, start, states)
    (lc, start, sc), (lp, _, sp) = runs["cuda"], runs["cpu"]
    if not all(math.isfinite(v) for v in lc):
        fail(f"reference {wire}: non-finite losses on the card {lc}")
    later = 1e-4 if wire == "bf16" else 1e-2
    if abs(lc[0] - lp[0]) > 1e-5 * abs(lp[0]) or any(
        abs(a - b) > later * abs(b) for a, b in zip(lc, lp)
    ):
        fail(f"reference {wire}: losses {lc} on the card vs {lp} on the CPU")
    steps = {}
    if wire != "bf16":
        move1 = {k: (sp[0][k] - start[k]).abs() for k in sp[0]}
        for order in buckets:  # each bucket is one flat buffer
            flat = _block_steps(torch.cat([move1[k].reshape(-1) for k in order]))
            off = 0
            for k in order:
                steps[k] = flat[off:off + move1[k].numel()].view(move1[k].shape)
                off += move1[k].numel()
    worst = 0.0
    for k in sp[-1]:
        if not sp[-1][k].is_floating_point() or k.endswith((".mean", ".var")):
            continue
        moved = float((sp[-1][k] - start[k]).abs().max())
        diff = (sc[-1][k] - sp[-1][k]).abs()
        if wire == "bf16":
            limit = 0.15 * moved + 1e-5
        else:
            s = steps[k]
            d1 = (sc[0][k] - sp[0][k]).abs()
            lim1 = 2 * s + 4e-4 * float(move1[k].max()) + 1e-7
            if bool((d1 >= lim1).any()):
                fail(f"reference {wire}: {k} after step 1 differs by "
                     f"{float(d1.max())} (limit {float(lim1.max())})")
            limit = 12 * s + 0.6 * moved + 1e-5
        if bool((diff > limit).any()):
            fail(f"reference {wire}: {k} differs by {float(diff.max())} (moved {moved})")
        worst = max(worst, float((diff / (torch.as_tensor(limit) + 1e-30)).max()))
    print(f"phase reference {wire}: small f32 ResNet, 3 steps on the card vs "
          f"the CPU path: losses {lc} vs {lp}; worst weight difference "
          f"{worst:.2e} of its limit", flush=True)
    return {"wire": wire, "losses_cuda": lc, "losses_cpu": lp,
            "worst_of_limit": worst}


def _attention_pairs(t, causal, segs):
    """(query, key) pairs the mask keeps, per (batch row, head): what
    this run's data needs of the two products."""
    import torch

    if segs is None:
        return float(t * (t + 1) // 2 if causal else t * t)
    keep = segs[:, :, None] == segs[:, None, :]
    if causal:
        keep &= torch.ones(t, t, dtype=torch.bool, device=segs.device).tril()[None]
    return float(keep.sum()) / segs.shape[0]


def flash_phase(flash, segs, log):
    """B2 against its plain version, each case on the route that serves
    it, at that route's key tile; the wgmma route's causal dense case is
    returned for the kernels line.  The mma route is also held and timed
    at the causal dense GPT shape (``flash_forward_mma``), beside the
    wgmma route and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    routes = {"wgmma": flash.flash_forward_wgmma, "mma": flash.flash_forward_mma}
    cases = [  # name, T, H, D, dtype, causal, segments, route (None: flash_forward's)
        ("causal dense", GPT_SEQ, 12, 64, bf16, True, None, None),
        ("causal dense, mma route", GPT_SEQ, 12, 64, bf16, True, None, "mma"),
        ("causal packed", GPT_SEQ, 12, 64, bf16, True, segs, None),
        ("non-causal", GPT_SEQ, 12, 64, bf16, False, None, None),
        ("ragged T=1000", 1000, 12, 64, bf16, True, None, None),
        ("D=128", GPT_SEQ, 6, 128, bf16, True, None, None),
        ("float32 gpt_tiny heads", 256, 4, 16, f32, True, None, None),
        ("bf16 D=32", GPT_SEQ, 12, 32, bf16, True, None, None),
    ]
    before = flash.flash_forward.launches
    record = None
    times = {}
    for name, t, h, d, dtype, causal, seg, which in cases:
        b = GPT_BATCH
        which = which or flash.route(dtype, d)
        fn = routes[which]
        # q, k, v as the model passes them: strided views of one qkv.
        qkv = torch.randn(b, t, 3, h, d, generator=g, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        scale = d ** -0.5
        out, lse = fn(q, k, v, causal, scale, seg)
        want_o, want_l = flash.flash_forward_reference(
            q, k, v, causal, scale, seg, block_k=flash.KERNEL_BLOCK[which])
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        rtol, atol, lse_tol = FLASH_TOL[dname]
        err_o = (out.float() - want_o.float()).abs()
        err_l = float((lse - want_l).abs().max())
        if not bool(torch.isfinite(out).all()) or bool(
                (err_o > atol + rtol * want_o.float().abs()).any()) or err_l > lse_tol:
            fail(f"B2 {name} ({which}): out error {float(err_o.max())} (rtol {rtol}, "
                 f"atol {atol}), lse error {err_l} (atol {lse_tol})")
        ft = split_ms(lambda: fn(q, k, v, causal, scale, seg))
        pt = split_ms(lambda: flash.flash_forward_reference(
            q, k, v, causal, scale, seg), iters=5)
        ms, plain_ms = ft["ms"], pt["ms"]
        lib_ms, lt = None, None
        if name == "causal dense":
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lt = split_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            lib_ms = lt["ms"]
            del qt, kt, vt
        esize = q.element_size()
        nbytes = 4 * b * t * h * d * esize + 4 * b * h * t
        if seg is not None:
            nbytes += 4 * b * t
        flops = 4.0 * d * h * b * _attention_pairs(t, causal, seg)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FLOPS[dname] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        rec = {"kernel": "flash_fwd", "route": which, "case": name,
               "shape": [b, t, h, d], "dtype": dname, "ms": ms,
               "paced_ms": ft["paced_ms"], "host_ms": ft["host_ms"], "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes, "flops": flops, "max_abs_err": float(err_o.max()),
               "lse_err": err_l}
        log["kernel_cases"].append(rec)
        times[name] = ms
        lib_txt = (f"{fmt_split(lt)} ({bound_ms / lib_ms:.1%} of bound)"
                   if lt is not None else "none")
        print(f"phase kernel: B2 {name} [{b},{t},{h},{d}] {dname}, {which} route: out "
              f"error {float(err_o.max()):.3g}, lse error {err_l:.3g} (within FLASH_TOL); "
              f"kernel {fmt_split(ft)} ({bound_ms / ms:.1%} of bound); plain "
              f"{fmt_split(pt)}; library {lib_txt}; bound {bound_ms:.4f} ms by "
              f"{bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)", flush=True)
        if name == "causal dense":
            record = rec
        del qkv, q, k, v, out, lse, want_o, want_l, err_o
    speedup = times["causal dense, mma route"] / times["causal dense"]
    print(f"phase kernel: B2 at the causal dense GPT shape: wgmma route "
          f"{times['causal dense']:.4f} ms, mma route "
          f"{times['causal dense, mma route']:.4f} ms ({speedup:.2f}x), "
          f"scaled_dot_product_attention {record['library_ms']:.4f} ms "
          f"({record['library_ms'] / times['causal dense']:.2f}x the wgmma route's "
          f"speed)", flush=True)
    record["mma_route_ms"] = times["causal dense, mma route"]
    print(f"phase kernel: {flash.flash_forward.launches - before} B2 launches for "
          "comparison and timing (not counted for the main path)", flush=True)
    return record


def gpt_phase(hvd, tt, build_lm_step, timed_throughput, counters, batch,
              packed, warmup, timed, card):
    """One run of the GPT slice on GPT-2 small: losses, timings and the
    launch count of every kernel."""
    import torch

    os.environ["HVD_TPU_SCHED_WIRE"] = "off"  # bench_gpt: Compression.bf16 only
    hvd.init("cuda")
    try:
        model = tt.gpt_small(seed=0, device="cuda")
        step, _ = build_lm_step(hvd, model, packed=packed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        seconds, losses = timed_throughput(step, batch, iters=timed, warmup=warmup)
        launches = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        digest = param_digest(model)
        del model, step
    finally:
        hvd.shutdown()
    what = "packed" if packed else "dense"
    steps = warmup + timed
    if not all(math.isfinite(v) for v in losses):
        fail(f"gpt {what}: non-finite losses {losses}")
    if not packed and abs(losses[0] - math.log(GPT_VOCAB)) > 1.0:
        fail(f"gpt dense: first loss {losses[0]} is not near ln({GPT_VOCAB})")
    on_path = ("flash_fwd", "flash_fwd_wgmma")  # every B2 launch on the wgmma route
    expected = {k: (GPT_LAYERS * steps if k in on_path else 0) for k in counters}
    if launches != expected:
        fail(f"gpt {what}: launches {launches}, expected {expected}")
    step_ms = seconds / timed * 1e3
    tok_s = GPT_BATCH * GPT_SEQ * timed / seconds
    print(f"phase slice gpt {what}: GPT-2 small, batch {GPT_BATCH} x {GPT_SEQ}, bf16, "
          f"AdamW, Compression.bf16; losses {[round(v, 5) for v in losses]}; "
          f"launches {launches} (= expected); step {step_ms:.2f} ms, "
          f"{tok_s:.0f} tokens/s, peak {peak_gib:.2f} GiB on {card}", flush=True)
    return {"packed": packed, "losses": losses, "step_ms": step_ms,
            "tokens_s": tok_s, "peak_gib": peak_gib, "launches": launches,
            "digest": digest}


def reference_gpt_phase(hvd, tt, build_lm_step):
    """Three steps of a small bf16 GPT on the card against the CPU path
    (B2 and the chunked backward against their plain versions, cuBLAS
    against the CPU's bf16 matmuls).  bf16 activations round at
    different places on the two devices, so the first loss agrees to
    rtol 2e-3 and the later ones to 1e-2.  Each of Adam's first three
    updates is at most 1.004·lr (3e-4) in size whatever the gradients
    (Cauchy-Schwarz over the moments' weights at betas 0.9 / 0.999), so
    two runs whose gradients differ in sign can be ``ADAM_APART`` apart
    after three steps, weight decay included; the check that the two
    runs computed the same gradients is that, per tensor, the mean
    difference is at most 25% of the mean move (elements whose gradient
    is larger than the devices' rounding take the same Adam steps).  The
    key columns of the qkv bias are left out of that mean: their exact
    gradient is 0 (a constant added to every key of a query's row leaves
    its softmax unchanged), so each device steps them by its own
    rounding noise."""
    import torch

    os.environ["HVD_TPU_SCHED_WIRE"] = "off"
    cfg = tt.TransformerConfig(vocab_size=512, num_layers=2, model_dim=128,
                               num_heads=2, head_dim=64, ff_dim=512, max_len=256)
    rng = torch.Generator().manual_seed(4)
    batches = [torch.randint(0, 512, (4, 256), generator=rng) for _ in range(3)]
    runs = {}
    for dev in ("cuda", "cpu"):
        hvd.init(dev)
        try:
            model = tt.Transformer(cfg, seed=5, device=dev)
            start = {n: p.detach().float().cpu().clone()
                     for n, p in model.named_parameters()}
            step, _ = build_lm_step(hvd, model, packed=False)
            losses = [float(step(x.to(dev))) for x in batches]
            after = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
        finally:
            hvd.shutdown()
        runs[dev] = (losses, after)
    (lc, wc), (lp, wp) = runs["cuda"], runs["cpu"]
    if not all(math.isfinite(v) for v in lc):
        fail(f"reference gpt: non-finite losses on the card {lc}")
    if abs(lc[0] - lp[0]) > 2e-3 * abs(lp[0]) or any(
            abs(a - b) > 1e-2 * abs(b) for a, b in zip(lc, lp)):
        fail(f"reference gpt: losses {lc} on the card vs {lp} on the CPU")
    worst_abs, worst_ratio = 0.0, 0.0
    for n in wp:
        diff = (wc[n] - wp[n]).abs()
        move = (wp[n] - start[n]).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        if n.endswith("qkv.Dense_0.bias"):  # [3, H, D]: drop the key third
            diff, move = diff.view(3, -1)[[0, 2]], move.view(3, -1)[[0, 2]]
        ratio = float(diff.mean() / move.mean())
        worst_ratio = max(worst_ratio, ratio)
        if worst_abs > ADAM_APART or ratio > 0.25:
            fail(f"reference gpt: {n} differs by up to {worst_abs} (mean "
                 f"{ratio:.3f} of its mean move)")
    print(f"phase reference gpt: small bf16 GPT, 3 steps on the card vs the CPU "
          f"path: losses {lc} vs {lp}; worst weight difference {worst_abs:.3g} "
          f"(bound {ADAM_APART:.2e}), worst mean difference {worst_ratio:.3f} of "
          f"the mean move (bound 0.25)", flush=True)
    return {"losses_cuda": lc, "losses_cpu": lp, "worst_abs": worst_abs,
            "worst_mean_ratio": worst_ratio}


def examples_phase(root, card):
    """Phase examples: the ported MNIST example and the synthetic
    benchmark, each a short run on the card as a user starts them."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK") and not k.startswith("HVD_TPU_")}
    env["HVD_TPU_ONESTEP"] = "off"
    out = {}
    for script, args, want in (
            ("torch_port_mnist.py", ["--epochs", "1", "--num-samples", "4096"],
             "final loss"),
            ("torch_synthetic_benchmark.py", ["--num-iters", "1", "--num-warmup-batches",
                                              "2", "--num-batches-per-iter", "5"],
             "Total img/sec"),
            ("torch_fsdp_gpt.py", ["--steps", "3"], "gathered eval logits")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(root, "examples", script)] + args,
                              cwd=root, env=env, capture_output=True, text=True,
                              timeout=300)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not any(want in line for line in lines):
            fail(f"examples/{script} exited with {proc.returncode}: "
                 f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        print(f"phase examples: examples/{script} {' '.join(args)}: "
              f"{' | '.join(lines[-2:])} ({time.perf_counter() - t0:.0f} s with start-up; "
              f"{card})", flush=True)
        out[script] = lines
    return out


def gpt_onestep_phase(hvd, tt, build_lm_step, counters, batch, packed, steps, eager, card):
    """The GPT slice's step captured as one CUDA graph (``HVD_TPU_ONESTEP=on``)
    for as many steps, from the same weights and batch, as the eager run
    ``eager`` (``gpt_phase``, AdamW ``capturable=True`` in both): losses and
    weights bitwise equal, one capture, B2 counted 12 times per step on the
    replays; then ``GPT_WINDOWS`` windows of ``GPT_WINDOW_STEPS`` steps,
    captured and eager in turns, on one step."""
    import torch

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.utils.benchmarks import timed_window

    what = "packed" if packed else "dense"
    os.environ["HVD_TPU_SCHED_WIRE"] = "off"
    os.environ["HVD_TPU_ONESTEP"] = "on"
    hvd.init("cuda")
    try:
        model = tt.gpt_small(seed=0, device="cuda")
        step, _ = build_lm_step(hvd, model, packed=packed)
        for c in counters.values():
            c.launches = 0
        metrics.reset("xir.")
        losses = [float(step(batch)) for _ in range(steps)]
        launches = {k: c.launches for k, c in counters.items()}
        captures = metrics.get_counter("xir.onestep.steps")
        digest = param_digest(model)
        del model, step
        torch.cuda.empty_cache()
        model = tt.gpt_small(seed=0, device="cuda")
        step, _ = build_lm_step(hvd, model, packed=packed)
        windows = []
        for label in GPT_WINDOWS:
            seconds, _ = timed_window(step, batch, f"off/{label}", GPT_WINDOW_STEPS)
            ms = seconds / GPT_WINDOW_STEPS * 1e3
            rows = batch[0].shape[0] if packed else batch.shape[0]
            windows.append({"label": label, "step_ms": ms,
                            "tokens_s": rows * GPT_SEQ / ms * 1e3})
        del model, step
    finally:
        os.environ["HVD_TPU_ONESTEP"] = "off"
        hvd.shutdown()
        torch.cuda.empty_cache()
    if losses != eager["losses"] or digest != eager["digest"]:
        fail(f"gpt {what}: captured losses {losses} != eager {eager['losses']}, or the "
             "weights differ")
    on_path = ("flash_fwd", "flash_fwd_wgmma")
    expected = {k: (GPT_LAYERS * steps if k in on_path else 0) for k in counters}
    if launches != expected or captures != 1:
        fail(f"gpt {what} captured: launches {launches} (expected {expected}), "
             f"{captures} captures")
    print(f"phase slice gpt {what} captured: {steps} steps bitwise with eager (losses and "
          f"weights; AdamW capturable=True), 1 capture, launches {launches} (= expected, "
          f"replays counted); {fmt_gpt_windows(windows)} on {card}", flush=True)
    return {"losses": losses, "launches": launches, "windows": windows}


def fmt_gpt_windows(windows) -> str:
    return "; ".join(f"{w['label']} {w['step_ms']:.2f} ms {w['tokens_s']:.0f} tok/s"
                     for w in windows)


def hybrid_data(steps, rows, seq, vocab):
    """Every rank's copy of the hybrid slice's tokens: ``[steps, rows,
    seq + 1]`` from seed 5, the targets being the next tokens."""
    import torch

    g = torch.Generator().manual_seed(5)
    return torch.randint(0, vocab, (steps, rows, seq + 1), generator=g)


def hybrid_digests(model, mesh, tt) -> dict:
    """Per parameter, (its tp shard's coordinate or None, its digest)."""
    import hashlib

    import torch

    axes = tt.param_shard_axes(dict(model.named_parameters()), model.cfg)
    out = {}
    for name, p in model.named_parameters():
        h = hashlib.sha256(p.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
        shard = mesh.axis_index("tp") if axes[name] and mesh.axis_size("tp") > 1 else None
        out[name] = (shard, h.hexdigest())
    return out


def plain_quantized_exchange(xs, wire, block=BLOCK):
    """The NCCL lowering of ``sched/execute.py`` ``quantized_exchange_flat``
    (an average, no residual) for one group, on the CPU through the
    plain versions of B3, B1, B4 and B5: ``xs`` are the group's members'
    flat float32 buckets in group order; returns the result, the same on
    every member."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.ops import quant_kernels as qk

    n, V = len(xs), xs[0].numel()
    c = -(-V // (n * block)) * block
    packed = [qk.quant_packed_reference(F.pad(x.float(), (0, c * n - V)).view(
        n, c // block, block), wire)[0] for x in xs]
    shards = [kernels.scale_cast_reference(qk.dequant_accum_reference(
        torch.stack([packed[m][j] for m in range(n)]), wire).view(c), 1.0 / n)
        for j in range(n)]
    rows = torch.cat([qk.quant_packed_reference(s.view(1, c // block, block), wire)[0]
                      for s in shards])
    return qk.dequant_rows_reference(rows, wire).reshape(-1)[:V]


def hybrid_checks(model, full, mesh, toks, rows, cols, counters, int8) -> dict:
    """Phase slice hybrid's checks of one mesh, on every rank, before its
    steps: ``toks`` (``[rows over every dp rank, seq + 1]``, the first
    batch) through the unsharded model ``full`` (the same seed) gives
    the reference gradients; this rank's block through ``model`` (made
    on ``mesh``) gives its raw gradients.  Both models compute in
    float32 (``HYBRID_GRAD_RTOL``).  Then (1) bucket 0 of each of
    ``sync_gradients``' mean groups goes through the bf16 wire (B1: cast,
    mean on the mesh's group, cast back) and, with ``int8``, the
    single-axis groups' bucket 0 through the quantized exchange on the
    mesh's groups (B3, B4, B1, B3, B5), each bitwise with its plain
    version on the same inputs and groups and with exact launch counts
    on a card; (2) ``sync_gradients`` (the step's own call, on the bf16
    wire) is held against the unsharded gradients' shards within
    ``HYBRID_GRAD_RTOL``.  Returns the worst gradient error over the
    ranks and the wire checks."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.ops.collectives import f32_reciprocal
    from horovod_tpu_torch.parallel.grad_sync import pmean_, sync_gradients, wire_groups
    from horovod_tpu_torch.sched import execute
    from horovod_tpu_torch.sched.plan import SchedConfig, build_schedule, dtype_name

    on_card = toks.is_cuda
    logits, _ = full(toks[:, :-1])
    loss = tt.token_cross_entropy(logits, toks[:, 1:])
    del logits
    loss.backward()
    want_grads = {n: p.grad for n, p in full.named_parameters()}
    del full, loss

    params = dict(model.named_parameters())
    axes = tt.param_shard_axes(params, model.cfg)
    model.zero_grad(set_to_none=True)
    block = toks[rows]
    logits, aux = model(block[:, :-1][:, cols])
    (tt.token_cross_entropy(logits, block[:, 1:][:, cols]) + 0.01 * aux).backward()
    del logits
    raw = {n: p.grad.detach().clone() for n, p in params.items()}
    model.zero_grad(set_to_none=True)

    present = tuple(a for a in ("dp", "sp", "tp", "ep") if mesh.present(a))
    groups = {}
    for name in params:
        m = tuple(a for a in present if a not in axes[name].split())
        if m and mesh.group_size(m) > 1:
            groups.setdefault(m, []).append(name)
    wire_rec, problems = {}, []
    cfg = SchedConfig.from_env()
    for m, names in groups.items():
        n = mesh.group_size(m)
        for wire in ("bf16", "int8") if int8 and len(m) == 1 else ("bf16",):
            bucket = build_schedule([raw[x].numel() * raw[x].element_size() for x in names],
                                    [dtype_name(raw[x].dtype) for x in names], cfg,
                                    wire=wire).buckets[0]
            f = torch.cat([raw[names[j]].reshape(-1) for j in bucket.indices])
            for c in counters.values():
                c.launches = 0
            if wire == "bf16":
                got = execute.bf16_wire(lambda x, _m=m: pmean_(x, mesh, _m))(f)
                want = kernels.scale_cast_reference(f, 1.0, torch.bfloat16)
                dist.all_reduce(want, group=mesh.group(m))
                want = kernels.scale_cast_reference(
                    kernels.scale_cast_reference(want, f32_reciprocal(n)), 1.0, f.dtype)
                expected = {"scale_cast": 3}
            else:
                got, _ = execute.quantized_exchange_flat(f, average=True, wire=wire,
                                                         groups=wire_groups(mesh, m))
                members = [torch.empty_like(f) for _ in range(n)]
                dist.all_gather(members, f, group=mesh.group(m))
                want = plain_quantized_exchange([x.cpu() for x in members], wire)
                expected = {"scale_cast": 1, "quant_pack": 2, "dequant_accum": 1,
                            "dequant_rows": 1}
            launches = {k: c.launches for k, c in counters.items() if c.launches}
            label = f"{wire} over {'x'.join(m)}"
            if on_card and launches != expected:
                problems.append(f"{label}: launches {launches}, expected {expected}")
            if not torch.equal(bits(got.cpu()), bits(want.cpu())):
                problems.append(f"{label}: the kernels' result differs from the plain "
                                "versions' on the mesh's group")
            wire_rec[label] = {"elements": f.numel(), "launches": launches}

    synced = sync_gradients(raw, axes, mesh)
    tp, r = mesh.axis_size("tp"), mesh.axis_index("tp")
    worst = (0.0, "")
    for name, g in synced.items():
        want = tt.shard_of(name, want_grads[name], model.cfg, tp, r).float()
        err = float((g.float() - want).norm()) / max(float(want.norm()), 1e-30)
        if not err <= worst[0]:
            worst = (err, name)
    if not worst[0] <= HYBRID_GRAD_RTOL:
        problems.append(f"the synced gradient of {worst[1]} is {worst[0]} of its norm "
                        "away from the unsharded model's")
    every = [None] * mesh.size  # every rank fails together, none waits on another
    dist.all_gather_object(every, (worst, problems))
    if any(p for _, p in every):
        raise SystemExit(f"rank {mesh.rank}: {[p for _, p in every]}")
    worst = max(w for w, _ in every)
    return {"grad_err": worst[0], "grad_worst": worst[1], "wire": wire_rec}


def hybrid_worker(args) -> None:
    """One rank of phase slice hybrid, started by ``hybrid_slice_phase``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import flash, kernels
    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.parallel import make_mesh
    from horovod_tpu_torch.sched.plan import SchedConfig, build_schedule, dtype_name
    from horovod_tpu_torch.utils.benchmarks import build_hybrid_lm_step

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["HVD_TPU_ONESTEP"] = "off"
    rank, n = args.hybrid_rank, args.hybrid_size
    device = args.hybrid_device
    hvd.init(device, init_method=f"file://{args.hybrid_store}", rank=rank, size=n,
             backend=args.hybrid_backend)
    try:
        dev = hvd.device()
        on_card = dev.type == "cuda"
        tiny = not on_card  # a rehearsal on the CPU: gpt_tiny at 64 positions
        build = tt.gpt_tiny if tiny else tt.gpt_small
        seq = 64 if tiny else GPT_SEQ
        vocab = 256 if tiny else GPT_VOCAB
        layers = 2 if tiny else GPT_LAYERS
        steps = 1 + HYBRID_TIMED
        data = hybrid_data(steps + HYBRID_INT8, 2 * HYBRID_BATCH, seq, vocab)
        counters = {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
                    "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
                    "flash_fwd": flash.flash_forward,
                    "flash_fwd_wgmma": flash.flash_forward_wgmma}
        # The dp1 flash reference: each mesh's first global batch through
        # the unsharded model from the same seed.
        ref = {}
        if rank == 0:
            with torch.no_grad():
                model = build(seed=0, device=dev)
                for kind, (deg, _) in HYBRID_MESHES.items():
                    toks = data[0, :HYBRID_BATCH * deg.get("dp", 1)].to(dev)
                    logits, _ = model(toks[:, :-1])
                    ref[kind] = float(tt.token_cross_entropy(logits, toks[:, 1:]))
                    del logits
                del model
        kernel_checks = {}
        if on_card and rank == 0:  # B2 at the shapes the meshes give it
            g = torch.Generator(device="cuda").manual_seed(6)
            for name, h in (("tp2", 6), ("ulysses sp4", 3)):
                qkv = torch.randn(HYBRID_BATCH, seq, 3, h, 64, generator=g,
                                  device="cuda").to(torch.bfloat16)
                q, k, v = (x.contiguous() for x in qkv.unbind(2))
                out, lse = flash.flash_forward(q, k, v, True, 0.125)
                want_o, want_l = flash.flash_forward_reference(
                    q, k, v, True, 0.125, block_k=flash.KERNEL_BLOCK["wgmma"])
                rtol, atol, lse_tol = FLASH_TOL["bfloat16"]
                err_o = (out.float() - want_o.float()).abs()
                err_l = float((lse - want_l).abs().max())
                if bool((err_o > atol + rtol * want_o.float().abs()).any()) or err_l > lse_tol:
                    raise SystemExit(f"B2 at the {name} shape: out error "
                                     f"{float(err_o.max())}, lse error {err_l}")
                kernel_checks[name] = {"shape": [HYBRID_BATCH, seq, h, 64],
                                       "max_abs_err": float(err_o.max()), "lse_err": err_l}
        runs = {}
        for kind, (deg, impl) in HYBRID_MESHES.items():
            os.environ["HVD_TPU_SCHED_WIRE"] = "bf16"
            mesh = make_mesh(**deg)
            try:
                model = build(seed=0, device=dev, mesh=mesh, attn_impl=impl)
                step, _ = build_hybrid_lm_step(model, mesh)
                dp, sp = mesh.axis_size("dp"), mesh.axis_size("sp")
                b, t = HYBRID_BATCH, seq // sp
                rows = slice(mesh.axis_index("dp") * b, (mesh.axis_index("dp") + 1) * b)
                cols = slice(mesh.axis_index("sp") * t, (mesh.axis_index("sp") + 1) * t)

                def run(i):
                    toks = data[i, rows].to(dev)
                    return step(toks[:, cols], toks[:, 1:][:, cols])

                f32 = torch.float32
                check = hybrid_checks(
                    build(seed=0, device=dev, mesh=mesh, attn_impl=impl, dtype=f32),
                    build(seed=0, device=dev, dtype=f32), mesh, data[0, :b * dp].to(dev),
                    rows, cols, counters, int8=kind == "dp2_tp2")
                for c in counters.values():
                    c.launches = 0
                metrics.reset("sched.")
                losses = [float(run(0))]
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                last = None
                for i in range(1, steps):
                    last = run(i)
                losses += [float(last)]
                seconds = time.perf_counter() - t0
                launches = {k: c.launches for k, c in counters.items()}
                buckets = metrics.get_counter("sched.buckets")
                rec = {"losses": losses, "check": check,
                       "step_ms": seconds / HYBRID_TIMED * 1e3,
                       "tokens_s": b * dp * seq * HYBRID_TIMED / seconds,
                       "launches": launches, "buckets": buckets,
                       "b2_shape": [b, seq if impl == "ulysses" else t,
                                    12 // mesh.axis_size("tp") // (sp if impl == "ulysses"
                                                                    else 1), 64]}
                b2 = 0 if impl == "ring" else layers * steps
                want = {k: 0 for k in counters}
                if on_card:
                    want.update(flash_fwd=b2, flash_fwd_wgmma=b2,
                                scale_cast=3 * buckets)
                if launches != want:
                    raise SystemExit(f"rank {rank}: {kind}: launches {launches}, "
                                     f"expected {want}")
                if kind == "dp2_tp2":  # then int8: the tp shards' mean is over dp alone
                    os.environ["HVD_TPU_SCHED_WIRE"] = "int8"
                    axes = tt.param_shard_axes(dict(model.named_parameters()), model.cfg)
                    shards = [p for name, p in model.named_parameters() if axes[name]]
                    qb = len(build_schedule([p.numel() * 4 for p in shards],
                                            [dtype_name(p.dtype) for p in shards],
                                            SchedConfig.from_env(), wire="int8").buckets)
                    for c in counters.values():
                        c.launches = 0
                    rec["int8_losses"] = [float(run(steps + i)) for i in range(HYBRID_INT8)]
                    launches = {k: c.launches for k, c in counters.items()}
                    want = {k: 0 for k in counters}
                    if on_card:
                        want.update(flash_fwd=layers * HYBRID_INT8,
                                    flash_fwd_wgmma=layers * HYBRID_INT8,
                                    scale_cast=qb * HYBRID_INT8, quant_pack=2 * qb * HYBRID_INT8,
                                    dequant_accum=qb * HYBRID_INT8,
                                    dequant_rows=qb * HYBRID_INT8)
                    if launches != want:
                        raise SystemExit(f"rank {rank}: {kind} int8: launches {launches}, "
                                         f"expected {want}")
                    rec["int8_launches"], rec["int8_buckets"] = launches, qb
                allowed = [None] * n
                dist.all_gather_object(allowed, hybrid_digests(model, mesh, tt))
                for name, (shard, _) in allowed[0].items():
                    held = {}
                    for d in allowed:
                        held.setdefault(d[name][0], set()).add(d[name][1])
                    if any(len(v) != 1 for v in held.values()):
                        raise SystemExit(f"{kind}: {name}: replicas differ: {held}")
                if not all(math.isfinite(v) for v in losses + rec.get("int8_losses", [])):
                    raise SystemExit(f"rank {rank}: {kind}: losses {losses}")
                runs[kind] = rec
                del model, step
            finally:
                mesh.shutdown()
            if on_card:
                torch.cuda.empty_cache()
        if rank == 0:
            with open(args.hybrid_out, "w") as f:
                json.dump({"world": n, "backend": args.hybrid_backend, "ref": ref,
                           "runs": runs, "kernel_checks": kernel_checks}, f)
    finally:
        os.environ.pop("HVD_TPU_SCHED_WIRE", None)
        hvd.shutdown()


def hybrid_slice_phase(card, count, log, device="cuda"):
    """Phase slice hybrid: GPT-2 small over three meshes in a world of
    four, four ranks sharing one card on gloo or one per card on NCCL
    (four cards).  Returns rank 0's record."""
    import tempfile

    n = 4
    backend = "nccl" if count >= 4 and device == "cuda" else "gloo"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "hybrid.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--hybrid-size", str(n),
               "--hybrid-backend", backend, "--hybrid-store", os.path.join(tmp, "store"),
               "--hybrid-out", out, "--hybrid-device", device]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--hybrid-rank", str(r)], env=env)
                 for r in range(n)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(rcs):
            fail(f"slice hybrid: ranks exited with {rcs}")
        with open(out) as f:
            rec = json.load(f)
    layout = (f"{n} ranks on {n} cards, NCCL" if backend == "nccl"
              else f"{n} ranks sharing the one card, gloo" if device == "cuda"
              else f"{n} ranks on the CPU, gloo (gpt_tiny)")
    for name, c in rec["kernel_checks"].items():
        print(f"phase slice hybrid: B2 at the {name} shape {c['shape']} bf16 causal, wgmma "
              f"route: out error {c['max_abs_err']:.3g}, lse error {c['lse_err']:.3g} "
              "(within FLASH_TOL)", flush=True)
    for kind, r in rec["runs"].items():
        first, want = r["losses"][0], rec["ref"][kind]
        if abs(first - want) > HYBRID_LOSS_RTOL * abs(want):
            fail(f"slice hybrid {kind}: first loss {first} vs the dp1 flash step's {want}")
        c = r["check"]
        print(f"phase slice hybrid {kind}: gradients after sync_gradients against the "
              f"unsharded model's (float32 compute; every rank, every parameter's shard): worst "
              f"{c['grad_err']:.3g} of the norm ({c['grad_worst']}), limit "
              f"{HYBRID_GRAD_RTOL}; bucket 0 of each mean group through the kernels "
              f"bitwise with the plain versions on the mesh's groups: "
              + "; ".join(f"{k} {v['elements']} elements, launches {v['launches']}"
                          for k, v in c["wire"].items()), flush=True)
        int8 = (f"; then int8 (the tp shards' mean over dp): losses "
                f"{[round(v, 5) for v in r['int8_losses']]}, launches {r['int8_launches']} "
                f"(= {r['int8_buckets']} int8 buckets x {HYBRID_INT8} steps: B3 2, B4 1, "
                "B5 1, B1 1 each)" if "int8_losses" in r else "")
        print(f"phase slice hybrid {kind} ({HYBRID_MESHES[kind][1]}): {layout}; GPT-2 small, "
              f"batch {HYBRID_BATCH} x {GPT_SEQ} per dp rank, bf16 wire; first loss "
              f"{first:.5f} vs dp1 flash {want:.5f} (rtol {HYBRID_LOSS_RTOL}), last "
              f"{r['losses'][-1]:.5f}; replicas bitwise; launches {r['launches']} (B2 at "
              f"{r['b2_shape']}, B1 3 x {r['buckets']} bf16 bucket exchanges){int8}; step "
              f"{r['step_ms']:.1f} ms, {r['tokens_s']:.0f} tokens/s on {card}", flush=True)
    print(f"phase slice hybrid: {wall:.0f} s with start-up", flush=True)
    log["hybrid_slice"] = rec
    return rec


def gpt_world_phase(root, count, card, log):
    """``--only ring``: the GPT step at world min(count, 4), one rank per
    card on NCCL, eager and captured (``tools/torch_lm_multi.py``)."""
    n = min(count, 4)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "torch_lm_multi.py"), "--nproc",
         str(n), "--pairs", "1", "--steps", "5", "--check-steps", "4"],
        cwd=root, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        fail(f"gpt world {n}: exit {proc.returncode}: {proc.stdout[-2000:]} "
             f"{proc.stderr[-3000:]}")
    rec = json.loads(lines[-1])
    print(f"phase slice gpt world {n}: GPT-2 small, batch 16 x {GPT_SEQ} per rank, AdamW, "
          f"Compression.bf16, dense and packed: eager and captured bitwise on every rank, "
          f"launches per run {[rec['checks'][k]['launches'] for k in ('dense', 'packed')]}; "
          f"median step ms {rec['median_step_ms']}, tokens/s {rec['median_tokens_s']} on "
          f"{card} ({time.perf_counter() - t0:.0f} s with start-up)", flush=True)
    log["gpt_world"] = rec
    return rec


def lm_run(hvd, tt, build_lm_step, counters, batch, steps, onestep, **overrides):
    """``steps`` steps of ``build_lm_step`` on GPT-2 small (seed 0, world of
    one, ``HVD_TPU_SCHED_WIRE=off``), eager or captured
    (``HVD_TPU_ONESTEP=on``): every loss, each step's host-clock ms (a
    host read of the loss ends it), the kernel launches, the captures,
    peak allocated memory and the weights' digest."""
    import torch

    from horovod_tpu_torch import metrics

    os.environ["HVD_TPU_SCHED_WIRE"] = "off"
    os.environ["HVD_TPU_ONESTEP"] = "on" if onestep else "off"
    hvd.init("cuda")
    try:
        model = tt.gpt_small(seed=0, device="cuda", **overrides)
        step, _ = build_lm_step(hvd, model, packed=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        metrics.reset("xir.")
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(batch)))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: c.launches for k, c in counters.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        captures = metrics.get_counter("xir.onestep.steps")
        digest = param_digest(model)
        del model, step
    finally:
        os.environ["HVD_TPU_ONESTEP"] = "off"
        hvd.shutdown()
        torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": times, "launches": launches, "captures": captures,
            "peak_gib": peak_gib, "digest": digest}


def b2_only(counters, per_step, steps) -> dict:
    """The launches of a GPT step whose only kernel is B2 on the wgmma route."""
    return {k: (per_step * steps if k in ("flash_fwd", "flash_fwd_wgmma") else 0)
            for k in counters}


def remat_phase(hvd, tt, build_lm_step, counters, batch, card, log):
    """Phase slice gpt remat: GPT-2 small at batch 16 x 1024 with ``remat=True``
    against off, eager, in turns (on, off, off, on), then remat captured
    (``HVD_TPU_ONESTEP=on``): every run's losses and weights bitwise equal
    after ``REMAT_STEPS`` steps (the recompute runs the same kernels on the
    same inputs), B2 24 times per step with remat and 12 without; peak
    allocated memory and step ms."""
    runs = []
    for remat, onestep in ((True, False), (False, False), (False, False), (True, False),
                           (True, True)):
        r = lm_run(hvd, tt, build_lm_step, counters, batch, REMAT_STEPS, onestep, remat=remat)
        r.update(remat=remat, onestep=onestep)
        want = b2_only(counters, GPT_LAYERS * (2 if remat else 1), REMAT_STEPS)
        if r["launches"] != want:
            fail(f"gpt remat={remat} onestep={onestep}: launches {r['launches']}, "
                 f"expected {want}")
        if onestep and r["captures"] != 1:
            fail(f"gpt remat captured: {r['captures']} captures, expected 1")
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"gpt remat={remat}: losses {r['losses']}")
        runs.append(r)
    for r in runs[1:]:
        if r["losses"] != runs[0]["losses"] or r["digest"] != runs[0]["digest"]:
            fail(f"gpt remat={r['remat']} onestep={r['onestep']}: losses {r['losses']} or "
                 f"weights differ from remat eager's {runs[0]['losses']}")

    def ms(rs):
        return sorted(t for r in rs for t in r["step_ms"][1:])

    on, off = ms(runs[0:4:3]), ms(runs[1:3])
    rec = {"runs": runs, "peak_gib": {"remat": max(r["peak_gib"] for r in runs[0:4:3]),
                                      "off": max(r["peak_gib"] for r in runs[1:3])},
           "step_ms": {"remat": on[len(on) // 2], "off": off[len(off) // 2],
                       "remat_captured": runs[4]["step_ms"][-1]}}
    print(f"phase slice gpt remat: GPT-2 small, batch {GPT_BATCH} x {GPT_SEQ}, bf16, AdamW "
          f"capturable, Compression.bf16, {REMAT_STEPS} steps per run, remat on/off/off/on "
          f"eager then on captured: losses {[round(v, 5) for v in runs[0]['losses']]} and "
          f"weights bitwise equal in all five runs; launches per run remat "
          f"{runs[0]['launches']['flash_fwd']} / off {runs[1]['launches']['flash_fwd']} "
          f"(= 24 / 12 per step; the captured run counted on its replays, 1 capture); peak "
          f"{rec['peak_gib']['remat']:.2f} GiB remat vs {rec['peak_gib']['off']:.2f} GiB off; "
          f"median step {rec['step_ms']['remat']:.2f} ms remat vs {rec['step_ms']['off']:.2f} "
          f"ms off (host clock, steps 2-{REMAT_STEPS} of each eager run), captured remat "
          f"replay {rec['step_ms']['remat_captured']:.2f} ms on {card}", flush=True)
    log["gpt_remat"] = rec
    return rec


def moe_phase(hvd, tt, build_lm_step, counters, card, log):
    """Phase slice moe, world of one: GPT-2 small with an MoE FFN in every
    second block (``MOE_CFG``) at batch ``MOE_BATCH`` x 1024, eager and
    captured, ``MOE_STEPS`` steps each from seed 0: losses and weights
    bitwise equal, one capture, B2 12 times per step; step ms and peak
    memory."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(7)
    batch = torch.randint(0, GPT_VOCAB, (MOE_BATCH, GPT_SEQ), generator=g, device="cuda")
    eager = lm_run(hvd, tt, build_lm_step, counters, batch, MOE_STEPS, False, **MOE_CFG)
    captured = lm_run(hvd, tt, build_lm_step, counters, batch, MOE_STEPS, True, **MOE_CFG)
    want = b2_only(counters, GPT_LAYERS, MOE_STEPS)
    for what, r in (("eager", eager), ("captured", captured)):
        if r["launches"] != want:
            fail(f"moe {what}: launches {r['launches']}, expected {want}")
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"moe {what}: losses {r['losses']}")
    if abs(eager["losses"][0] - math.log(GPT_VOCAB)) > 1.0:
        fail(f"moe: first loss {eager['losses'][0]} is not near ln({GPT_VOCAB})")
    if captured["captures"] != 1 or captured["losses"] != eager["losses"] or (
            captured["digest"] != eager["digest"]):
        fail(f"moe captured: {captured['captures']} captures, losses {captured['losses']} "
             f"vs eager {eager['losses']}, or the weights differ")
    e_ms = sorted(eager["step_ms"][1:])
    rec = {"eager": eager, "captured": captured, "eager_step_ms": e_ms[len(e_ms) // 2],
           "captured_step_ms": captured["step_ms"][-1]}
    print(f"phase slice moe: GPT-2 small with MoE every 2nd block ({MOE_CFG['num_experts_local']} "
          f"experts of {3072 // MOE_CFG['num_experts_local']}, top-{MOE_CFG['moe_k']}, capacity "
          f"factor {MOE_CFG['moe_capacity_factor']}), world 1, batch {MOE_BATCH} x {GPT_SEQ}, "
          f"bf16, AdamW capturable, Compression.bf16: losses "
          f"{[round(v, 5) for v in eager['losses']]}; captured bitwise with eager over "
          f"{MOE_STEPS} steps (losses and weights, 1 capture); launches {eager['launches']} "
          f"(= expected, B2 12 per step); median eager step {rec['eager_step_ms']:.2f} ms, "
          f"captured replay {rec['captured_step_ms']:.2f} ms (host clock); peak "
          f"{eager['peak_gib']:.2f} GiB eager, {captured['peak_gib']:.2f} GiB captured on "
          f"{card}", flush=True)
    log["moe"] = rec
    return rec


def world_phase(kind, card, count, device="cuda", timeout=600):
    """Start ``MESH_WORLD`` ranks of this script's ``kind`` worker (four
    sharing one card on gloo, one per card on NCCL with four cards, or
    on the CPU) and return rank 0's record, its layout and the wall
    time."""
    import tempfile

    n = MESH_WORLD
    backend = "nccl" if count >= n and device == "cuda" else "gloo"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--mesh-kind", kind,
               "--mesh-size", str(n), "--mesh-backend", backend, "--mesh-store",
               os.path.join(tmp, "store"), "--mesh-out", out, "--mesh-device", device]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--mesh-rank", str(r)], env=env) for r in range(n)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(rcs):
            fail(f"slice {kind}: ranks exited with {rcs}")
        with open(out) as f:
            rec = json.load(f)
    layout = (f"{n} ranks on {n} cards, NCCL" if backend == "nccl"
              else f"{n} ranks sharing the one card, gloo" if device == "cuda"
              else f"{n} ranks on the CPU, gloo (gpt_tiny)")
    rec.update(layout=layout, wall_s=wall)
    return rec


def mesh_worker(args) -> None:
    """One rank of phase slice moe's meshes, slice pipeline or slice fsdp,
    started by ``world_phase``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["HVD_TPU_ONESTEP"] = "off"
    hvd.init(args.mesh_device, init_method=f"file://{args.mesh_store}", rank=args.mesh_rank,
             size=args.mesh_size, backend=args.mesh_backend)
    try:
        rec = {"moe": moe_mesh_worker, "pipeline": pipeline_worker,
               "fsdp": fsdp_worker, "topo": topo_worker,
               "tune": tune_worker}[args.mesh_kind](hvd)
        every = [None] * args.mesh_size  # every rank fails together, none waits on another
        dist.all_gather_object(every, rec.pop("problems", []))
        if any(every):
            raise SystemExit(f"rank {args.mesh_rank}: {every}")
        if args.mesh_rank == 0:
            rec.update(world=args.mesh_size, backend=args.mesh_backend)
            with open(args.mesh_out, "w") as f:
                json.dump(rec, f)
    finally:
        os.environ.pop("HVD_TPU_SCHED_WIRE", None)
        hvd.shutdown()


def mesh_kernels():
    from horovod_tpu_torch.ops import flash, kernels
    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.ops import ring_kernels as rk

    return {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
            "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
            "rs_ring": rk.rs_ring, "ag_ring": rk.ag_ring, "flash_fwd": flash.flash_forward,
            "flash_fwd_wgmma": flash.flash_forward_wgmma}


def rel_err(got, want) -> float:
    """Largest difference over the largest element of ``want``."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def moe_layer_check(mesh, e_loc, d, hidden, rows, seq, dev) -> dict:
    """The MoE layer over ``ep`` of ``mesh`` in float32 on this rank's own
    tokens against the layer this rank computes alone over every expert's
    weights (what the JAX ``MoELayer`` computes per rank): output, aux and
    the gradients of the input and router; of the experts, this rank's
    slice of the sum over the ep group of the lone layers' gradients (each
    expert serves every rank's tokens).  Returns each one's ``rel_err``."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import MoELayer

    n = mesh.axis_size("ep")
    e = n * e_loc
    g = torch.Generator().manual_seed(9)  # the same weights on every rank
    rk, rb = torch.randn(d, e, generator=g) * d ** -0.5, torch.randn(e, generator=g) * 0.1
    wi = torch.randn(e, d, hidden, generator=g) * d ** -0.5
    wo = torch.randn(e, hidden, d, generator=g) * hidden ** -0.5
    g = torch.Generator().manual_seed(100 + mesh.rank)  # this rank's own tokens
    x = torch.randn(rows, seq, d, generator=g).to(dev)
    w = torch.randn(rows, seq, d, generator=g).to(dev)
    r = mesh.axis_index("ep")
    out = {}
    for name, layer, mine in (
            ("ep", MoELayer(d, e_loc, hidden, mesh=mesh, dtype=torch.float32),
             slice(r * e_loc, (r + 1) * e_loc)),
            ("alone", MoELayer(d, e, hidden, dtype=torch.float32), slice(0, e))):
        layer.to(dev)
        with torch.no_grad():
            layer.router.kernel.copy_(rk)
            layer.router.bias.copy_(rb)
            layer.wi.copy_(wi[mine])
            layer.wo.copy_(wo[mine])
        xg = x.clone().requires_grad_()
        y, aux = layer(xg)
        ((y * w).sum() + aux).backward()
        out[name] = {"out": y.detach(), "aux": aux.detach(), "dx": xg.grad,
                     "drouter.kernel": layer.router.kernel.grad,
                     "drouter.bias": layer.router.bias.grad,
                     "dwi": layer.wi.grad, "dwo": layer.wo.grad}
    for key in ("dwi", "dwo"):
        total = out["alone"][key].contiguous()
        dist.all_reduce(total, group=mesh.group("ep"))
        out["alone"][key] = total[r * e_loc:(r + 1) * e_loc]
    return {k: rel_err(v, out["alone"][k]) for k, v in out["ep"].items()}


def shard_digests(model, mesh, tt) -> dict:
    """Per parameter, (its shard's coordinates or None, its digest): a
    replicated parameter must be the same on every rank, a sharded one
    on every rank with the same coordinates on its axes."""
    import hashlib

    import torch

    axes = tt.param_shard_axes(dict(model.named_parameters()), model.cfg)
    out = {}
    for name, p in model.named_parameters():
        h = hashlib.sha256(p.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
        coords = tuple(mesh.axis_index(a) for a in axes[name].split() if mesh.present(a))
        out[name] = (coords or None, h.hexdigest())
    return out


def replicas_differ(mesh, model, tt) -> list:
    import torch.distributed as dist

    every = [None] * mesh.size
    dist.all_gather_object(every, shard_digests(model, mesh, tt))
    bad = []
    for name in every[0]:
        held = {}
        for d in every:
            held.setdefault(str(d[name][0]), set()).add(d[name][1])
        if any(len(v) != 1 for v in held.values()):
            bad.append(name)
    return bad


def moe_mesh_worker(hvd) -> dict:
    """Phase slice moe's meshes on every rank: the layer check
    (``moe_layer_check``), then GPT-2 small with MoE blocks on the mesh
    through ``build_hybrid_lm_step`` on the bf16 wire for 1 +
    ``MOE_MESH_TIMED`` steps: finite losses, replicas bitwise, B2 12 and B1
    3 per bucket exchange per step."""
    import torch

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh
    from horovod_tpu_torch.utils.benchmarks import build_hybrid_lm_step

    dev = hvd.device()
    on_card = dev.type == "cuda"
    build, seq, vocab, layers, d, ff = ((tt.gpt_small, GPT_SEQ, GPT_VOCAB, GPT_LAYERS, 768, 3072)
                                        if on_card else (tt.gpt_tiny, 64, 256, 2, 64, 128))
    counters = mesh_kernels()
    steps = 1 + MOE_MESH_TIMED
    runs, problems = {}, []
    for kind, deg in MOE_MESHES.items():
        os.environ["HVD_TPU_SCHED_WIRE"] = "bf16"
        mesh = make_mesh(**deg)
        try:
            dp, ep = mesh.axis_size("dp"), mesh.axis_size("ep")
            hidden = ff // MOE_MESH_EXPERTS
            layer = moe_layer_check(mesh, MOE_MESH_EXPERTS, d, hidden, MOE_MESH_BATCH, seq, dev)
            worst = max(layer.values())
            if not worst <= MOE_LAYER_RTOL:
                problems.append(f"{kind}: the layer over ep differs from the lone layer: "
                                f"{layer}")
            model = build(seed=0, device=dev, mesh=mesh, moe_every=2,
                          num_experts_local=MOE_MESH_EXPERTS, moe_k=2,
                          moe_capacity_factor=1.25)
            step, _ = build_hybrid_lm_step(model, mesh)
            data = hybrid_data(steps, MOE_MESH_BATCH * dp * ep, seq, vocab)
            i = mesh.axis_index("dp") * ep + mesh.axis_index("ep")
            rows = slice(i * MOE_MESH_BATCH, (i + 1) * MOE_MESH_BATCH)
            for c in counters.values():
                c.launches = 0
            metrics.reset("sched.")
            losses, times = [], []
            for s in range(steps):
                t0 = time.perf_counter()
                toks = data[s, rows].to(dev)
                losses.append(float(step(toks[:, :-1], toks[:, 1:])))
                times.append((time.perf_counter() - t0) * 1e3)
            launches = {k: c.launches for k, c in counters.items()}
            buckets = metrics.get_counter("sched.buckets")
            want = {k: 0 for k in counters}
            if on_card:
                want.update(flash_fwd=layers * steps, flash_fwd_wgmma=layers * steps,
                            scale_cast=3 * buckets)
            if launches != want:
                problems.append(f"{kind}: launches {launches}, expected {want}")
            if not all(math.isfinite(v) for v in losses):
                problems.append(f"{kind}: losses {losses}")
            bad = replicas_differ(mesh, model, tt)
            if bad:
                problems.append(f"{kind}: replicas differ: {bad}")
            ms = sorted(times[1:])
            runs[kind] = {"layer": layer, "losses": losses, "launches": launches,
                          "buckets": buckets, "step_ms": ms[len(ms) // 2],
                          "experts": ep * MOE_MESH_EXPERTS, "hidden": hidden}
            del model, step
        finally:
            mesh.shutdown()
        if on_card:
            torch.cuda.empty_cache()
    return {"runs": runs, "problems": problems}


def print_moe_meshes(rec, card) -> None:
    for kind, r in rec["runs"].items():
        worst = max(r["layer"].values())
        print(f"phase slice moe {kind}: {rec['layout']}; the MoE layer over ep ({r['experts']} "
              f"experts of {r['hidden']}, {MOE_MESH_EXPERTS} a rank) in float32 on each rank's "
              f"{MOE_MESH_BATCH} x {GPT_SEQ} tokens against the rank's lone layer over every "
              f"expert: worst {worst:.3g} of the largest element (limit {MOE_LAYER_RTOL}; "
              + ", ".join(f"{k} {v:.2g}" for k, v in r["layer"].items())
              + f"); GPT-2 small with MoE every 2nd block, batch {MOE_MESH_BATCH} x {GPT_SEQ} "
              f"per rank, bf16 wire: losses {[round(v, 5) for v in r['losses']]}, replicas "
              f"bitwise, launches {r['launches']} (B2 12 per step, B1 3 x {r['buckets']} bucket "
              f"exchanges); median step {r['step_ms']:.1f} ms on {card}", flush=True)
    print(f"phase slice moe meshes: {rec['wall_s']:.0f} s with start-up", flush=True)


def pipeline_worker(hvd) -> dict:
    """Phase slice pipeline on every rank: ``pipeline_apply`` over ``pp4``,
    this rank's stage the GPT blocks ``per·stage ... per·stage + per − 1``
    of GPT-2 small (seed 0), ``PIPE_M`` microbatches of ``[PIPE_ROWS, 1024,
    768]`` bf16, with ``remat_stage`` off and on, each after one warm-up
    call (the first of each took 6.5 s on an H100: the ranks' first hops
    and kernels); each against this rank applying all the blocks in
    sequence, one microbatch at a time."""
    import copy

    import torch

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh, pipeline_apply

    dev = hvd.device()
    on_card = dev.type == "cuda"
    if on_card:
        full = tt.gpt_small(seed=0, device="cpu")
        seq = GPT_SEQ
    else:
        full = tt.gpt_tiny(seed=0, device="cpu", num_layers=4)
        seq = 64
    cfg = full.cfg
    counters = mesh_kernels()
    problems = []
    mesh = make_mesh(pp=MESH_WORLD)
    try:
        n, stage = mesh.axis_size("pp"), mesh.axis_index("pp")
        per = cfg.num_layers // n
        blocks = [getattr(full, f"block_{i}").to(dev) for i in range(cfg.num_layers)]
        mine = torch.nn.ModuleList(copy.deepcopy(blocks[stage * per:(stage + 1) * per]))
        g = torch.Generator().manual_seed(11)
        x = torch.randn(PIPE_M, PIPE_ROWS, seq, cfg.model_dim, generator=g).to(cfg.dtype).to(dev)
        wts = torch.randn(PIPE_M, PIPE_ROWS, seq, cfg.model_dim, generator=g).to(dev)

        def stage_fn(mods, h):
            for m in mods:
                h = m(h)[0]
            return h

        def sync():
            if on_card:
                torch.cuda.synchronize()

        for remat in (False, True):  # warm-up: the first call of each takes seconds
            ((pipeline_apply(stage_fn, mine, x, mesh, remat_stage=remat).float() * wts).sum()
             / n).backward()
        runs = {}
        for remat in (False, True):
            mine.zero_grad(set_to_none=True)
            sync()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            out = pipeline_apply(stage_fn, mine, x, mesh, remat_stage=remat)
            ((out.float() * wts).sum() / n).backward()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: c.launches for k, c in counters.items()}
            b2 = per * (PIPE_M + n - 1) * (2 if remat else 1) if on_card else 0
            want = {k: (b2 if k in ("flash_fwd", "flash_fwd_wgmma") else 0) for k in counters}
            if launches != want:
                problems.append(f"remat_stage={remat}: launches {launches}, expected {want}")
            runs[remat] = {"out": out.detach(), "ms": ms, "launches": launches,
                           "grads": [p.grad.detach().clone() for p in mine.parameters()]}
        t0 = time.perf_counter()
        ref_out = []
        for m in range(PIPE_M):
            h = stage_fn(blocks, x[m])
            (h.float() * wts[m]).sum().backward()
            ref_out.append(h.detach())
        sync()
        ref_ms = (time.perf_counter() - t0) * 1e3
        ref_out = torch.stack(ref_out)
        ref_grads = [p.grad for b in blocks[stage * per:(stage + 1) * per]
                     for p in b.parameters()]
        rec = {"stage": stage, "blocks_per_stage": per, "ref_ms": ref_ms}
        for remat, r in runs.items():
            out_err = float((r["out"].float() - ref_out.float()).abs().max())
            grad_err = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                           for a, b in zip(r["grads"], ref_grads))
            if not out_err <= PIPE_OUT_ATOL or not grad_err <= PIPE_GRAD_RTOL:
                problems.append(f"remat_stage={remat}: outputs {out_err} apart (limit "
                                f"{PIPE_OUT_ATOL}), gradients {grad_err} of their norm "
                                f"(limit {PIPE_GRAD_RTOL})")
            rec[f"remat{int(remat)}"] = {"ms": r["ms"], "launches": r["launches"],
                                        "out_err": out_err, "grad_err": grad_err}
        rec["remat_bitwise"] = bool(
            torch.equal(runs[False]["out"], runs[True]["out"])
            and all(torch.equal(a, b) for a, b in zip(runs[False]["grads"], runs[True]["grads"])))
        if not rec["remat_bitwise"]:
            problems.append("remat_stage=True changed the outputs or the gradients")
        import torch.distributed as dist

        every = [None] * n
        dist.all_gather_object(every, rec)
        return {"stages": every, "problems": problems}
    finally:
        mesh.shutdown()


def print_pipeline(rec, card) -> None:
    worst_out = max(s[f"remat{k}"]["out_err"] for s in rec["stages"] for k in (0, 1))
    worst_grad = max(s[f"remat{k}"]["grad_err"] for s in rec["stages"] for k in (0, 1))
    per = rec["stages"][0]["blocks_per_stage"]
    print(f"phase slice pipeline: {rec['layout']}; pp{rec['world']} over GPT-2 small's 12 "
          f"blocks ({per} a stage, flash, bf16), {PIPE_M} microbatches of [{PIPE_ROWS}, "
          f"{GPT_SEQ}, 768], broadcast outputs: against each rank applying the 12 blocks in "
          f"sequence, outputs at most {worst_out:.3g} apart (limit {PIPE_OUT_ATOL}), every "
          f"stage's gradients within {worst_grad:.3g} of their norm (limit {PIPE_GRAD_RTOL}); "
          f"remat_stage bitwise with off; B2 launches per stage "
          f"{[s['remat0']['launches']['flash_fwd'] for s in rec['stages']]} off, "
          f"{[s['remat1']['launches']['flash_fwd'] for s in rec['stages']]} on "
          f"(= {per} x (M + n - 1), doubled); forward + backward "
          f"{[round(s['remat0']['ms'], 1) for s in rec['stages']]} ms off, "
          f"{[round(s['remat1']['ms'], 1) for s in rec['stages']]} ms on, sequential "
          f"reference {[round(s['ref_ms'], 1) for s in rec['stages']]} ms per rank (host "
          f"clock) on {card}; {rec['wall_s']:.0f} s with start-up", flush=True)


class KernelRecorder:
    """Records every call of B3, B4 and B5 made through ``quant_kernels``
    (inputs and outputs on the host) while active, to hold each against
    its plain version afterwards."""

    def __init__(self):
        from horovod_tpu_torch.ops import quant_kernels as qk

        self.qk, self.calls, self.saved = qk, [], {}

    def __enter__(self):
        for name in ("quant_packed", "dequant_accum", "dequant_rows"):
            fn = getattr(self.qk, name)
            self.saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                host = lambda v: v.detach().cpu() if hasattr(v, "detach") else v  # noqa: E731
                res = tuple(host(o) for o in out) if isinstance(out, tuple) else host(out)
                self.calls.append((_name, [host(v) for v in a], dict(kw), res))
                return out
            wrapped.launches = 0  # the kernel counts its launch on the module's name
            setattr(self.qk, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            fn.launches += getattr(self.qk, name).launches
            setattr(self.qk, name, fn)

    def mismatches(self) -> list:
        qk, bad = self.qk, []
        for name, a, kw, res in self.calls:
            want = getattr(qk, name + "_reference")(*a, **kw)
            got = res if isinstance(res, tuple) else (res,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if g is None and w is None:
                    continue
                if g is None or w is None or not torch_bits_equal(g, w):
                    bad.append(name)
        return bad


def torch_bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def fsdp_worker(hvd) -> dict:
    """Phase slice fsdp on every rank: GPT-2 small (flash, seq 1024, batch
    ``FSDP_BATCH`` per rank, AdamW lr 3e-4, the same weights and tokens)
    through the replicated data-parallel step (``DistributedOptimizer``,
    dense and ``Compression.bf16``), ``fsdp_train_step`` (dense and
    ``Compression.bf16``) and ``zero_train_step`` on the int8 wire with
    error feedback, ``FSDP_STEPS`` steps each."""
    import copy

    import torch
    import torch.distributed as dist
    from torch.func import functional_call

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import transformer as tt

    dev = hvd.device()
    on_card = dev.type == "cuda"
    n, rank = hvd.size(), hvd.rank()
    build, seq, vocab = ((tt.gpt_small, GPT_SEQ, GPT_VOCAB) if on_card
                         else (tt.gpt_tiny, 64, 256))
    base = build(seed=0, device=dev)  # each run starts from a copy of it
    start = {k: v.detach().float().cpu() for k, v in base.named_parameters()}
    n_params = sum(p.numel() for p in base.parameters())
    data = hybrid_data(FSDP_STEPS, FSDP_BATCH * n, seq, vocab)
    mine = data[:, rank * FSDP_BATCH:(rank + 1) * FSDP_BATCH].to(dev)
    counters = mesh_kernels()

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    def lm_loss(m, toks):
        logits, aux = m(toks[:, :-1])
        return tt.token_cross_entropy(logits, toks[:, 1:]) + 0.01 * aux

    def fsdp_loss(params, toks):
        logits, aux = functional_call(base, params, (toks[:, :-1],))
        return tt.token_cross_entropy(logits, toks[:, 1:]) + 0.01 * aux

    def mean_loss(loss):
        t = loss.detach().reshape(1).clone()
        dist.all_reduce(t)
        return float(t[0] / n)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    runs, problems = {}, []
    for kind in ("dp", "dp_bf16", "fsdp", "fsdp_bf16", "zero_int8"):
        model = copy.deepcopy(base)  # no optimizer's hooks on it yet
        os.environ["HVD_TPU_SCHED_WIRE"] = "off"
        comp = hvd.Compression.bf16 if kind.endswith("bf16") else hvd.Compression.none
        check = {}
        if kind.startswith("dp"):
            opt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                           named_parameters=model.named_parameters(),
                                           compression=comp)

            def one(toks):
                loss = lm_loss(model, toks)
                loss.backward()
                opt.step()
                opt.zero_grad(set_to_none=True)
                return mean_loss(loss)
            persistent = 3 * n_params * 4  # the weights and AdamW's two moments
        elif kind.startswith("fsdp"):
            step = hvd.fsdp_train_step(fsdp_loss, adamw,
                                       compression=comp if kind == "fsdp_bf16" else None)
            state = list(step.init(dict(model.named_parameters())))

            def one(toks):
                state[0], state[1], loss = step(state[0], state[1], toks)
                return float(loss)
            persistent = 3 * state[0].numel() * 4
        else:
            zstep = hvd.zero_train_step(lm_loss, adamw, wire="int8")
            zstate = zstep.init(model)
            persistent = (n_params + 3 * zstate.shard_len + zstate.padded) * 4

            def one(toks):
                return float(zstep(model, zstate, toks)[2])
            # The first step's quantized exchange: every B3/B4/B5 call
            # bitwise with its plain version, and the averaged gradient
            # shard within the int8 grid of the dense mean.
            lm_loss(model, mine[0]).backward()
            gflat = zstate._flat([p.grad for p in model.parameters()])
            model.zero_grad(set_to_none=True)
            dense = torch.empty(zstate.shard_len, device=dev)
            dist.reduce_scatter_tensor(dense, gflat)
            with KernelRecorder() as recorder:
                ef = zstate.ef.clone()
                gshard = zstate._reduce_scatter(gflat)
                zstate.ef = ef
            bad = recorder.mismatches()
            # Each rank's contribution is within half an int8 step of its
            # block's largest element, G / 254 at most; the mean of n
            # such errors too.  The bound is twice that.
            g_max = gflat.abs().max().reshape(1)
            dist.all_reduce(g_max, op=dist.ReduceOp.MAX)
            grid = float(g_max[0]) / 127
            err = float((gshard - dense / n).abs().max())
            check = {"calls": len(recorder.calls), "plain_mismatches": bad,
                     "rs_err": err, "rs_bound": grid}
            if bad or not err <= grid:
                problems.append(f"zero int8: kernels differing from their plain versions "
                                f"{bad}; shard error {err} (bound {grid})")
        for c in counters.values():
            c.launches = 0
        metrics.reset("quant.")
        losses = [one(mine[s]) for s in range(FSDP_STEPS)]
        launches = {k: c.launches for k, c in counters.items()}
        modes = {"fallback": metrics.get_counter("quant.fused_fallback"),
                 "fused": metrics.get_counter("quant.fused_collectives")}
        params = (step.gather(state[0]) if kind.startswith("fsdp")
                  else dict(model.named_parameters()))
        weights = {k: v.detach().float().cpu().clone() for k, v in params.items()}
        times = []
        for s in range(FSDP_TIMED):  # warm steps, each ended by its loss's host read
            sync()
            t0 = time.perf_counter()
            one(mine[s])
            times.append((time.perf_counter() - t0) * 1e3)
        want = {k: 0 for k in counters}
        if on_card:
            want.update(flash_fwd=GPT_LAYERS * FSDP_STEPS,
                        flash_fwd_wgmma=GPT_LAYERS * FSDP_STEPS)
            if kind == "zero_int8":  # one RS and one AG per step, not on the ring
                ring = modes["fused"] > 0
                per = ({"rs_ring": 1, "ag_ring": 1} if ring else
                       {"quant_pack": 2, "dequant_accum": 1, "dequant_rows": 1})
                want.update({k: v * FSDP_STEPS for k, v in per.items()})
            if kind.startswith("dp"):  # the reference step's own scale and casts
                want["scale_cast"] = launches["scale_cast"]
        if launches != want:
            problems.append(f"{kind}: launches {launches}, expected {want}")
        ms = sorted(times)
        runs[kind] = {"losses": losses, "launches": launches, "modes": modes,
                      "step_ms": ms[len(ms) // 2], "persistent_bytes": persistent,
                      "check": check, "weights": weights}
        del one, model
        if on_card:
            torch.cuda.empty_cache()

    def compare(kind, ref):
        a, b = runs[kind], runs[ref]
        worst_abs, worst_ratio = 0.0, 0.0
        for name, w in b["weights"].items():
            diff = (a["weights"][name] - w).abs()
            move = (w - start[name]).abs()
            worst_abs = max(worst_abs, float(diff.max()))
            if name.endswith("qkv.Dense_0.bias"):  # [3, H, D]: drop the key third
                diff, move = diff.view(3, -1)[[0, 2]], move.view(3, -1)[[0, 2]]
            worst_ratio = max(worst_ratio, float(diff.mean() / move.mean()))
        return {"first_loss": (a["losses"][0], b["losses"][0]), "worst_abs": worst_abs,
                "worst_mean_ratio": worst_ratio}

    compared = {k: compare(k, ref) for k, ref in (("fsdp", "dp"), ("fsdp_bf16", "dp_bf16"),
                                                  ("zero_int8", "dp"))}
    for kind, c in compared.items():
        first, want = c["first_loss"]
        limit = FSDP_RATIO["int8" if kind == "zero_int8" else "dense"]
        if abs(first - want) > FSDP_LOSS_RTOL * abs(want) or c["worst_abs"] > ADAM_APART or (
                not c["worst_mean_ratio"] <= limit):
            problems.append(f"{kind}: {c} (loss rtol {FSDP_LOSS_RTOL}, weights "
                            f"{ADAM_APART:.2e}, mean ratio {limit})")
    for r in runs.values():
        del r["weights"]
        if not all(math.isfinite(v) for v in r["losses"]):
            problems.append(f"losses {r['losses']}")
    return {"runs": runs, "compared": compared, "params": n_params, "problems": problems}


def print_fsdp(rec, card) -> None:
    runs = rec["runs"]
    for kind, r in runs.items():
        c = rec["compared"].get(kind)
        vs = (f"; against {'dp_bf16' if kind == 'fsdp_bf16' else 'dp'}: first loss "
              f"{c['first_loss'][0]:.6f} vs {c['first_loss'][1]:.6f}, weights after "
              f"{FSDP_STEPS} steps at most {c['worst_abs']:.3g} apart (bound "
              f"{ADAM_APART:.2e}), mean difference {c['worst_mean_ratio']:.3f} of the mean move"
              if c else "")
        chk = r["check"]
        wire = (f"; first step's exchange: {chk['calls']} B3/B4/B5 calls bitwise with their "
                f"plain versions, the averaged gradient shard within {chk['rs_err']:.3g} of "
                f"the dense mean (bound {chk['rs_bound']:.3g}); dispatch: {r['modes']}"
                if chk else "")
        print(f"phase slice fsdp {kind}: {rec['layout']}; GPT-2 small ({rec['params']} "
              f"parameters), flash, batch {FSDP_BATCH} x {GPT_SEQ} per rank, AdamW: losses "
              f"{[round(v, 5) for v in r['losses']]}{vs}{wire}; persistent "
              f"{r['persistent_bytes'] / 2 ** 20:.0f} MiB per rank (weights and moments; "
              f"replicated {runs['dp']['persistent_bytes'] / 2 ** 20:.0f} MiB); launches "
              f"{r['launches']} over {FSDP_STEPS} steps; median step {r['step_ms']:.1f} ms "
              f"(host clock, {FSDP_TIMED} more steps) on {card}", flush=True)
    print(f"phase slice fsdp: {rec['wall_s']:.0f} s with start-up", flush=True)


# Phase slice topo: the topology forced to two domains of two ranks
# (``HVD_TPU_TOPO=2x2``), in the same layouts as the mesh phases.  The
# hierarchical collectives at the largest ResNet-50 bucket's size
# (16,489,448 float32 elements, dyadic: every sum is exact, so each
# lowering must give the flat sum's bits); Adasum at 4,194,305 elements
# (ragged: the halving pads it) of normal noise.  Adasum against a
# float64 NumPy Adasum on rank 0: the float32 dot products and norms of
# 4M elements are summed in another order than float64's (torch's
# pairwise reductions, and the all-reduce of each level's scalars), a
# few ulps of each coefficient, and the results agree to 2e-5 of the
# largest element; a wrong pairing or a lost half moves whole elements.
# The ResNet-50 runs start from seed 0, each rank its own batch; the
# first loss of a run whose forward is the replicated step's equals it
# to 1e-6 (the same forward; the mean of four losses).  SyncBatchNorm's
# forward normalises by the global batch's moments: its first loss is
# held, on rank 0, against one forward of the plain model over the four
# batches concatenated (plain BatchNorm's moments are then the global
# ones), to 1e-2: in bf16 the synced norm applies x·mult + shift with
# two bf16 roundings where the plain one normalises in float32 and
# rounds once, at each of the 53 norms (float32 off the card: 1e-5).
TOPO_SPEC = "2x2"
TOPO_ELEMS = 16_489_448
TOPO_ADASUM_ELEMS = 4_194_305
TOPO_ADASUM_RTOL = 2e-5
TOPO_LOSS_RTOL = 1e-6
TOPO_SYNC_BN_RTOL = {"cuda": 1e-2, "cpu": 1e-5}
TOPO_WARMUP, TOPO_TIMED = 2, 3
TOPO_RUNS = {  # label: (wire, HVD_TPU_TOPO_LOWER, op, sync_bn)
    "replicated": ("bf16", "flat", "average", False),
    "adasum": ("bf16", "auto", "adasum", False),
    "sync_bn": ("bf16", "flat", "average", True),
    "hier_int8": ("int8", "hier", "average", False),
}


def adasum64(vs):
    """Adasum as the recursive pairwise definition, in float64 (numpy): a
    non-power-of-two count folds its stragglers into the first members,
    then pairs combine level by level."""
    import numpy as np

    vs = [np.asarray(v, np.float64) for v in vs]

    def pair(a, b):
        dot, na, nb = a @ b, a @ a, b @ b
        ca = 1 - dot / (2 * na) if na > 0 else 1.0
        cb = 1 - dot / (2 * nb) if nb > 0 else 1.0
        return ca * a + cb * b

    p = 1 << (len(vs).bit_length() - 1)
    vs = [pair(vs[i], vs[p + i]) for i in range(len(vs) - p)] + vs[len(vs) - p:p]
    while len(vs) > 1:
        vs = [pair(vs[2 * i], vs[2 * i + 1]) for i in range(len(vs) // 2)]
    return vs[0]


def plain_quantized_sum(xs, wire, block=BLOCK):
    """The NCCL lowering of ``ops/quantized.py`` ``quantized_allreduce``
    (Sum) over one group, on the CPU through the plain versions of B3,
    B4 (arrivals in group order) and B5: ``xs`` the members' float32
    vectors; returns the result every member holds."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import quant_kernels as qk

    n, V = len(xs), xs[0].numel()
    c = -(-V // (n * block)) * block
    packed = [qk.quant_packed_reference(F.pad(x.float(), (0, c * n - V)).view(
        n, c // block, block), wire)[0] for x in xs]
    shards = [qk.dequant_accum_reference(torch.stack([packed[m][j] for m in range(n)]),
                                         wire).view(c) for j in range(n)]
    rows = torch.cat([qk.quant_packed_reference(s.view(1, c // block, block), wire)[0]
                      for s in shards])
    return qk.dequant_rows_reference(rows, wire).reshape(-1)[:V]


def plain_hier(xs, wire, s=2, k=2):
    """``topo/hierarchical.py`` ``hierarchical_all_reduce`` (Sum) of the
    ranks' vectors ``xs`` over ``s`` domains of ``k`` consecutive ranks,
    on the CPU through the plain kernels: each domain's sum (exact on
    dyadic inputs, in any order), split in k shards; rail i sums shard i
    across the domains (bf16: B1's plain cast down, a bf16 sum, the cast
    up; int8/fp8: :func:`plain_quantized_sum`); the shards concatenated."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import kernels

    V = xs[0].numel()
    Vp = -(-V // k) * k
    doms = [F.pad(sum(xs[j * k:(j + 1) * k]), (0, Vp - V)) for j in range(s)]
    L = Vp // k
    out = []
    for i in range(k):
        parts = [d[i * L:(i + 1) * L] for d in doms]
        if wire == "bf16":
            down = [kernels.scale_cast_reference(p, 1.0, torch.bfloat16) for p in parts]
            acc = down[0]
            for p in down[1:]:
                acc = acc + p
            out.append(kernels.scale_cast_reference(acc, 1.0, torch.float32))
        elif wire in ("int8", "fp8"):
            out.append(plain_quantized_sum(parts, wire))
        else:
            out.append(sum(parts))
    return torch.cat(out)[:V]


def topo_expected(label, buckets, steps) -> dict:
    """Launches on rank 0 of ``steps`` steps of a ``TOPO_RUNS`` run with
    ``buckets`` buckets: bf16 flat at world 4, B1 three times per bucket
    per step (the cast, the 1/4 postscale of the bf16 buffer, the cast
    back); ``hier_adasum`` on bf16 twice (the cross-domain gather's casts;
    the domain mean is a float32 multiply); hier on int8, B3 twice, B4 and
    B5 once (the cross-domain quantized allreduce of the 1/2 shard), B1
    never (the 1/4 is a float32 multiply)."""
    m = buckets * steps
    zero = {"scale_cast": 0, "quant_pack": 0, "dequant_accum": 0, "dequant_rows": 0,
            "rs_ring": 0, "ag_ring": 0}
    if label == "hier_int8":
        return dict(zero, quant_pack=2 * m, dequant_accum=m, dequant_rows=m)
    return dict(zero, scale_cast=(2 if label == "adasum" else 3) * m)


def timed_collective(fn, iters: int = 5) -> float:
    """Host ms per call of a collective, every rank aligned by a barrier
    first and each call's device work waited for."""
    import torch
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def topo_worker(hvd) -> dict:
    """Phase slice topo on every rank: ``HVD_TPU_TOPO=2x2`` (domains {0,1}
    and {2,3}), the set {0,1,2} registered.  The hierarchical allreduce on
    the off, bf16 and int8 cross-domain hops; Adasum flat, on {0,1,2} and
    ``hier_adasum``; then the full-width ResNet-50 step (``TOPO_RUNS``).
    Off the card (a rehearsal) the sizes are cut: 8,198 and 4,099
    elements, a narrow ResNet (stages [1,1,1,1], 8 filters, 32x32, batch
    2, float32)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import resnet as tresnet
    from horovod_tpu_torch.exceptions import HorovodTpuError
    from horovod_tpu_torch.topo import hierarchical as th
    from horovod_tpu_torch.topo import model as topo_model
    from horovod_tpu_torch.utils.benchmarks import build_dp_step, timed_throughput

    os.environ["HVD_TPU_TOPO"] = TOPO_SPEC
    os.environ["HVD_TPU_QUANT_BACKEND"] = "fused"
    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    on_card = dev.type == "cuda"
    nccl = dist.get_backend() == "nccl"
    topo = topo_model.current()
    counters = mesh_kernels()
    elems, aelems = (TOPO_ELEMS, TOPO_ADASUM_ELEMS) if on_card else (8198, 4099)
    problems, rec = [], {"topology": [topo.num_slices, topo.slice_size], "elems": elems,
                         "adasum_elems": aelems}

    def resnet(sync_bn):
        if on_card:
            return tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                                    device=dev, sync_bn=sync_bn)
        return tresnet.ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                              dtype=torch.float32, seed=0, device=dev, sync_bn=sync_bn)

    def zero_counts():
        for c in counters.values():
            c.launches = 0
        metrics.reset("quant.")
        metrics.reset("xir.")

    def counts():
        out = {k: c.launches for k, c in counters.items() if not k.startswith("flash")}
        out["fallback"] = metrics.get_counter("quant.fused_fallback")
        return out

    def same_on_every_rank(t, what):
        every = [None] * n
        dist.all_gather_object(every, hashlib_digest(t))
        if len(set(every)) != 1:
            problems.append(f"{what}: the ranks differ")

    # The hierarchical allreduce on every hop, against the flat sum and
    # the plain kernels' chain on the CPU.
    cpu = [(torch.randint(-64, 65, (elems,), generator=torch.Generator().manual_seed(
        500 + r)) / 8).float() for r in range(n)]
    x = cpu[rank].to(dev)
    flat = hvd.allreduce(x, op=hvd.Sum)
    exact = sum(cpu)
    hier = {}
    for wire in ("off", "bf16", "int8"):
        zero_counts()
        with KernelRecorder() as recorder:
            y = th.hierarchical_all_reduce(x, op=hvd.Sum, wire=wire)
            torch.cuda.synchronize() if on_card else None
        got = counts()
        want = {"scale_cast": 0, "quant_pack": 0, "dequant_accum": 0, "dequant_rows": 0,
                "rs_ring": 0, "ag_ring": 0, "fallback": 0}
        if wire == "bf16":
            want["scale_cast"] = 2
        if wire == "int8":
            want.update(quant_pack=2, dequant_accum=1, dequant_rows=1, fallback=2)
        if on_card and got != want:
            problems.append(f"hier {wire}: launches {got}, expected {want}")
        bad = recorder.mismatches()
        if bad:
            problems.append(f"hier {wire}: {bad} differ from their plain versions")
        plain = plain_hier(cpu, wire)
        if not torch_bits_equal(y.cpu(), plain):
            problems.append(f"hier {wire}: not bitwise with the plain kernels' chain")
        if wire != "int8" and not (torch_bits_equal(y, flat)
                                   and torch_bits_equal(y.cpu(), exact)):
            problems.append(f"hier {wire}: not bitwise with the flat allreduce")
        hier[wire] = {"launches": got, "calls_checked": len(recorder.calls),
                      "max_abs_err_vs_exact": float((y.cpu() - exact).abs().max())}
        same_on_every_rank(y, f"hier {wire}")
    rec["hier"] = hier
    if on_card:
        ms = {"flat": timed_collective(lambda: hvd.allreduce(x, op=hvd.Sum))}
        for wire in ("off", "bf16", "int8"):
            ms[f"hier {wire}"] = timed_collective(
                lambda w=wire: th.hierarchical_all_reduce(x, op=hvd.Sum, wire=w))
        rec["hier_ms"] = ms
    del x, flat, y

    # Adasum: flat over the world, over {0,1,2}, and hier_adasum.
    xa_cpu = [torch.randn(aelems, generator=torch.Generator().manual_seed(600 + r))
              for r in range(n)]
    xa = xa_cpu[rank].to(dev)
    os.environ["HVD_TPU_DYNAMIC_PROCESS_SETS"] = "1"
    s012 = hvd.add_process_set([0, 1, 2])  # every rank alike
    adasum = {}
    cases = {"flat": (lambda: hvd.allreduce(xa, op=hvd.Adasum), list(range(n)),
                      lambda: adasum64([v.numpy() for v in xa_cpu])),
             "set012": (lambda: hvd.allreduce(xa, op=hvd.Adasum, process_set=s012),
                        [0, 1, 2], lambda: adasum64([v.numpy() for v in xa_cpu[:3]])),
             "hier_adasum": (lambda: th.hierarchical_adasum_all_reduce(xa, op=hvd.Average),
                             list(range(n)),
                             lambda: adasum64([((xa_cpu[0] + xa_cpu[1]) / 2).numpy(),
                                               ((xa_cpu[2] + xa_cpu[3]) / 2).numpy()]))}
    for name, (fn, members, ref) in cases.items():
        y = fn()
        if rank not in members:
            if not torch_bits_equal(y, xa):
                problems.append(f"adasum {name}: rank {rank}, off the set, changed its input")
        every = [None] * n
        dist.all_gather_object(every, hashlib_digest(y) if rank in members else None)
        if len({every[m] for m in members}) != 1:
            problems.append(f"adasum {name}: the members differ")
        entry = {"members": members}
        if rank == 0:
            want = ref()
            err = float(np.abs(y.double().cpu().numpy() - want).max())
            entry["rel_err"] = err / float(np.abs(want).max())
            if entry["rel_err"] > TOPO_ADASUM_RTOL:
                problems.append(f"adasum {name}: {entry['rel_err']:.3g} of the largest "
                                f"element from float64 (limit {TOPO_ADASUM_RTOL})")
        if on_card:
            entry["ms"] = timed_collective(fn, iters=3)
        adasum[name] = entry
    rec["adasum"] = adasum
    del xa

    # The full-width ResNet-50 step, each rank its own batch.
    g = torch.Generator(device=dev).manual_seed(300 + rank)
    rows, size, classes = (SET_BATCH, 224, 1000) if on_card else (2, 32, 10)
    batch = (torch.rand(rows, size, size, 3, generator=g, device=dev),
             torch.randint(0, classes, (rows,), generator=g, device=dev))
    steps = TOPO_WARMUP + TOPO_TIMED
    runs = {}
    for label, (wire, lower, op, sync_bn) in TOPO_RUNS.items():
        os.environ["HVD_TPU_SCHED_WIRE"] = wire
        os.environ["HVD_TPU_TOPO_LOWER"] = lower
        modes = ("off", "on") if nccl and label != "replicated" else ("off",)
        r = {}
        for mode in modes:
            os.environ["HVD_TPU_ONESTEP"] = mode
            model = resnet(sync_bn)
            step, opt = build_dp_step(hvd, model, op=hvd.Adasum if op == "adasum" else None)
            zero_counts()
            # The replicated step gives the first loss only; a captured
            # run's clock starts after its warm-up steps and its capture.
            extra = int(mode == "on")
            timed = 0 if label == "replicated" else TOPO_TIMED - extra
            seconds, losses = timed_throughput(
                step, batch, iters=timed,
                warmup=1 if label == "replicated" else TOPO_WARMUP + extra)
            got = counts()
            run = {"losses": losses, "step_ms": seconds / max(timed, 1) * 1e3,
                   "buckets": len(opt.schedule.buckets),
                   "lowerings": sorted({b.lowering for b in opt.schedule.buckets}),
                   "launches": got, "captures": metrics.get_counter("xir.onestep.steps"),
                   "digest": param_digest(model), "blocker": step.blocker()}
            nsteps = 1 if label == "replicated" else steps
            want = topo_expected(label, run["buckets"], nsteps)
            want["fallback"] = 2 * run["buckets"] * nsteps if label == "hier_int8" else 0
            if mode == "on":  # a replay counts its kernels, not Python's metrics
                want.pop("fallback")
                got = dict(got)
                got.pop("fallback")
            if on_card and got != want:
                problems.append(f"{label} {mode}: launches {got}, expected {want}")
            if not all(math.isfinite(v) for v in losses):
                problems.append(f"{label} {mode}: losses {losses}")
            if run["captures"] != int(mode == "on"):
                problems.append(f"{label} {mode}: {run['captures']} captures")
            every = [None] * n
            dist.all_gather_object(every, run["digest"])
            if len(set(every)) != 1:
                problems.append(f"{label} {mode}: the ranks' weights differ")
            r[mode] = run
            del model, step, opt
            torch.cuda.empty_cache() if on_card else None
        if "on" in r and r["on"]["digest"] != r["off"]["digest"]:
            problems.append(f"{label}: the captured step differs from the eager step")
        if on_card and not nccl and label != "replicated":  # capture refuses: its reason
            os.environ["HVD_TPU_ONESTEP"] = "on"
            model = resnet(sync_bn)
            step, _ = build_dp_step(hvd, model, op=hvd.Adasum if op == "adasum" else None)
            try:
                step(batch)
                problems.append(f"{label}: HVD_TPU_ONESTEP=on did not refuse on gloo")
            except HorovodTpuError as e:
                r["refused"] = str(e)
            del model, step
            torch.cuda.empty_cache() if on_card else None
        runs[label] = r
    for k in ("HVD_TPU_SCHED_WIRE", "HVD_TPU_TOPO_LOWER"):
        os.environ.pop(k, None)
    os.environ["HVD_TPU_ONESTEP"] = "off"
    first = runs["replicated"]["off"]["losses"][0]
    for label, r in runs.items():
        gap = abs(r["off"]["losses"][0] - first) / abs(first)
        r["first_loss_gap"] = gap
        if label != "sync_bn" and gap > TOPO_LOSS_RTOL:
            problems.append(f"{label}: first loss {r['off']['losses'][0]} is {gap:.3g} from "
                            f"the replicated step's {first} (limit {TOPO_LOSS_RTOL})")
    if rank == 0:  # SyncBatchNorm's first loss: the global batch's moments
        import torch.nn.functional as F

        whole = []
        for r in range(n):
            gr = torch.Generator(device=dev).manual_seed(300 + r)
            whole.append((torch.rand(rows, size, size, 3, generator=gr, device=dev),
                           torch.randint(0, classes, (rows,), generator=gr, device=dev)))
        model = resnet(False)
        model.train()
        with torch.no_grad():
            want = float(F.cross_entropy(model(torch.cat([b[0] for b in whole])),
                                         torch.cat([b[1] for b in whole])))
        got = runs["sync_bn"]["off"]["losses"][0]
        rtol = TOPO_SYNC_BN_RTOL[dev.type]
        runs["sync_bn"]["global_batch_loss"] = want
        runs["sync_bn"]["global_batch_gap"] = gap = abs(got - want) / abs(want)
        if gap > rtol:
            problems.append(f"sync_bn: first loss {got} is {gap:.3g} from one forward over "
                            f"the concatenated batches, {want} (limit {rtol})")
        del model, whole
        torch.cuda.empty_cache() if on_card else None
    rec["runs"] = runs
    rec["problems"] = problems
    return rec


def hashlib_digest(t) -> str:
    import hashlib

    import torch

    return hashlib.sha256(t.detach().contiguous().cpu().reshape(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()


def print_topo(rec, card) -> None:
    """The lines of a slice topo run (rank 0's record)."""
    s, k = rec["topology"]
    print(f"phase slice topo: {rec['layout']}; HVD_TPU_TOPO={TOPO_SPEC} ({s} domains of {k}); "
          f"hierarchical allreduce of {rec['elems']} dyadic float32 elements, bitwise with the "
          f"plain kernels' chain on every hop and with the flat allreduce on off and bf16, "
          f"every rank equal: "
          + "; ".join(f"{w} launches {v['launches']}"
                      + (f" ({v['calls_checked']} B3-B5 calls each held bitwise against its "
                         f"plain version)" if v["calls_checked"] else "")
                      for w, v in rec["hier"].items()),
          flush=True)
    if "hier_ms" in rec:
        print("phase slice topo: ms per call (host clock, synchronized) "
              + ", ".join(f"{k} {v:.3f}" for k, v in rec["hier_ms"].items())
              + f" on {card}", flush=True)
    for name, a in rec["adasum"].items():
        print(f"phase slice topo: Adasum {name} over {a['members']}, {rec['adasum_elems']} "
              f"elements: {a['rel_err']:.3g} of the largest element from float64 NumPy (limit "
              f"{TOPO_ADASUM_RTOL}), members bitwise equal"
              + (f"; {a['ms']:.3f} ms per call on {card}" if "ms" in a else ""), flush=True)
    for label, r in rec["runs"].items():
        off = r["off"]
        cap = ("the reference, eager" if label == "replicated"
               else "captured bitwise with eager (one capture)" if "on" in r
               else f"capture refused: {r['refused']}" if "refused" in r
               else "eager (no capture off the card)")
        ms = (f"step {off['step_ms']:.2f} ms"
              + (f", captured {r['on']['step_ms']:.2f} ms (replays)" if "on" in r else "")
              + f" on {card}; " if label != "replicated" else "")
        first = (f"first loss {r['global_batch_gap']:.3g} from one forward over the four "
                 f"batches concatenated, {r['first_loss_gap']:.3g} from the replicated step's"
                 if label == "sync_bn" else
                 f"first loss {r['first_loss_gap']:.3g} from the replicated step's")
        print(f"phase slice topo {label}: ResNet-50 224x224 batch {SET_BATCH} per rank "
              f"(on the card), "
              f"wire {TOPO_RUNS[label][0]}, lowering {off['lowerings']}, {off['buckets']} "
              f"buckets: losses {[round(v, 5) for v in off['losses']]} ({first}), replicas "
              f"bitwise, "
              f"rank 0 launches {off['launches']} (= expected); {ms}{cap}", flush=True)
    print(f"phase slice topo: {rec['wall_s']:.0f} s with start-up", flush=True)


# Phase slice tune: the autotune driver's sub-knobs at world 1, and the
# timed steps of each ScheduleTuner window.
TUNE_SAMPLES, TUNE_WINDOW = 4, 5
TUNE_STORE_WINDOWS, TUNE_STORE_STEPS = 3, 5
TUNE_CHECK_STEPS = 3
# Four ranks: the autotune sub-knobs of the int8 probe run (window steps,
# threshold samples), the hierarchical buffer (ResNet-50's largest bf16
# bucket, float32 elements), the fit's payload sizes in bytes and calls per
# size, and the fault's delay.
TUNE_WORLD_SAMPLES, TUNE_WORLD_WINDOW = 3, 4
TUNE_HIER_ELEMS = 16489448
TUNE_FIT_SIZES = [1 << 16, 1 << 18, 1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24, 1 << 26]
TUNE_FIT_CALLS = 5
TUNE_FAULT_SECS = 0.25


def tune_env(samples, window, **extra) -> dict:
    """Set the knobs of an autotuned run; returns what they were."""
    knobs = {"HVD_TPU_AUTOTUNE": "1", "HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": str(samples),
             "HVD_TPU_AUTOTUNE_WINDOW": str(window), "HVD_TPU_ONESTEP": "auto", **extra}
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    return old


def restore_env(old) -> None:
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def tuned_run(step, batches, counters, max_calls, on_card):
    """Call the autotuned ``step`` until its driver converges, recording
    per call: the variant it ran, whether it was settled (a replay, or
    any eager step), the graphs held, each kernel's launches, and on a
    card its device ms (CUDA events)."""
    import torch
    from horovod_tpu_torch import metrics

    at = step.autotune
    calls = []
    for i in range(max_calls):
        if at.converged:
            break
        variant = (at.threshold_bytes(), at.hierarchical(), at.quantized())
        before = {k: c.launches for k, c in counters.items()}
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
        loss = step(batches[i % len(batches)])
        if on_card:
            end.record()
        graph = None
        for sig, g in step._graphs.items():
            if sig[0] == variant:
                graph = g
        calls.append({"variant": variant, "settled": step.last_settled,
                      "engaged": metrics.get_gauge("sched.onestep.engaged", {"mode": "auto"}),
                      "graphs": step.graphs, "buckets": graph.buckets if graph else None,
                      "launches": {k: c.launches - before[k] for k, c in counters.items()},
                      "events": (start, end) if on_card else None, "loss": loss})
    if not at.converged:
        fail(f"slice tune: the autotune driver did not converge in {max_calls} calls")
    if on_card:
        torch.cuda.synchronize()
    for c in calls:
        c["loss"] = float(c["loss"])
        ev = c.pop("events")
        c["device_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
    return calls


def tune_windows(at, calls):
    """Each closed window with the device ms per step of the calls it
    timed, and whether every one of them was a replay."""
    out = []
    for w in at.windows:
        first, last = w["calls"]
        timed = calls[first - 1:last]
        ms = [c["device_ms"] for c in timed if c["device_ms"] is not None]
        out.append({"threshold": w["threshold"],
                    "lowering": "hier" if w["hierarchical"] else "flat",
                    "wire": "int8" if w["quantized"] else "fp",
                    "score": w["score"], "host_ms": w["seconds"] / w["timed_steps"] * 1e3,
                    "device_ms": sum(ms) / len(ms) if ms else None,
                    "replays": all(c["settled"] and c["engaged"] == 1.0 for c in timed),
                    "timed": len(timed)})
    return out


def fmt_tune_windows(windows) -> str:
    return "; ".join(
        f"{w['threshold']} B {w['lowering']} {w['wire']}: {w['score']:.3f} steps/s "
        f"(host {w['host_ms']:.2f} ms"
        + (f", device {w['device_ms']:.2f} ms" if w["device_ms"] is not None else "")
        + f" per step, {w['timed']} steps, "
        + ("all replays)" if w["replays"] else "not all replays)") for w in windows)


def tune_phase(hvd, tresnet, counters, card, log):
    """Phase slice tune at world one: ResNet-50 under ``HVD_TPU_AUTOTUNE=1``
    on the bf16 wire, until the driver converges; the frozen variant's
    captured step against a fresh ``TrainStep`` at its threshold; then
    ``ScheduleTuner`` exploring and storing, and a second tuner hitting
    the store; and the native core's plan."""
    import copy
    import tempfile

    import torch
    from horovod_tpu_torch import metrics, native
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP, MAX_GRAPHS
    from horovod_tpu_torch.sched import tune as stune
    from horovod_tpu_torch.utils.benchmarks import build_dp_step

    t0 = time.perf_counter()
    if not native.available():
        fail("slice tune: the native core did not build (native.available() is False)")
    meta = tresnet.ResNet50(num_classes=1000, device="meta")
    sizes = [p.numel() * 4 for p in meta.parameters()][::-1]
    for thr in (1 << 16, 1 << 22, 64 << 20):
        planned = native.fusion_plan(sizes, [0] * len(sizes), thr)
        if planned is None or fusion.bucket_plan(sizes, ["float32"] * len(sizes),
                                                 thr) != planned:
            fail(f"slice tune: bucket_plan of the ResNet-50 gradients at {thr} B did not "
                 f"take the native plan")
    g = torch.Generator(device="cuda").manual_seed(0)
    batches = [(torch.rand(32, 224, 224, 3, generator=g, device="cuda"),
                torch.randint(0, 1000, (32,), generator=g, device="cuda"))
               for _ in range(TUNE_CHECK_STEPS)]
    old = tune_env(TUNE_SAMPLES, TUNE_WINDOW, HVD_TPU_SCHED_WIRE="bf16")
    rec = {}
    hvd.init("cuda")
    try:
        dev = hvd.device()
        model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0, device=dev)
        step, opt = build_dp_step(hvd, model)
        at = step.autotune
        if at is None:
            fail("slice tune: HVD_TPU_AUTOTUNE=1 built no autotune driver")
        for c in counters.values():
            c.launches = 0
        calls = tuned_run(step, batches, counters, 120, True)
        rec["launches"] = {k: c.launches for k, c in counters.items()}
        windows = tune_windows(at, calls)
        frozen = (at.threshold_bytes(), at.hierarchical(), at.quantized())
        explored = max(c["graphs"] for c in calls)
        reserved_before = torch.cuda.memory_reserved()
        graphs_before = step.graphs
        step(batches[0])  # drops the losing variants' graphs
        torch.cuda.synchronize()
        reserved_after = torch.cuda.memory_reserved()
        if explored > MAX_GRAPHS or step.graphs != 1:
            fail(f"slice tune: {explored} graphs held while exploring (limit {MAX_GRAPHS}), "
                 f"{step.graphs} after convergence (want 1)")
        if not all(w["replays"] for w in windows):
            fail(f"slice tune: a window timed a step that was not a replay: {windows}")
        b1 = {}
        for c in calls:
            if c["settled"] and c["engaged"] == 1.0:
                want = 2 * c["buckets"]
                if c["launches"]["scale_cast"] != want:
                    fail(f"slice tune: variant {c['variant']}: {c['launches']['scale_cast']} "
                         f"B1 launches in a replay, want 2 x {c['buckets']} buckets")
                b1[c["variant"][0]] = (c["launches"]["scale_cast"], c["buckets"])
        # The frozen variant's captured step against a fresh step at its
        # threshold, from the same state, on the same batches.
        state = {k: v.clone() for k, v in model.state_dict().items()}
        opt_state = copy.deepcopy(opt.state_dict())
        tuned = [float(step(b)) for b in batches]
        tuned_digest = state_digest(model)
        if step.graphs != 1 or not step.last_settled:
            fail("slice tune: the converged step did not replay its one graph")
        del step, opt
        restore_env(old)
        os.environ["HVD_TPU_FUSION_THRESHOLD"] = str(frozen[0])
        os.environ["HVD_TPU_ONESTEP"] = "auto"
        os.environ["HVD_TPU_SCHED_WIRE"] = "bf16"
        fresh_model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                                       device=dev)
        fresh_model.load_state_dict(state)
        fresh_step, fresh_opt = build_dp_step(hvd, fresh_model)
        fresh_opt.load_state_dict(opt_state)
        fresh = [float(fresh_step(b)) for b in batches]
        if fresh != tuned or state_digest(fresh_model) != tuned_digest:
            fail(f"slice tune: the frozen variant's captured step is not bitwise with a "
                 f"fresh step at HVD_TPU_FUSION_THRESHOLD={frozen[0]}: losses {tuned} "
                 f"against {fresh}")
        del fresh_step, fresh_opt, fresh_model, model
        os.environ.pop("HVD_TPU_FUSION_THRESHOLD")
        torch.cuda.empty_cache()
        rec.update(windows=windows, frozen=list(frozen), explored_graphs=explored,
                   graphs_before=graphs_before, reserved_before=reserved_before,
                   reserved_after=reserved_after, b1_per_variant=b1, tuned_losses=tuned,
                   calls=len(calls))
        rec["store"] = tune_store(hvd, tresnet, build_dp_step, stune, metrics,
                                  batches[0], tempfile, CAPTURE_WARMUP)
    finally:
        restore_env(old)
        os.environ["HVD_TPU_ONESTEP"] = "off"
        for k in ("HVD_TPU_SCHED_BUCKET_BYTES", "HVD_TPU_TUNE_DB", "HVD_TPU_SCHED_WIRE",
                  "HVD_TPU_FUSION_THRESHOLD"):
            os.environ.pop(k, None)
        hvd.shutdown()
    rec["wall_s"] = time.perf_counter() - t0
    print(f"phase slice tune: native core built (native.available() True), bucket_plan of "
          f"the ResNet-50 gradients took the native plan", flush=True)
    print(f"phase slice tune: ResNet-50 224x224 batch 32 bf16 wire, world 1, "
          f"HVD_TPU_AUTOTUNE=1 (BAYES_OPT_MAX_SAMPLES {TUNE_SAMPLES}, WINDOW {TUNE_WINDOW}): "
          f"windows {fmt_tune_windows(rec['windows'])} on {card}", flush=True)
    print(f"phase slice tune: converged after {rec['calls']} calls to threshold "
          f"{rec['frozen'][0]} B, lowering {'hier' if rec['frozen'][1] else 'flat'}, wire "
          f"{'int8' if rec['frozen'][2] else 'fp'}; every timed step a replay; graphs held "
          f"{rec['explored_graphs']} at most while exploring (limit {MAX_GRAPHS}), "
          f"{rec['graphs_before']} at convergence, 1 after the drop; reserved memory "
          f"{rec['reserved_before'] / 2 ** 30:.2f} GiB before the drop, "
          f"{rec['reserved_after'] / 2 ** 30:.2f} GiB after; B1 launches per replay "
          f"(= 2 x buckets) by threshold "
          + ", ".join(f"{k}: {v[0]} ({v[1]} buckets)" for k, v in rec["b1_per_variant"].items())
          + f"; the frozen variant's captured step bitwise with a fresh step at "
          f"HVD_TPU_FUSION_THRESHOLD={rec['frozen'][0]} over {TUNE_CHECK_STEPS} steps "
          f"(losses {[round(v, 5) for v in rec['tuned_losses']]})", flush=True)
    s = rec["store"]
    print(f"phase slice tune: ScheduleTuner with HVD_TPU_TUNE_DB: first run "
          f"{len(s['windows'])} windows, stored bucket_bytes {s['stored']} "
          f"(sched.tune.db_miss {s['first']['db_miss']}, db_store {s['first']['db_store']}); "
          f"second tuner: sched.tune.db_hit {s['second']['db_hit']}, converged at window 0, "
          f"no exploration window; window_score (host dispatch, train.step_seconds) against "
          f"the synchronized window: "
          + "; ".join(f"{w['bucket_bytes']} B: score {w['score']:.4g} "
                      f"(host {w['host_ms']:.2f} ms, device {w['device_ms']:.2f} ms per step)"
                      for w in s["windows"] + [s["hit_window"]])
          + f" on {card}", flush=True)
    print(f"phase slice tune: {rec['wall_s']:.0f} s", flush=True)
    log["tune"] = rec
    return rec


def tune_store(hvd, tresnet, build_dp_step, stune, metrics, batch, tempfile, warmup):
    """``ScheduleTuner`` over the ResNet-50 step with ``HVD_TPU_TUNE_DB``
    in a temporary directory: the first tuner explores and stores, a
    second with the same signature hits and converges at window 0.  Each
    window: the bucket size set (``HVD_TPU_SCHED_BUCKET_BYTES``), the new
    plan's warm-up steps and capture, then the timed replays, scored
    from the registry (``train.step_seconds``, host dispatch) beside
    CUDA events around them."""
    import torch

    tmp = tempfile.mkdtemp(prefix="tune_db_")
    os.environ["HVD_TPU_TUNE_DB"] = os.path.join(tmp, "db.json")
    os.environ["HVD_TPU_ONESTEP"] = "auto"
    os.environ["HVD_TPU_SCHED_WIRE"] = "bf16"
    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                             device=hvd.device())
    step, opt = build_dp_step(hvd, model)
    step(batch)
    sig = opt.schedule.signature()

    def window(bucket_bytes, tuner):
        os.environ["HVD_TPU_SCHED_BUCKET_BYTES"] = str(bucket_bytes)
        for _ in range(warmup + 1):
            step(batch)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if tuner is not None:
            tuner.begin_window()
        view = stune.registry_view()
        start.record()
        for _ in range(TUNE_STORE_STEPS):
            step(batch)
        end.record()
        torch.cuda.synchronize()
        after = stune.registry_view()
        score = tuner.end_window() if tuner is not None else stune.window_score(view, after)
        return {"bucket_bytes": bucket_bytes, "score": score,
                "host_ms": (after["step_seconds_sum"] - view["step_seconds_sum"])
                / TUNE_STORE_STEPS * 1e3,
                "device_ms": start.elapsed_time(end) / TUNE_STORE_STEPS}

    metrics.reset("sched.tune")
    first = stune.ScheduleTuner(store_key=sig, warmup_windows=TUNE_STORE_WINDOWS)
    windows = []
    while not first.converged:
        windows.append(window(first.bucket_bytes(), first))
    counts_first = {k: metrics.get_counter(f"sched.tune.{k}")
                    for k in ("db_miss", "db_store", "db_hit")}
    # The knob fingerprint folds in HVD_TPU_SCHED_*: the second tuner is
    # made, as the first was, before the bucket size is set.
    os.environ.pop("HVD_TPU_SCHED_BUCKET_BYTES")
    second = stune.ScheduleTuner(store_key=sig, warmup_windows=TUNE_STORE_WINDOWS)
    counts_second = {k: metrics.get_counter(f"sched.tune.{k}") - counts_first[k]
                     for k in ("db_miss", "db_store", "db_hit")}
    if not second.converged or counts_second["db_hit"] != 1 or counts_first["db_store"] != 1:
        fail(f"slice tune: the second ScheduleTuner did not hit the store: converged "
             f"{second.converged}, counters {counts_first} then {counts_second}")
    if second.bucket_bytes() != first.bucket_bytes():
        fail(f"slice tune: the store hit gave {second.bucket_bytes()}, the first run "
             f"stored {first.bucket_bytes()}")
    hit = window(second.bucket_bytes(), None)
    del step, opt, model
    os.environ.pop("HVD_TPU_SCHED_BUCKET_BYTES", None)
    torch.cuda.empty_cache()
    return {"windows": windows, "stored": first.bucket_bytes(), "first": counts_first,
            "second": counts_second, "hit_window": hit,
            "warm_start": metrics.get_gauge("sched.tune.warm_start")}


def tune_worker(hvd) -> dict:
    """Phase slice tune on each of four ranks: the autotuned ResNet-50
    step with the int8 probe (``HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED=1``),
    then the hierarchical Sum and Average against flat on a 2x2 grid
    (``HVD_TPU_TOPO=2x2``), the measured cost model, a fault plan on the
    hierarchical step, and ``metric_average``.  Off the card (a
    rehearsal) the sizes are cut: a narrow ResNet at 32x32, batch 2,
    float32, 65,543 hierarchical elements, the fit's sizes up to 1 MiB."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import faults, metrics, native
    from horovod_tpu_torch.models import resnet as tresnet
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP
    from horovod_tpu_torch.topo import fit
    from horovod_tpu_torch.topo import model as topo_model
    from horovod_tpu_torch.utils.benchmarks import build_dp_step

    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    on_card = dev.type == "cuda"
    counters = mesh_kernels()
    problems, rec = [], {"native": native.available()}
    if not native.available():
        problems.append("the native core did not build")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def resnet():
        if on_card:
            return tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0, device=dev)
        return tresnet.ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                              dtype=torch.float32, seed=0, device=dev)

    g = torch.Generator(device=dev).manual_seed(7 + rank)
    shape, classes = ((SET_BATCH, 224, 224, 3), 1000) if on_card else ((2, 32, 32, 3), 10)
    batches = [(torch.rand(shape, generator=g, device=dev),
                torch.randint(0, classes, (shape[0],), generator=g, device=dev))
               for _ in range(3)]

    # 1. The autotuned step with the int8 probe: explored, then frozen at
    # the first threshold the search suggests (64 KiB: buckets under the
    # ring's cap).  Each int8 replay launches B6/B7 once per bucket the
    # ring serves and B3 twice, B4 and B5 once per bucket past its cap.
    runs = []
    for samples in (TUNE_WORLD_SAMPLES, 1):
        old = tune_env(samples, TUNE_WORLD_WINDOW, HVD_TPU_SCHED_WIRE="bf16",
                       HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED="1",
                       HVD_TPU_AUTOTUNE_HIER_WINDOWS="1", HVD_TPU_QUANT_BACKEND="fused")
        try:
            model = resnet()
            step, opt = build_dp_step(hvd, model)
            for c in counters.values():
                c.launches = 0
            calls = tuned_run(step, batches, counters, 80, on_card)
            at = step.autotune
            run = {"samples": samples, "windows": tune_windows(at, calls),
                   "frozen": [at.threshold_bytes(), at.hierarchical(), at.quantized()],
                   "int8_calls": sum(1 for c in calls if c["variant"][2]),
                   "int8_launches": {}}
            for c in calls:
                if not (c["variant"][2] and c["settled"] and c["engaged"] == 1.0):
                    continue
                got = {k: c["launches"][k] for k in ("quant_pack", "dequant_accum",
                                                     "dequant_rows", "rs_ring", "ag_ring")}
                ring, rest = got["rs_ring"], c["buckets"] - got["rs_ring"]
                want = {"quant_pack": 2 * rest, "dequant_accum": rest, "dequant_rows": rest,
                        "rs_ring": ring, "ag_ring": ring}
                if got != want:
                    problems.append(f"int8 probe replay: launches {got}, want {want} "
                                    f"({c['buckets']} buckets)")
                run["int8_launches"] = dict(got, buckets=c["buckets"])
            # Every rank follows rank 0: the same windows, scores and frozen
            # variant (utils/autotune.py).
            every = [None] * n
            dist.all_gather_object(every, [run["frozen"], [
                [w["threshold"], w["hierarchical"], w["quantized"], w["score"],
                 list(w["calls"])] for w in at.windows]])
            run["ranks_agree"] = all(e == every[0] for e in every)
            if not run["ranks_agree"]:
                problems.append(f"the ranks froze or windowed apart: {every}")
            if not run["int8_calls"]:
                problems.append("the int8 probe never ran")
            elif on_card and not run["int8_launches"]:
                problems.append("the int8 probe was never replayed")
            step(batches[0])
            sync()
            every = [None] * n
            dist.all_gather_object(every, state_digest(model))
            if len(set(every)) != 1:
                problems.append("the replicas differ after convergence")
            run["graphs_after"] = step.graphs
            runs.append(run)
            del step, opt, model
        finally:
            restore_env(old)
            os.environ["HVD_TPU_ONESTEP"] = "off"
        if on_card:
            torch.cuda.empty_cache()
    rec["runs"] = runs
    launched = {k for r in runs for k, v in r["int8_launches"].items() if v and k != "buckets"}
    rec["int8_kernels"] = sorted(launched)
    if on_card and not {"rs_ring", "ag_ring"} <= launched:
        problems.append(f"the int8 probe at 64 KiB did not take the ring: {runs[-1]}")

    # 2. The hierarchical Sum and Average against flat on the 2x2 grid.
    os.environ["HVD_TPU_TOPO"] = TOPO_SPEC
    topo_model.reset()
    elems = TUNE_HIER_ELEMS if on_card else 65543
    x = (torch.randint(-64, 65, (elems,), generator=torch.Generator().manual_seed(
        900 + rank)) / 8).float().to(dev)
    rec["hier"] = {"elems": elems, "grid": [list(map(list, collectives.host_groups()[0])),
                                            list(map(list, collectives.host_groups()[1]))]}
    for op, name in ((hvd.Sum, "sum"), (hvd.Average, "avg")):
        flat = hvd.allreduce(x, op=op)
        os.environ["HVD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
        hier = hvd.allreduce(x, op=op)
        sync()
        if hashlib_digest(hier) != hashlib_digest(flat):
            problems.append(f"hierarchical {name} differs from flat")
        rec["hier"][name + "_ms"] = timed_collective(lambda: hvd.allreduce(x, op=op)) \
            if on_card else None
        os.environ.pop("HVD_TPU_HIERARCHICAL_ALLREDUCE")
        rec["hier"][name + "_flat_ms"] = timed_collective(lambda: hvd.allreduce(x, op=op)) \
            if on_card else None
    del x

    # 4. A fault plan arming the cross-domain hop, on every rank; it fires
    # on rank 1 only.  The step on the hier lowering does not capture.
    faults.set_plan(f"topo.dcn_phase:slow:rank=1,secs={TUNE_FAULT_SECS},times=0")
    os.environ["HVD_TPU_ONESTEP"] = "auto"
    metrics.reset("faults.")
    small = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.ReLU(),
                                torch.nn.Linear(64, 10)).to(dev)
    fstep, _ = build_dp_step(hvd, small, lowering="hier")
    rec["fault_blocker"] = fstep.blocker()
    data = (torch.rand(8, 64, device=dev), torch.randint(0, 10, (8,), device=dev))
    for _ in range(CAPTURE_WARMUP + 1):
        fstep(data)
    sync()
    rec["fault_engaged"] = metrics.get_gauge("sched.onestep.engaged", {"mode": "auto"})
    y = torch.ones(1 << 16, device=dev)
    sync()
    dist.barrier()
    t = time.perf_counter()
    collectives.allreduce_(y, hvd.Sum, hierarchical=True)
    rec["fault_host_ms"] = (time.perf_counter() - t) * 1e3
    sync()
    rec["fault_fired"] = metrics.get_counter("faults.injected.topo.dcn_phase.slow")
    faults.set_plan(None)
    os.environ["HVD_TPU_ONESTEP"] = "off"
    every = [None] * n
    dist.all_gather_object(every, [rec["fault_fired"], rec["fault_host_ms"]])
    rec["fault_fired_by_rank"] = [v[0] for v in every]
    rec["fault_host_ms_by_rank"] = [v[1] for v in every]
    every = rec["fault_fired_by_rank"]
    if not (rec["fault_blocker"] or "").startswith("fault_plan") and (
            dist.get_backend() == "nccl" or rec["fault_blocker"] is None):
        problems.append(f"the fault plan did not block the capture: {rec['fault_blocker']}")
    if rec["fault_engaged"] != 0.0:
        problems.append("the step under the fault plan ran captured")
    if [bool(v) for v in every] != [r == 1 for r in range(n)]:
        problems.append(f"the fault fired on ranks {every}, want rank 1 only")
    os.environ.pop("HVD_TPU_TOPO")
    topo_model.reset()

    # 3. The measured cost model on the flat world (one NVLink domain),
    # asked for: unset, HVD_TPU_TOPO_FIT prices nothing on NCCL.
    rec["fit_default"] = fit.enabled()
    if dist.get_backend() == "nccl" and rec["fit_default"]:
        problems.append("HVD_TPU_TOPO_FIT unset priced with the fit on NCCL")
    os.environ["HVD_TPU_TOPO_FIT"] = "1"
    metrics.reset(fit.OBS_PREFIX)
    fit.reset()
    sizes = TUNE_FIT_SIZES if on_card else [s for s in TUNE_FIT_SIZES if s <= 1 << 20]
    device_ms = {}
    for nbytes in sizes:
        t = torch.ones(nbytes // 4, device=dev)
        for op in ("all_reduce", "reduce_scatter", "all_gather"):
            call = {"all_reduce": lambda: hvd.allreduce(t, op=hvd.Sum),
                    "reduce_scatter": lambda: hvd.reducescatter(t, op=hvd.Sum),
                    "all_gather": lambda: hvd.allgather(t)}[op]
            call()  # a first call makes the communicator's buffers
            sync()
            ms = []
            for _ in range(TUNE_FIT_CALLS):
                if on_card:
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    ms.append((a, b))
                else:
                    call()
            sync()
            device_ms[f"{op}|{nbytes}"] = (sorted(a.elapsed_time(b) for a, b in ms)
                                           [len(ms) // 2] if ms else None)
    cells = fit.observed_cells()
    fp = fit.refresh(force=True)
    rec["fit"] = {
        "cells": [[c.collective, c.axis_size, c.mean_nbytes, c.p50_s * 1e3, c.count]
                  for c in cells],
        "device_ms": device_ms,
        "fitted": None if fp is None else {**fp.as_dict(), "fields": list(fp.fitted_fields),
                                           "n_cells": fp.n_cells},
        "static": [getattr(topo_model.current(), f) for f in (
            "phase_overhead_s", "ici_latency_s", "dcn_latency_s", "ici_gbps", "dcn_gbps")],
    }
    os.environ.pop("HVD_TPU_TOPO_FIT")
    if len(cells) != 3 * len(sizes):
        problems.append(f"the fit saw {len(cells)} cells, want {3 * len(sizes)}")

    # 5. metric_average over the world and over {0, 1}.
    os.environ["HVD_TPU_DYNAMIC_PROCESS_SETS"] = "1"
    pair = hvd.add_process_set(hvd.ProcessSet([0, 1]))
    value = {"a": rank + 1.0, "b": [2.0 ** -rank]}
    rec["avg_world"] = metrics.metric_average(value)
    rec["avg_pair"] = metrics.metric_average(value, pair)
    want_world = {"a": float(np.mean([r + 1.0 for r in range(n)])),
                  "b": [float(np.mean([2.0 ** -r for r in range(n)]))]}
    want_pair = ({"a": 1.5, "b": [0.75]} if rank in (0, 1) else value)
    if rec["avg_world"] != want_world or rec["avg_pair"] != want_pair:
        problems.append(f"metric_average: world {rec['avg_world']} (want {want_world}), "
                        f"pair {rec['avg_pair']} (want {want_pair})")
    every = [None] * n
    dist.all_gather_object(every, rec["avg_pair"])
    rec["avg_pair_by_rank"] = every
    hvd.remove_process_set(pair)
    os.environ.pop("HVD_TPU_DYNAMIC_PROCESS_SETS")
    rec["problems"] = problems
    return rec


def print_tune_world(rec, card) -> None:
    """The lines of the four-rank slice tune (rank 0's record)."""
    for r in rec["runs"]:
        fz = r["frozen"]
        print(f"phase slice tune world: {rec['layout']}; native core built "
              f"{rec['native']}; autotuned ResNet-50 with the int8 probe "
              f"(HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED=1, BAYES_OPT_MAX_SAMPLES {r['samples']}): "
              f"windows {fmt_tune_windows(r['windows'])}; frozen threshold {fz[0]} B, "
              f"lowering {'hier' if fz[1] else 'flat'}, wire {'int8' if fz[2] else 'fp'}; the "
              f"int8 probe ran {r['int8_calls']} calls, per replay {r['int8_launches']} (= "
              f"expected: B6/B7 once per ring bucket, B3 twice and B4, B5 once per bucket "
              f"past the ring's cap); every rank followed rank 0's windows and froze its "
              f"variant: {r['ranks_agree']}; replicas bitwise after convergence, "
              f"{r['graphs_after']} graph held; on {card}", flush=True)
    print(f"phase slice tune world: kernels the int8 probes launched: "
          f"{rec['int8_kernels']}", flush=True)
    h = rec["hier"]
    ms = (f"; ms per call (host clock, synchronized): sum hier {h['sum_ms']:.3f} flat "
          f"{h['sum_flat_ms']:.3f}, avg hier {h['avg_ms']:.3f} flat {h['avg_flat_ms']:.3f} "
          f"on {card}" if h.get("sum_ms") is not None else "")
    print(f"phase slice tune world: HVD_TPU_HIERARCHICAL_ALLREDUCE=1 on the grid "
          f"{h['grid'][0]} (HVD_TPU_TOPO={TOPO_SPEC}): Sum and Average of {h['elems']} "
          f"dyadic float32 elements bitwise with flat{ms}", flush=True)
    f = rec["fit"]
    cells = "; ".join(
        f"{c[0]} {int(c[2])} B: dispatch p50 {c[3]:.4f} ms, device "
        + (f"{f['device_ms'][c[0] + '|' + str(int(c[2]))]:.4f} ms"
           if f["device_ms"].get(c[0] + "|" + str(int(c[2]))) is not None else "not measured")
        for c in f["cells"])
    fitted = ("none (not solvable)" if f["fitted"] is None else
              ", ".join(f"{k} {v:.4g}" for k, v in f["fitted"].items()
                        if k not in ("fields", "n_cells"))
              + f" (fitted {f['fitted']['fields']} from {f['fitted']['n_cells']} cells)")
    print(f"phase slice tune world: measured cost model (HVD_TPU_TOPO_FIT=1, flat world "
          f"of 4; unset, the fit prices: {rec['fit_default']}): {cells}; "
          f"fit.refresh(force=True): {fitted}; static {f['static']} on {card}", flush=True)
    print(f"phase slice tune world: fault plan topo.dcn_phase:slow:rank=1,"
          f"secs={TUNE_FAULT_SECS} on every rank: capture_blocker: {rec['fault_blocker']}; "
          f"the step ran eagerly; fired per rank {rec['fault_fired_by_rank']}; one "
          f"hierarchical call's host ms per rank (no synchronize) "
          f"{[round(v, 2) for v in rec['fault_host_ms_by_rank']]}", flush=True)
    print(f"phase slice tune world: metric_average over the world {rec['avg_world']}, "
          f"over {{0, 1}} per rank {rec['avg_pair_by_rank']}", flush=True)
    print(f"phase slice tune world: {rec['wall_s']:.0f} s with start-up", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement here as JSON")
    ap.add_argument("--only", choices=["ring", "kernel", "sets", "hybrid", "moe", "pipeline",
                                       "fsdp", "remat", "topo", "tune"],
                    help="ring: only the phases that need more than one card; "
                         "kernel: only the kernels against their plain versions; "
                         "sets, hybrid, moe, pipeline, fsdp, remat, topo, tune: only that "
                         "phase (remat: phase slice gpt's remat runs; tune: at world one "
                         "on one card, its four-rank world on four)")
    for name, kind in (("rank", int), ("size", int), ("backend", str), ("store", str),
                       ("out", str)):
        for worker in ("ring", "sets", "hybrid", "mesh"):
            ap.add_argument(f"--{worker}-{name}", type=kind, help=argparse.SUPPRESS)
    ap.add_argument("--sets-batch", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--hybrid-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-kind", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ring_rank is not None:
        ring_worker(args)
        return
    if args.sets_rank is not None:
        sets_worker(args)
        return
    if args.hybrid_rank is not None:
        hybrid_worker(args)
        return
    if args.mesh_rank is not None:
        mesh_worker(args)
        return

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "horovod_tpu_torch")):
        fail(f"horovod_tpu_torch/ not found beside {__file__}: run from a checkout")
    sys.path.insert(0, root)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as tresnet
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import build, flash, kernels, peer
    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.ops import ring_kernels as rk
    from horovod_tpu_torch.sched.plan import SchedConfig, build_schedule, dtype_name
    from horovod_tpu_torch.utils.benchmarks import (
        build_dp_step,
        build_lm_step,
        packed_lm_batch,
        timed_throughput,
    )

    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"phase device: {kind} x{count}; card: {card}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    log = {"card": card, "kind": kind, "kernel_cases": []}
    # Every phase pins HVD_TPU_ONESTEP: eager (off) but for phase slice
    # onestep and its counterpart in slice ring.
    os.environ["HVD_TPU_ONESTEP"] = "off"

    # Phase 2: build every kernel of the path, one nvcc per source.
    t0 = time.perf_counter()
    build.build(SOURCES)
    build_s = time.perf_counter() - t0
    for name in SOURCES:
        ptxas = " | ".join(
            line.strip() for line in build.build_logs.get(name, "").splitlines()
            if "registers" in line or "spill" in line or "C75" in line
        )
        print(f"phase build: {name}.cu; ptxas: {ptxas or 'cached'}", flush=True)
    smem = {d: flash.sm90_smem_bytes(d) for d in flash.WGMMA_HEAD_DIMS}
    print(f"phase build: flash_attn_sm90.cu: dynamic shared memory per block "
          f"{smem} bytes (D: bytes), one block per SM", flush=True)
    print(f"phase build: {len(SOURCES)} sources in {build_s:.1f} s", flush=True)
    log["build_s"] = build_s

    # Phase 3: every kernel against its plain version at the slice's sizes.
    meta = tresnet.ResNet50(num_classes=1000, device="meta")
    params = [p for p in meta.parameters()]
    planned = build_schedule(
        [p.numel() * 4 for p in params], [dtype_name(torch.float32)] * len(params),
        SchedConfig(wire="bf16"),
    )
    sizes = [b.nbytes // 4 for b in planned.buckets]
    padded = [-(-v // BLOCK) * BLOCK for v in sizes]
    ring_plan = build_schedule(
        [p.numel() * 4 for p in params], [dtype_name(torch.float32)] * len(params),
        SchedConfig(wire="int8", bucket_bytes=RING_THRESHOLD),
    )
    ring_sizes = [b.nbytes // 4 for b in ring_plan.buckets]
    print(f"phase kernel: ResNet-50 buckets (elements): {sizes}; padded to the "
          f"int8 block: {padded}; at the ring's 32 MiB threshold: {ring_sizes}",
          flush=True)
    counters = {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
                "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
                "rs_ring": rk.rs_ring, "ag_ring": rk.ag_ring,
                "flash_fwd": flash.flash_forward,
                "flash_fwd_wgmma": flash.flash_forward_wgmma,
                "flash_fwd_mma": flash.flash_forward_mma}
    if args.only == "tune":
        if count >= MESH_WORLD:
            mesh_phases(card, count, log, ["tune"])
        else:
            tune_phase(hvd, tresnet, counters, card, log)
        finish(args, log, card, kind, count, [])
        return
    if args.only in ("ring", "sets", "hybrid", "moe", "pipeline", "fsdp", "remat", "topo"):
        if args.only == "ring":
            ring_slice_phase(card, count, log)
        if args.only in ("ring", "sets"):
            sets_slice_phase(card, count, log)
        if args.only == "ring" and count >= 2:
            gpt_world_phase(root, count, card, log)
        if args.only in ("ring", "hybrid"):
            hybrid_slice_phase(card, count, log)
        if args.only == "remat":
            g = torch.Generator(device="cuda").manual_seed(2)
            remat_phase(hvd, tt, build_lm_step, counters, torch.randint(
                0, GPT_VOCAB, (GPT_BATCH, GPT_SEQ), generator=g, device="cuda"), card, log)
        if args.only == "moe":
            moe_phase(hvd, tt, build_lm_step, counters, card, log)
        mesh_phases(card, count, log, [k for k in ("moe", "pipeline", "fsdp", "topo")
                                       if args.only in ("ring", k)])
        finish(args, log, card, kind, count, [])
        return
    record = kernel_phase(kernels, sizes, log)
    qrecords = quant_kernel_phase(qk, padded, log)
    rrecords = ring_kernel_phase(rk, peer, qk, ring_sizes, log)
    tok_np, seg_np = packed_lm_batch(GPT_BATCH, GPT_SEQ, GPT_VOCAB)
    packed_batch = (torch.from_numpy(tok_np).cuda(), torch.from_numpy(seg_np).cuda())
    frecord = flash_phase(flash, packed_batch[1], log)
    if args.only == "kernel":
        finish(args, log, card, kind, count, [])
        return

    # Phases 4 and 5: the slice on each wire, through the entry points a
    # user calls; the counts are set to 0 before each run.
    runs = {}
    for wire, warmup, timed in (("bf16", WARMUP, TIMED), ("int8", WARMUP, TIMED),
                                ("fp8", FP8_WARMUP, FP8_TIMED)):
        runs[wire] = slice_phase(hvd, tresnet, build_dp_step, timed_throughput,
                                 kernels, qk, rk, wire, warmup, timed, card)
        torch.cuda.empty_cache()
    first_bf16, first_int8 = runs["bf16"]["losses"][0], runs["int8"]["losses"][0]
    if abs(first_int8 - first_bf16) > 1e-5 * abs(first_bf16):
        fail(f"int8 run's first loss {first_int8} != bf16 run's {first_bf16}")
    for wire in ("int8", "fp8"):
        if not runs[wire]["residual_l1"]:
            fail(f"{wire}: the error-feedback residuals are zero after the steps")
        if sorted(runs[wire]["buckets"]) != sorted(sizes):
            fail(f"{wire}: buckets {runs[wire]['buckets']} != planned {sizes}")
    log["slices"] = runs
    overlap_phase(hvd, tresnet, build_dp_step, timed_throughput,
                  {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
                   "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
                   "rs_ring": rk.rs_ring, "ag_ring": rk.ag_ring}, card, log)
    torch.cuda.empty_cache()
    onestep_phase(hvd, tresnet, build_dp_step, timed_throughput,
                  {"scale_cast": kernels.scale_cast, "quant_pack": qk.quant_packed,
                   "dequant_accum": qk.dequant_accum, "dequant_rows": qk.dequant_rows,
                   "rs_ring": rk.rs_ring, "ag_ring": rk.ag_ring}, card, log)
    torch.cuda.empty_cache()

    log["reference"] = [reference_phase(hvd, tresnet, build_dp_step, w)
                        for w in ("bf16", "int8")]
    torch.cuda.empty_cache()
    eager_phase(hvd, card, log)
    ring_run = ring_slice_phase(card, count, log)
    sets_slice_phase(card, count, log)

    # Phase 7: the GPT slice, dense then packed rows; every count is set
    # to 0 just before each run.
    g = torch.Generator(device="cuda").manual_seed(2)
    dense_batch = torch.randint(0, GPT_VOCAB, (GPT_BATCH, GPT_SEQ), generator=g,
                                device="cuda")
    gpt_runs = {}
    for packed, batch, warmup, timed in ((False, dense_batch, WARMUP, TIMED),
                                         (True, packed_batch, PACKED_WARMUP,
                                          PACKED_TIMED)):
        torch.cuda.empty_cache()
        what = "packed" if packed else "dense"
        gpt_runs[what] = gpt_phase(
            hvd, tt, build_lm_step, timed_throughput, counters, batch, packed,
            warmup, timed, card)
        torch.cuda.empty_cache()
        gpt_runs[what + "_captured"] = gpt_onestep_phase(
            hvd, tt, build_lm_step, counters, batch, packed, warmup + timed,
            gpt_runs[what], card)
    log["gpt"] = gpt_runs
    torch.cuda.empty_cache()
    remat = remat_phase(hvd, tt, build_lm_step, counters, dense_batch, card, log)
    hybrid = hybrid_slice_phase(card, count, log)
    moe = moe_phase(hvd, tt, build_lm_step, counters, card, log)
    meshes = mesh_phases(card, count, log, ["moe", "pipeline", "fsdp", "topo"])
    log["reference_gpt"] = reference_gpt_phase(hvd, tt, build_lm_step)
    torch.cuda.empty_cache()
    log["examples"] = examples_phase(root, card)
    torch.cuda.empty_cache()
    tune = tune_phase(hvd, tresnet, counters, card, log)

    log["paths"] = path_launches(runs, ring_run, gpt_runs, remat, hybrid, moe, meshes, tune)
    entries = [("scale_cast", "scale_cast.cu", record, runs["bf16"])]
    entries += [(k, "quant.cu", qrecords[k], runs["int8"])
                for k in ("quant_pack", "dequant_accum", "dequant_rows")]
    entries.append(("flash_fwd", "flash_attn_sm90.cu", frecord, gpt_runs["dense"]))
    entries += [(k, "quant_ring.cu", rrecords[k], ring_run) for k in ("rs_ring", "ag_ring")]
    finish(args, log, card, kind, count, entries)


def mesh_phases(card, count, log, kinds) -> dict:
    """Phase slice moe's meshes, slice pipeline and slice fsdp (those in
    ``kinds``), each in a world of ``MESH_WORLD`` ranks."""
    printers = {"moe": print_moe_meshes, "pipeline": print_pipeline, "fsdp": print_fsdp,
                "topo": print_topo, "tune": print_tune_world}
    out = {}
    for k in kinds:
        out[k] = world_phase(k, card, count)
        printers[k](out[k], card)
        log[f"{k}_world"] = out[k]
    return out


def path_launches(runs, ring_run, gpt_runs, remat, hybrid, moe, meshes, tune) -> dict:
    """Each kernel's launches on each path of the main run (rank 0 where
    the path has several ranks), the counts set to 0 before each."""
    paths = {}

    def put(label, launches):
        for name, v in launches.items():
            if v:
                paths.setdefault(name, {})[label] = v

    for wire, r in runs.items():
        put(f"resnet {wire}", r["launches"])
    put("resnet int8 ring", ring_run["launches"])
    for what, r in gpt_runs.items():
        put(f"gpt {what}", r["launches"])
    put("gpt remat", remat["runs"][0]["launches"])
    for kind, r in hybrid["runs"].items():
        put(f"hybrid {kind}", r["launches"])
    put("moe world 1", moe["eager"]["launches"])
    for kind, r in meshes["moe"]["runs"].items():
        put(f"moe {kind}", r["launches"])
    for key, what in (("remat0", ""), ("remat1", " remat_stage")):
        put(f"pipeline stage 0{what}", meshes["pipeline"]["stages"][0][key]["launches"])
    for kind, r in meshes["fsdp"]["runs"].items():
        put(f"fsdp {kind}", r["launches"])
    for label, r in meshes["topo"]["runs"].items():
        put(f"topo {label}", {k: v for k, v in r["off"]["launches"].items() if k != "fallback"})
    for wire, r in meshes["topo"]["hier"].items():
        put(f"topo hier {wire} (one call)",
            {k: v for k, v in r["launches"].items() if k != "fallback"})
    put("tune (autotuned bf16, to convergence)", tune["launches"])
    return paths


def finish(args, log, card, kind, count, entries) -> None:
    """The kernels line (one entry per kernel: its comparison record and
    the main-path run whose launches it reports; none with ``--only``),
    ``--out``, and the result line."""
    log["kernels"] = [{
        "name": name,
        "route": "cuda",
        "source": f"horovod_tpu_torch/csrc/{src}",
        "replaces": REPLACES[name],
        "launches": run["launches"][name],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "paced_ms": rec["paced_ms"],
        "host_ms": rec["host_ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec.get("bound_by", "bytes"),
        "library_ms": rec["library_ms"],
        "paths": log.get("paths", {}).get(name, {}),
    } for name, src, rec, run in entries]
    for k in log["kernels"]:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its main path")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)
    print(f"card: {card}")
    if log["kernels"]:
        print(json.dumps({"kernels": log["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
