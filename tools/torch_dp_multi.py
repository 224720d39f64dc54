#!/usr/bin/env python3
"""Run horovod_tpu_torch's data-parallel step in a world of N processes.

    python3 tools/torch_dp_multi.py --nproc 4                 # N GPUs, NCCL
    python3 tools/torch_dp_multi.py --nproc 4 --device cpu --tiny   # gloo
    python3 tools/torch_dp_multi.py --nproc 4 --wire int8     # + int8 wire
    python3 tools/torch_dp_multi.py --nproc 4 --wire int8 --backend fused \
        --fusion-threshold 33554432           # int8 on the NVLink ring

It starts ``--nproc`` worker processes of itself, joined through a
``FileStore`` in a temporary directory (no port is opened).  Every rank
builds the model from its own seed, so the step's broadcast of rank 0's
weights is what makes them equal; every rank trains on its own random
batch (batch 32 per rank, ResNet-50 at 224x224 in bf16, or with
``--tiny`` a small float32 ResNet at 32x32).  Each rank times windows of
``--steps`` steps with ``HVD_TPU_SCHED_WIRE`` set to ``bf16``, ``off``,
``off``, ``bf16`` in turn; with ``--wire int8`` (or ``fp8``) the windows
are ``int8``, ``bf16``, ``off``, ``off``, ``bf16``, ``int8``, and the
optimizer is built under the quantized wire, so it keeps error-feedback
residuals.  ``--backend`` sets ``HVD_TPU_QUANT_BACKEND`` (``phase``, or
``fused``, the default) and ``--fusion-threshold`` sets
``HVD_TPU_FUSION_THRESHOLD`` (bytes per bucket; at 33554432 every
bucket of ResNet-50 fits the ring's 8 MiB packed payload at a world of
four).  With ``--overlap-pairs N`` the windows are instead N pairs on
the one wire (``--wire``, else bf16), each bucket's exchange launched
from the backward and after it (``HVD_TPU_SCHED_BARRIERS`` on, off, off,
on, ...), and rank 0 also prints each side's median and quartiles.
With ``--onestep-pairs N`` they are N pairs with the step captured as one
CUDA graph and run eagerly (``HVD_TPU_ONESTEP`` on, off, off, on, ...;
the barriers off); a captured window's warm-up steps and its capture
are left out of its timing.  With ``--barrier-pairs N`` they are N pairs
of captured windows with each bucket's exchange launched from the
backward and after it (``HVD_TPU_SCHED_BARRIERS`` on, off, off, on,
...).  ``--profile-steps K`` then runs K captured steps on every rank
(bf16, the barriers off), rank 0 under ``torch.profiler``
(``tools/torch_profile_step.py`` ``profile_steps``: device busy and
idle share per step, device time by group).  With ``--process-set 0,1`` every rank
registers that set at ``init`` and builds two steps per wire, one whose
``DistributedOptimizer`` reduces over the set and one over the world
(from the same weights); each window label then runs on the set's step
and the world's in turns (set, world, world, set, ...), and the labels
gain ``@set`` and ``@world``.
Then it checks that:

* every rank holds bitwise the same weights and statistics afterwards
  (on the quantized wire every rank applies the same all-gathered
  dequant); on a set, the set's members hold bitwise the same weights,
  and on a quantized wire so does each group the set tiles the world
  into (non-members of a set on a dense wire keep their own);
* on the GPU, each window launched exactly the kernels its wire implies,
  per bucket per step: bf16, B1 twice (the down-cast and the up-cast),
  three times above a world of one (the 1/size postscale of the bf16
  sum runs through B1 as well); int8/fp8, above a world of one B1 once
  (the 1/size postscale of the reduced shard), and on the fused backend
  B6 and B7 once (the ring) for every bucket whose packed payload fits
  the ring, or else B3 twice (reduce-scatter and all-gather), B4 and B5
  once (the NCCL lowering, also the phase backend's); off, none; on a
  set, a non-member launches nothing on bf16, and every rank takes the
  NCCL lowering on a quantized wire (groups never take the ring:
  ``quant.fused_fallback`` counts both collectives of every bucket);
* ``quant.fused_fallback`` counts exactly the fused collectives that
  could not take the ring (none at ``--fusion-threshold 33554432``).

Rank 0 prints one JSON line with the world size, the card, the step
times per wire and the images per second of the whole world.  The exit
code is non-zero if any rank failed.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import ResNet, ResNet50
    from horovod_tpu_torch.ops import kernels, peer
    from horovod_tpu_torch.ops import quant_kernels as qk
    from horovod_tpu_torch.ops import ring_kernels as rk
    from horovod_tpu_torch.utils.benchmarks import (
        build_dp_step, quartiles, timed_window, window_labels)

    torch.set_num_threads(2)
    if args.backend:
        os.environ["HVD_TPU_QUANT_BACKEND"] = args.backend
    if args.fusion_threshold:
        os.environ["HVD_TPU_FUSION_THRESHOLD"] = str(args.fusion_threshold)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    members = ([int(r) for r in args.process_set.split(",")]
               if args.process_set else None)
    hvd.init(args.device, init_method=f"file://{args.store}",
             rank=args.rank, size=args.nproc,
             process_sets=[hvd.ProcessSet(members)] if members else None)
    try:
        dev = hvd.device()

        def make_model():
            if args.tiny:
                return ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                              dtype=torch.float32, seed=args.rank, device=dev)
            return ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            seed=args.rank, device=dev)

        shape, classes = ((32, 32, 32, 3), 10) if args.tiny else ((32, 224, 224, 3), 1000)
        wires = window_labels(args.wire, args.overlap_pairs, args.onestep_pairs)
        if args.barrier_pairs:
            wire = args.wire or "bf16"
            wires = tuple(f"{wire}/{m}" for _ in range(-(-args.barrier_pairs // 2))
                          for m in ("captured+barriers", "captured", "captured",
                                    "captured+barriers"))
        pset = None
        if members:
            pset = hvd.global_process_set() if len(members) == args.nproc else [
                ps for ps in (hvd.runtime.get_runtime().process_set_table.get(i)
                              for i in hvd.get_process_set_ids())
                if list(ps.ranks) == sorted(members)][0]
        # The wire at construction decides whether the optimizer keeps
        # error-feedback residuals: with a set, one pair of steps (the
        # set's, the world's) per wire, each built under its wire.
        steps = {}
        for wire in dict.fromkeys(w.split("/")[0] for w in wires):
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            for where in (("set", "world") if members else (None,)):
                model = make_model()
                steps[(wire, where)] = (model,) + build_dp_step(
                    hvd, model, process_set=pset if where == "set" else None)
        g = torch.Generator(device=dev).manual_seed(100 + args.rank)
        batch = (torch.rand(*shape, generator=g, device=dev),
                 torch.randint(0, classes, (shape[0],), generator=g, device=dev))
        counters = {"B1": kernels.scale_cast, "B3": qk.quant_packed,
                    "B4": qk.dequant_accum, "B5": qk.dequant_rows,
                    "B6": rk.rs_ring, "B7": rk.ag_ring}
        fused = (args.backend or "fused") == "fused"

        def window(label: str, step):
            """One window of ``label`` (``window_labels``): step ms, the
            timed steps' launches and the last loss."""
            before = {}

            def snapshot():
                before.update({k: c.launches for k, c in counters.items()})
                before["fallback"] = metrics.get_counter("quant.fused_fallback")

            seconds, last = timed_window(step, batch, label, args.steps, snapshot)
            ms = seconds / args.steps * 1e3
            counts = {k: c.launches - before[k] for k, c in counters.items()}
            counts["fallback"] = (metrics.get_counter("quant.fused_fallback")
                                  - before["fallback"])
            return ms, counts, last

        def fits_ring(bucket) -> bool:
            n, v = args.nproc, bucket.nbytes // 4
            c = -(-v // (n * 512)) * 512
            return n > 1 and n * (c + 4 * (c // 512)) <= peer.CAP

        def expected(label: str, opt, on_set: bool) -> dict:
            wire = label.split("/")[0]
            total = dict.fromkeys(list(counters) + ["fallback"], 0)
            quantized = wire in ("int8", "fp8")
            # The ranks this rank reduces with: its tile of the set on a
            # quantized wire, the set's members (none for a non-member) on
            # a dense one, else the world.
            n = args.nproc
            if on_set:
                n = len(members)
                if not quantized and args.rank not in members:
                    n = 0
            for bucket in opt.schedule.buckets:
                per = dict.fromkeys(total, 0)
                ring = (quantized and fused and dev.type == "cuda" and not on_set
                        and fits_ring(bucket))
                # A replay runs no Python, so a captured window counts none.
                captured = label.split("/")[-1].startswith("captured")
                if (fused and quantized and not ring and (dev.type == "cuda" or n == 1)
                        and not (captured and dev.type == "cuda")):
                    per["fallback"] = 2  # the reduce-scatter and the all-gather
                if dev.type == "cuda":
                    above_one = int(n > 1)
                    if wire == "bf16" and n:
                        per["B1"] = 2 + above_one
                    elif ring:
                        per.update(B1=above_one, B6=1, B7=1)
                    elif quantized:
                        per.update(B1=above_one, B3=2, B4=1, B5=1)
                for k, v in per.items():
                    total[k] += v * args.steps
            return total

        runs = [(w, where) for i, w in enumerate(wires)
                for where in ((("set", "world") if i % 2 == 0 else ("world", "set"))
                              if members else (None,))]
        timing = {w if where is None else f"{w}@{where}": [] for w, where in runs}
        losses = []
        for wire, where in runs:
            model, step, opt = steps[(wire.split("/")[0], where)]
            ms, launches, loss = window(wire, step)
            label = wire if where is None else f"{wire}@{where}"
            timing[label].append(ms)
            losses.append(loss)
            want = expected(wire, opt, where == "set")
            if launches != want:
                raise SystemExit(f"rank {args.rank}: launches {launches} in a "
                                 f"{label} window, expected {want}")
        for (wire, where), (model, _, _) in steps.items():
            state = torch.cat([t.detach().float().reshape(-1).cpu()
                               for t in model.state_dict().values()])
            digest = [float(state.double().sum()), float(state.double().abs().sum()),
                      state.numel()]
            digests = [None] * args.nproc
            dist.all_gather_object(digests, digest)
            groups = [list(range(args.nproc))]
            if where == "set":
                groups = (hvd.runtime.get_runtime().process_set_table
                          .partition_groups(pset) or [sorted(members)])
                if wire not in ("int8", "fp8"):
                    groups = groups[:1]
            for grp in groups:
                if any(digests[r] != digests[grp[0]] for r in grp):
                    raise SystemExit(f"{wire} {where or ''}: ranks {grp} hold different "
                                     f"weights: {digests}")
        card = "cpu"
        if dev.type == "cuda":
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            ).stdout.strip().splitlines()[0]
        profiled = None
        if args.profile_steps and dev.type == "cuda":
            profiled = profile_world(args, steps, batch, card)
        if args.rank == 0:
            imgs = shape[0] * args.nproc
            spread = {w: quartiles(v) for w, v in timing.items()}
            print(json.dumps({
                "world": args.nproc, "device": dev.type, "card": card,
                "model": "tiny" if args.tiny else "resnet50",
                "batch_per_rank": shape[0],
                "buckets": [b.nbytes for b in opt.schedule.buckets],
                "residuals": opt.residuals is not None,
                "process_set": members,
                "quant_backend": args.backend or "fused",
                "fusion_threshold": args.fusion_threshold,
                "step_ms": timing, "step_ms_quartiles": spread,
                "img_s": {w: [imgs / ms * 1e3 for ms in v] for w, v in timing.items()},
                "losses": losses,
                "profiled": profiled,
                "weights_equal": ("on every rank" if not members else
                                  "on the set's members (and, quantized, within "
                                  "each tile)"),
            }), flush=True)
    finally:
        hvd.shutdown()


def profile_world(args, steps, batch, card):
    """``--profile-steps``: the bf16 step captured on every rank (its
    warm-up steps and capture first), then K steps, rank 0's under
    ``torch.profiler``.  Rank 0's profile record (None elsewhere)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_profile_step import profile_steps

    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP
    from horovod_tpu_torch.utils.benchmarks import select_window

    select_window("bf16/captured")
    step = steps[("bf16", None)][1] if ("bf16", None) in steps else next(iter(steps.values()))[1]
    for _ in range(CAPTURE_WARMUP + 1):
        float(step(batch))
    if args.rank == 0:
        return profile_steps(step, batch, args.profile_steps, "bf16/captured", card)
    for _ in range(args.profile_steps + 1):  # profile_steps runs one more first
        float(step(batch))
    torch.cuda.synchronize()
    return None


def launch(args) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        cmd = [sys.executable, os.path.abspath(__file__), "--nproc",
               str(args.nproc), "--device", args.device, "--steps",
               str(args.steps), "--store", store]
        if args.tiny:
            cmd.append("--tiny")
        if args.wire:
            cmd += ["--wire", args.wire]
        if args.backend:
            cmd += ["--backend", args.backend]
        if args.fusion_threshold:
            cmd += ["--fusion-threshold", str(args.fusion_threshold)]
        if args.overlap_pairs:
            cmd += ["--overlap-pairs", str(args.overlap_pairs)]
        if args.onestep_pairs:
            cmd += ["--onestep-pairs", str(args.onestep_pairs)]
        if args.barrier_pairs:
            cmd += ["--barrier-pairs", str(args.barrier_pairs)]
        if args.profile_steps:
            cmd += ["--profile-steps", str(args.profile_steps)]
        if args.process_set:
            cmd += ["--process-set", args.process_set]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
                 for r in range(args.nproc)]
        try:
            rcs = [p.wait(timeout=args.timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(abs(rc) for rc in rcs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="small float32 ResNet at 32x32 (a rehearsal on the CPU)")
    ap.add_argument("--wire", choices=["int8", "fp8"],
                    help="also time windows on this quantized wire")
    ap.add_argument("--backend", choices=["phase", "fused"],
                    help="HVD_TPU_QUANT_BACKEND of the quantized windows (default fused)")
    ap.add_argument("--fusion-threshold", type=int,
                    help="HVD_TPU_FUSION_THRESHOLD, bytes per bucket")
    ap.add_argument("--overlap-pairs", type=int, default=0,
                    help="time this many pairs of windows with the exchange "
                    "launched from the backward and after it")
    ap.add_argument("--onestep-pairs", type=int, default=0,
                    help="time this many pairs of windows with the step "
                    "captured as one CUDA graph and run eagerly")
    ap.add_argument("--barrier-pairs", type=int, default=0,
                    help="time this many pairs of captured windows with the "
                    "exchange launched from the backward and after it")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="then profile this many captured bf16 steps on rank 0")
    ap.add_argument("--process-set",
                    help="ranks of a process set, e.g. 0,1: time each window on a "
                    "step reduced over the set and on one over the world, in turns")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is None:
        sys.exit(launch(args))
    worker(args)


if __name__ == "__main__":
    main()
