#!/usr/bin/env python3
"""Run horovod_tpu_torch's GPT step (``build_lm_step``) in a world of N processes.

    python3 tools/torch_lm_multi.py --nproc 4                    # N GPUs, NCCL
    python3 tools/torch_lm_multi.py --nproc 4 --device cpu --tiny  # gloo rehearsal
    python3 tools/torch_lm_multi.py --nproc 1 --pairs 3          # world of one

It starts ``--nproc`` worker processes of itself, joined through a
``FileStore`` in a temporary directory (no port is opened).  Every rank
builds GPT-2 small (``bench_gpt``'s widths: vocab 50304, 12 layers,
width 768, 12 heads x 64, seq 1024; bf16 compute) from its own seed, so
the step's broadcast of rank 0's weights is what makes them equal, and
trains on its own random batch (``--batch`` rows per rank, 16 by
default) with AdamW and ``Compression.bf16``, on dense rows and on
packed rows (``packed_lm_batch``).  ``--tiny`` takes ``gpt_tiny``
(float32) at 128 positions instead, to rehearse on the CPU.

For each row kind it first runs ``--check-steps`` steps eagerly
(``HVD_TPU_ONESTEP=off``) and the same steps from the same weights
captured (``on``: two eager warm-up steps on a side stream, a capture,
replays), and checks that

* the two runs' losses and every rank's weights are bitwise equal (on
  a card; on the CPU both run eagerly), with one capture per run;
* each step launched kernel B2 exactly once per layer (12 times; the
  wgmma route) and, above a world of one, kernel B1 once per bucket (the
  1/size postscale of the bf16 sum), and nothing else, replays included.

Then it times ``--pairs`` pairs of windows of ``--steps`` steps, the
step captured and eager in turns (captured, eager, eager, captured,
...; a captured window's warm-up steps and capture are left out of its
time).  Rank 0 prints one JSON line with the world, the card, the step
ms and tokens per second of the whole world per window, their medians,
the checks' results and, with ``--profile-steps K``, rank 0's profile of
K captured steps per row kind (device busy and idle share).  The exit code is non-zero if any rank failed.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(model) -> list:
    """Exact fingerprint of the weights: float64 sums of the bits as
    floats, and of their absolute values."""
    import torch

    flat = torch.cat([p.detach().float().reshape(-1).cpu() for p in model.parameters()])
    bits = flat.view(torch.int32).double()
    return [float(bits.sum()), float(flat.double().abs().sum()), flat.numel()]


def worker(args) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import flash, kernels
    from horovod_tpu_torch.utils.benchmarks import (
        build_lm_step, packed_lm_batch, quartiles, timed_window)

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["HVD_TPU_SCHED_WIRE"] = "off"  # bench_gpt: Compression.bf16 only
    hvd.init(args.device, init_method=f"file://{args.store}", rank=args.rank,
             size=args.nproc)
    try:
        dev = hvd.device()
        on_card = dev.type == "cuda"
        seq = 128 if args.tiny else 1024
        vocab = 256 if args.tiny else 50304

        def make_model():
            build = tt.gpt_tiny if args.tiny else tt.gpt_small
            return build(seed=args.rank, device=dev)

        g = torch.Generator(device=dev).manual_seed(200 + args.rank)
        dense = torch.randint(0, vocab, (args.batch, seq), generator=g, device=dev)
        toks, segs = packed_lm_batch(args.batch, seq, vocab, seed=3 + args.rank)
        packed = (torch.from_numpy(toks).to(dev), torch.from_numpy(segs).to(dev))
        counters = {"B1": kernels.scale_cast, "B2": flash.flash_forward}
        out = {"world": args.nproc, "device": dev.type, "batch_per_rank": args.batch,
               "seq": seq, "model": "gpt_tiny" if args.tiny else "gpt_small",
               "checks": {}, "step_ms": {}, "tokens_s": {}}
        for kind, batch in (("dense", dense), ("packed", packed)):
            runs = {}
            for mode in ("off", "on"):
                os.environ["HVD_TPU_ONESTEP"] = mode
                model = make_model()
                step, opt = build_lm_step(hvd, model, packed=kind == "packed")
                for c in counters.values():
                    c.launches = 0
                metrics.reset("xir.")
                losses = [float(step(batch)) for _ in range(args.check_steps)]
                nb = len(opt.schedule.buckets)
                launches = {k: c.launches for k, c in counters.items()}
                want = {"B1": nb * args.check_steps * int(args.nproc > 1),
                        "B2": model.cfg.num_layers * args.check_steps}
                if not on_card:  # the plain versions launch nothing
                    want = {"B1": 0, "B2": 0}
                if launches != want:
                    raise SystemExit(f"rank {args.rank}: {kind} {mode}: launches "
                                     f"{launches}, expected {want}")
                captures = metrics.get_counter("xir.onestep.steps")
                if captures != int(mode == "on" and on_card):
                    raise SystemExit(f"rank {args.rank}: {kind} {mode}: {captures} captures")
                digests = [None] * args.nproc
                dist.all_gather_object(digests, digest(model))
                if any(d != digests[0] for d in digests):
                    raise SystemExit(f"{kind} {mode}: ranks hold different weights")
                runs[mode] = {"losses": losses, "digest": digests[0], "buckets": nb,
                              "launches": launches}
                del model, step, opt
                if on_card:
                    torch.cuda.empty_cache()
            if runs["off"]["losses"] != runs["on"]["losses"] or (
                    runs["off"]["digest"] != runs["on"]["digest"]):
                raise SystemExit(f"rank {args.rank}: {kind}: captured and eager differ: "
                                 f"{runs}")
            out["checks"][kind] = runs["on"]
            # Windows, captured against eager in turns, on one step.
            model = make_model()
            step, _ = build_lm_step(hvd, model, packed=kind == "packed")
            tokens = args.batch * seq * args.nproc
            for i in range(args.pairs):
                for mode in (("captured", "eager") if i % 2 == 0 else ("eager", "captured")):
                    seconds, _ = timed_window(step, batch, f"off/{mode}", args.steps)
                    label = f"{kind}/{mode}"
                    ms = seconds / args.steps * 1e3
                    out["step_ms"].setdefault(label, []).append(ms)
                    out["tokens_s"].setdefault(label, []).append(tokens / ms * 1e3)
            if args.profile_steps and on_card:
                out.setdefault("profiled", {})[kind] = profile_captured(
                    args, step, batch, kind)
            del model, step
            os.environ["HVD_TPU_ONESTEP"] = "off"
            if on_card:
                torch.cuda.empty_cache()
        if args.rank == 0:
            card = "cpu"
            if on_card:
                card = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=60,
                ).stdout.strip().splitlines()[0]
            out["card"] = card
            out["median_step_ms"] = {k: quartiles(v)[1] for k, v in out["step_ms"].items()}
            out["median_tokens_s"] = {k: quartiles(v)[1] for k, v in out["tokens_s"].items()}
            out["weights_equal"] = "on every rank, eager and captured bitwise"
            print(json.dumps(out), flush=True)
    finally:
        hvd.shutdown()


def profile_captured(args, step, batch, kind):
    """``--profile-steps``: K captured steps on every rank (the capture
    made first), rank 0's under ``torch.profiler``
    (``tools/torch_profile_step.py`` ``profile_steps``: device busy and
    idle share per step, device time by group).  Rank 0's record."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_profile_step import profile_steps

    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP
    from horovod_tpu_torch.utils.benchmarks import select_window

    select_window("off/captured")
    for _ in range(CAPTURE_WARMUP + 1):
        float(step(batch))
    if args.rank == 0:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        return profile_steps(step, batch, args.profile_steps,
                             f"GPT {kind} captured, world {args.nproc}", card)
    for _ in range(args.profile_steps + 1):  # profile_steps runs one more first
        float(step(batch))
    torch.cuda.synchronize()
    return None


def launch(args) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--nproc", str(args.nproc),
               "--device", args.device, "--steps", str(args.steps), "--pairs",
               str(args.pairs), "--batch", str(args.batch), "--check-steps",
               str(args.check_steps), "--profile-steps", str(args.profile_steps),
               "--store", os.path.join(tmp, "store")]
        if args.tiny:
            cmd.append("--tiny")
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
                    help="gpt_tiny (float32, 128 positions): a rehearsal on the CPU")
    ap.add_argument("--batch", type=int, default=16, help="rows per rank")
    ap.add_argument("--check-steps", type=int, default=5,
                    help="steps of the eager and captured runs compared bitwise")
    ap.add_argument("--pairs", type=int, default=2,
                    help="pairs of windows, captured and eager in turns")
    ap.add_argument("--steps", type=int, default=10, help="timed steps per window")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="then profile this many captured steps per row kind "
                    "on rank 0 (a card only)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is None:
        sys.exit(launch(args))
    worker(args)


if __name__ == "__main__":
    main()
