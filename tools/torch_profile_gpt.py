#!/usr/bin/env python3
"""Where the device time of horovod_tpu_torch's GPT-2-small step goes.

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    python3 tools/torch_profile_gpt.py [--steps 3] [--packed] [--attn full]
                                       [--out PATH]

It builds the step ``chip_smoke.py`` drives (GPT-2 small at its
published widths, batch 16 x 1024 tokens, bf16 compute, world of one,
``build_lm_step`` with AdamW and ``Compression.bf16``), times two windows
of ``--window`` steps (host clock, each ending in a host read of the
loss), then profiles ``--steps`` steps with ``torch.profiler`` and
prints the device-busy time per step, the idle share of the window,
device time by group (B2, GEMM, elementwise and reductions, other) and
the kernels that take the most time.  ``--packed`` runs packed rows
(``packed_lm_batch``); ``--attn full`` runs the model with plain
softmax attention instead of B2.  It prints the loss of every step,
from the same weights and batch in every run.  Every line names the card
and its power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--window", type=int, default=5, help="steps per timing window")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--attn", choices=["flash", "full"], default="flash")
    ap.add_argument("--out", help="also write the results here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/torch_profile_gpt.py needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import gpt_small
    from horovod_tpu_torch.utils.benchmarks import build_lm_step, packed_lm_batch
    from torch_profile_step import group_of, union_us

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["HVD_TPU_SCHED_WIRE"] = "off"
    hvd.init("cuda")
    model = gpt_small(seed=0, device="cuda", attn_impl=args.attn)
    step, _ = build_lm_step(hvd, model, packed=args.packed)
    if args.packed:
        tok, seg = packed_lm_batch(16, 1024, 50304)
        batch = (torch.from_numpy(tok).cuda(), torch.from_numpy(seg).cuda())
    else:
        g = torch.Generator(device="cuda").manual_seed(2)
        batch = torch.randint(0, 50304, (16, 1024), generator=g, device="cuda")
    what = f"{'packed' if args.packed else 'dense'} rows, {args.attn} attention"

    losses = [float(step(batch))]  # warm up
    windows = []
    for _ in range(2):
        losses.append(float(step(batch)))
        t0 = time.perf_counter()
        timed = [step(batch) for _ in range(args.window)]
        losses += [float(v) for v in timed]
        windows.append((time.perf_counter() - t0) / args.window * 1e3)
    print(f"losses, {what}: {[round(v, 5) for v in losses]}", flush=True)
    print(f"step ms, {what}, windows of {args.window}: "
          f"{[round(v, 3) for v in windows]}; "
          f"{[round(16 * 1024 / v * 1e3) for v in windows]} tokens/s on {card}",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = step(batch)
        float(loss)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.events()
        if getattr(e, "device_type", None) is not None
        and str(e.device_type).endswith("CUDA")
        and e.time_range.end > e.time_range.start
    ]
    result = {"card": card, "run": what, "window_ms": windows, "steps": args.steps,
              "losses": losses}
    if not kernels:
        print(f"profiler: no device events; device time not measured on {card}")
    else:
        busy = union_us([(e.time_range.start, e.time_range.end) for e in kernels])
        by_group, by_name = {}, {}
        for e in kernels:
            dt = e.time_range.end - e.time_range.start
            by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + dt
            by_name[e.name] = by_name.get(e.name, 0.0) + dt
        total = sum(by_group.values())
        n = args.steps
        print(f"profiled {n} steps, {what}: wall {wall_us / n / 1e3:.3f} ms/step, device "
              f"busy {busy / n / 1e3:.3f} ms/step, idle share {1 - busy / wall_us:.1%}, "
              f"{len(kernels) / n:.0f} kernels/step on {card}", flush=True)
        for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"  {label:20s} {us / n / 1e3:8.3f} ms/step {us / total:6.1%}", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
        for name, us in top:
            print(f"  {us / n / 1e3:8.3f} ms/step  {name[:110]}", flush=True)
        result.update(
            wall_ms_per_step=wall_us / n / 1e3, busy_ms_per_step=busy / n / 1e3,
            idle_share=1 - busy / wall_us, kernels_per_step=len(kernels) / n,
            groups_ms_per_step={k: v / n / 1e3 for k, v in by_group.items()},
            top=[(k, v / n / 1e3) for k, v in top],
        )
    hvd.shutdown()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
