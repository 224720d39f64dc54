#!/usr/bin/env python3
"""Where the device time of horovod_tpu_torch's ResNet-50 step goes.

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    python3 tools/torch_profile_step.py [--steps 5] [--wire int8] [--out PATH]

It builds the step ``chip_smoke.py`` drives (ResNet-50, 224x224, batch 32
per GPU, bf16 compute, world of one, ``build_dp_step``), then:

1. times the step with ``HVD_TPU_SCHED_WIRE`` set to ``bf16``, ``off``,
   ``off``, ``bf16`` in turn (host clock, each window ending in a
   synchronise), so the wire's cost at world one is read in one process;
   with ``--wire int8`` (or ``fp8``) the windows are ``int8``, ``bf16``,
   ``off``, ``off``, ``bf16``, ``int8`` and the optimizer is built under
   the quantized wire, so it keeps error-feedback residuals;
2. profiles ``--steps`` steps on ``--wire`` (default bf16) with
   ``torch.profiler`` and prints the device-busy time per step, the idle
   share of the window, device time by group (B1, B3-B5, NCCL,
   convolution and GEMM, elementwise and reductions, other) and the
   kernels that take the most time.

Each timing window also reports the host time of the gradient exchange
(``DistributedOptimizer.synchronize``, which enqueues and returns; with
the exchange launched from the backward, only what is left after it).

``--overlap`` times the profiled wire with each bucket's exchange
launched from the backward and after it instead (``HVD_TPU_SCHED_BARRIERS``
on, off, off, on, ..., ``--pairs`` pairs), prints each side's median and
quartiles, and profiles both.  ``--onestep`` does the same with the step
captured as one CUDA graph and run eagerly (``HVD_TPU_ONESTEP`` on, off,
off, on, ...); a captured window's warm-up steps and its capture are left
out of its timing, and it has no exchange host time (the replay runs no
``synchronize``).

``--last-batch B`` instead times epochs of ``--window`` steps at batch 32
and one at batch B (the short last batch a loader gives with
``drop_last=False``) on the profiled wire, ``HVD_TPU_ONESTEP`` ``auto``
against ``off`` in ``--pairs`` pairs of epochs, each mode on its own
model and step from the same seed (an ``off`` call drops its step's
graphs, so one step for both would recapture in every ``auto`` epoch):
ms per step over each epoch, its peak of allocated and reserved memory
(both models'), and the captures it made; for ``auto`` the graphs kept
at the end and the reserved memory each capture added.  Each batch shape
keeps its own graph, so only the first ``auto`` epochs capture; nothing
is profiled.

Every line names the card and its power limit (``nvidia-smi``).
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

GROUPS = (
    ("B1 scale_cast", re.compile(r"scale_cast")),
    ("B2 flash_fwd", re.compile(r"flash_fwd")),
    ("B3-B5 quant", re.compile(r"quant_pack|dequant_accum|dequant_rows")),
    ("NCCL", re.compile(r"nccl", re.I)),
    ("conv/GEMM", re.compile(
        r"conv|xmma|cudnn|gemm|nvjet|implicit|wgrad|dgrad|fprop|sm90_|cutlass",
        re.I)),
    ("elementwise/reduce", re.compile(
        r"elementwise|vectorized|reduce|batch_norm|pool|copy|fill|cat|pad", re.I)),
)


def group_of(name: str) -> str:
    for label, pat in GROUPS:
        if pat.search(name):
            return label
    return "other"


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--window", type=int, default=10,
                    help="steps per timing window")
    ap.add_argument("--wire", choices=["int8", "fp8"],
                    help="also time, and profile, this quantized wire")
    ap.add_argument("--overlap", action="store_true",
                    help="time and profile the exchange launched from the "
                    "backward against after it, on the profiled wire")
    ap.add_argument("--onestep", action="store_true",
                    help="time and profile the step captured as one CUDA graph "
                    "against run eagerly, on the profiled wire")
    ap.add_argument("--pairs", type=int, default=2,
                    help="with --overlap or --onestep: pairs of timing windows")
    ap.add_argument("--last-batch", type=int,
                    help="instead time epochs of --window steps and one short "
                    "step of this batch, HVD_TPU_ONESTEP auto against off")
    ap.add_argument("--out", help="also write the results here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/torch_profile_step.py needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP
    from horovod_tpu_torch.utils.benchmarks import (
        build_dp_step, quartiles, select_window, timed_window, window_labels)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    profiled = args.wire or "bf16"
    ab = args.overlap or args.onestep
    wires = window_labels(args.wire, args.pairs if args.overlap else 0,
                          args.pairs if args.onestep else 0)
    hvd.init("cuda")
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0, device="cuda")
    # The wire at construction decides whether the optimizer keeps
    # error-feedback residuals.
    os.environ["HVD_TPU_SCHED_WIRE"] = wires[0].split("/")[0]
    step, opt = build_dp_step(hvd, model)
    sync_s = []
    synchronize = opt.synchronize

    def timed_synchronize():
        t0 = time.perf_counter()
        synchronize()
        sync_s.append(time.perf_counter() - t0)

    opt.synchronize = timed_synchronize
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = (torch.rand(32, 224, 224, 3, generator=g, device="cuda"),
             torch.randint(0, 1000, (32,), generator=g, device="cuda"))

    if args.last_batch:
        auto_model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                              device="cuda")
        steps = {"auto": build_dp_step(hvd, auto_model)[0], "off": step}
        result = {"card": card, "wire": profiled, "window": args.window,
                  "last_batch": args.last_batch,
                  "epochs": last_batch_epochs(steps, batch, profiled, args, card)}
        hvd.shutdown()
        write(args.out, result)
        return

    def window(wire: str):
        """Step ms and the exchange's host ms per step over one window
        (None where no step ran ``synchronize``: a replayed graph)."""
        seconds, _ = timed_window(step, batch, wire, args.window, sync_s.clear)
        ms = seconds / args.window * 1e3
        return ms, (sum(sync_s) / len(sync_s) * 1e3 if sync_s else None)

    for wire in sorted(set(wires)):  # warm every path
        window(wire)
    timing = {w: [] for w in wires}
    exchange = {w: [] for w in wires}
    for wire in wires:
        ms, host_ms = window(wire)
        timing[wire].append(ms)
        exchange[wire].append(host_ms)
    for wire, ms in timing.items():
        print(f"step ms, wire={wire}: {[round(v, 3) for v in ms]} "
              f"(mean {sum(ms) / len(ms):.3f}; batch 32); host ms of the "
              f"exchange (synchronize, enqueue only): "
              f"{[v if v is None else round(v, 3) for v in exchange[wire]]} on {card}",
              flush=True)
    if ab:
        for wire, ms in timing.items():
            print(f"step ms, wire={wire}: quartiles "
                  f"{' '.join(f'{v:.3f}' for v in quartiles(ms))} over "
                  f"{len(ms)} windows of {args.window} steps", flush=True)

    result = {"card": card, "timing_ms": timing, "steps": args.steps,
              "wire": profiled, "exchange_host_ms": exchange, "profiles": {}}
    for label in (wires[:2] if ab else (profiled,)):
        select_window(label)
        for _ in range(1 + (CAPTURE_WARMUP if label.endswith("/captured") else 0)):
            float(step(batch))
        result["profiles"][label] = profile_steps(step, batch, args.steps, label, card)
    hvd.shutdown()
    write(args.out, result)


def write(path, result) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)


def last_batch_epochs(steps, batch, wire, args, card):
    """Epochs of ``args.window`` steps at the full batch and one at
    ``args.last_batch``, ``HVD_TPU_ONESTEP`` auto and off in turns, each
    on its own step of ``steps`` (two untimed epochs first, one of each):
    per mode, each epoch's ms per step, peak allocated and peak reserved
    GiB and captures; for auto, the graphs its step keeps at the end and
    the reserved GiB each one's capture added."""
    import torch
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.utils.benchmarks import quartiles

    short = tuple(t[:args.last_batch] for t in batch)
    os.environ["HVD_TPU_SCHED_WIRE"] = wire
    os.environ["HVD_TPU_SCHED_BARRIERS"] = "0"
    turns = [m for _ in range(-(-args.pairs // 2)) for m in ("auto", "off", "off", "auto")]
    out = {"auto": [], "off": []}
    for i, mode in enumerate(["auto", "off"] + turns):
        os.environ["HVD_TPU_ONESTEP"] = mode
        step = steps[mode]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        captures = metrics.get_counter("xir.onestep.steps")
        t0 = time.perf_counter()
        for _ in range(args.window):
            step(batch)
        loss = float(step(short))
        seconds = time.perf_counter() - t0
        if not math.isfinite(loss):
            sys.exit(f"non-finite loss {loss} in an epoch under {mode}")
        if i >= 2:
            out[mode].append({"step_ms": seconds / (args.window + 1) * 1e3,
                              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                              "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
                              "captures": metrics.get_counter("xir.onestep.steps")
                              - captures})
    for mode, epochs in out.items():
        print(f"epochs of {args.window} x batch {batch[0].shape[0]} + 1 x batch "
              f"{args.last_batch}, {wire}, HVD_TPU_ONESTEP={mode}: step ms quartiles "
              f"{' '.join(f'{v:.3f}' for v in quartiles([e['step_ms'] for e in epochs]))} "
              f"(in order {[round(e['step_ms'], 3) for e in epochs]}; captures "
              f"{[e['captures'] for e in epochs]}), peak allocated "
              f"{max(e['peak_gib'] for e in epochs):.2f} GiB, peak reserved "
              f"{max(e['peak_reserved_gib'] for e in epochs):.2f} GiB (both models) over "
              f"{len(epochs)} epochs on {card}", flush=True)
    graphs = [round(c.reserved / 2 ** 30, 3) for c in steps["auto"]._graphs.values()]
    out["auto_graphs_reserved_gib"] = graphs
    print(f"HVD_TPU_ONESTEP=auto keeps {len(graphs)} graphs; reserved GiB added by "
          f"each capture: {graphs} on {card}", flush=True)
    return out


def profile_steps(step, batch, steps, label, card):
    """``steps`` steps under ``torch.profiler``: device busy and idle
    share per step, device time by group and the costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    float(step(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
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
    result = {}
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
        print(f"profiled {steps} {label} steps: wall {wall_us / steps / 1e3:.3f} ms/step, "
              f"device busy {busy / steps / 1e3:.3f} ms/step, idle share "
              f"{1 - busy / wall_us:.1%}, {len(kernels) / steps:.0f} kernels/step "
              f"on {card}", flush=True)
        for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"  {group:20s} {us / steps / 1e3:8.3f} ms/step "
                  f"{us / total:6.1%}", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
        for name, us in top:
            print(f"  {us / steps / 1e3:8.3f} ms/step  {name[:110]}", flush=True)
        result.update(
            wall_ms_per_step=wall_us / steps / 1e3,
            busy_ms_per_step=busy / steps / 1e3,
            idle_share=1 - busy / wall_us,
            kernels_per_step=len(kernels) / steps,
            groups_ms_per_step={k: v / steps / 1e3 for k, v in by_group.items()},
            top=[(n, v / steps / 1e3) for n, v in top],
        )
    return result


if __name__ == "__main__":
    main()
