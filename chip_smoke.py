#!/usr/bin/env python3
"""Drive horovod_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc``; it exits non-zero, printing no result, without
them or outside a checkout.  Phases, one line each (any failure exits
non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off
   for float32 matmuls and convolutions (stated).
2. build: kernel B1 (``horovod_tpu_torch/csrc/scale_cast.cu``) compiled
   with ``nvcc`` for sm_90a, every source in parallel.
3. kernel: B1 against its plain PyTorch version, bitwise, at the
   ResNet-50 bf16 wire's bucket sizes and at 1 / 127 / 65 537 elements,
   for f32->bf16, bf16->f32, bf16->bf16 at scale 1/3 and f32->f16 with
   NaN, infinities, f16 overflow and subnormals; with the kernel's, the
   plain version's and the ``x.to`` / ``x * s`` library call's times and
   the memory bound.
4. slice: ``init`` on NCCL (world of one), full-width ResNet-50 at
   224x224, batch 32, bf16 compute, ``HVD_TPU_SCHED_WIRE=bf16``,
   ``build_dp_step``; 2 warm-up + 5 timed steps with finite losses, B1
   launched exactly twice per bucket per step (world of one: ``_scale``
   skips the factor 1.0).
5. reference: the same step on a small float32 ResNet on the card
   against the CPU path (plain versions), to stated tolerances.
6. result: the card line, the kernels JSON line, then
   ``{"ok": true, "device": {...}}`` as the last line.

``--out PATH`` also writes every measurement as JSON.
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
WARMUP, TIMED = 2, 5


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def bits(t):
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


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
            both = torch.isfinite(got) & torch.isfinite(want)
            if both.any():
                err = (got.float()[both] - want.float()[both]).abs().max()
                max_err = max(max_err, float(err))
        case_launches = kernels.scale_cast.launches - case_launches
        x = (torch.randn(largest, generator=g, device="cuda")).to(din)
        ms = time_ms(lambda: kernels.scale_cast(x, scale, dout))
        plain_ms = time_ms(lambda: kernels.scale_cast_reference(x, scale, dout))
        if scale == 1.0:
            lib_ms = time_ms(lambda: x.to(dout))
        else:
            lib_ms = time_ms(lambda: x * scale)
        nbytes = largest * (x.element_size() + torch.empty(0, dtype=dout).element_size())
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        rec = {"case": name, "n": largest, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms, "bytes": nbytes}
        log["kernel_cases"].append(rec)
        print(f"phase kernel: B1 {name} bitwise at n in {sorted(set(sizes) | {1, 127, 65537})}; "
              f"n={largest}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_ms / ms:.1%} of bound); {case_launches} launches",
              flush=True)
        if name == "f32->bf16":
            record = rec
    compare_launches = kernels.scale_cast.launches - compare_launches
    print(f"phase kernel: {compare_launches} launches for comparison and timing "
          f"(not counted for the main path); max abs error {max_err}",
          flush=True)
    record["max_abs_err"] = max_err
    return record


def reference_phase(hvd, tresnet, build_dp_step):
    """The step on the card against the CPU path (plain versions) on a
    small float32 ResNet for three bf16-wire steps, with the tolerances
    of ``tests/test_torch_train_step.py``: cuDNN's and the CPU's float32
    convolutions differ in the last bits, the bf16 wire can round a
    gradient element the other way, and BatchNorm amplifies that in
    later steps.  First loss to rtol 1e-5, later losses to rtol 1e-4,
    weights to 15% of their tensor's move + 1e-5."""
    import torch

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
            step, _ = build_dp_step(hvd, model)
            losses = [float(step((x.to(dev), y.to(dev)))) for x, y in batches]
            end = {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}
        finally:
            hvd.shutdown()
        runs[dev] = (losses, start, end)
    (lc, start, ec), (lp, _, ep) = runs["cuda"], runs["cpu"]
    if not all(math.isfinite(v) for v in lc):
        fail(f"reference: non-finite losses on the card {lc}")
    if abs(lc[0] - lp[0]) > 1e-5 * abs(lp[0]) or any(
        abs(a - b) > 1e-4 * abs(b) for a, b in zip(lc, lp)
    ):
        fail(f"reference: losses {lc} on the card vs {lp} on the CPU")
    worst = 0.0
    for k in ep:
        if not ep[k].is_floating_point() or k.endswith((".mean", ".var")):
            continue
        moved = float((ep[k] - start[k]).abs().max())
        diff = float((ec[k] - ep[k]).abs().max())
        worst = max(worst, diff / (moved + 1e-12))
        if diff > 0.15 * moved + 1e-5:
            fail(f"reference: {k} differs by {diff} (moved {moved})")
    print(f"phase reference: small f32 ResNet, 3 bf16-wire steps on the card "
          f"vs the CPU path: losses {lc} vs {lp}; worst weight difference "
          f"{worst:.2e} of its tensor's move", flush=True)
    return {"losses_cuda": lc, "losses_cpu": lp, "worst_rel_move": worst}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "horovod_tpu_torch")):
        fail(f"horovod_tpu_torch/ not found beside {__file__}: run from a checkout")
    sys.path.insert(0, root)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as tresnet
    from horovod_tpu_torch.ops import build, kernels
    from horovod_tpu_torch.sched.plan import SchedConfig, build_schedule, dtype_name
    from horovod_tpu_torch.utils.benchmarks import build_dp_step, timed_throughput

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

    # Phase 2: build every kernel of the path, one nvcc per source.
    t0 = time.perf_counter()
    build.build(["scale_cast"])
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(
        line.strip() for line in build.build_logs.get("scale_cast", "").splitlines()
        if "registers" in line
    )
    print(f"phase build: scale_cast.cu in {build_s:.1f} s; ptxas: {ptxas or 'cached'}",
          flush=True)
    log["build_s"] = build_s

    # Phase 3: B1 against its plain version at the slice's bucket sizes.
    os.environ["HVD_TPU_SCHED_WIRE"] = "bf16"
    meta = tresnet.ResNet50(num_classes=1000, device="meta")
    params = [p for p in meta.parameters()]
    planned = build_schedule(
        [p.numel() * 4 for p in params], [dtype_name(torch.float32)] * len(params),
        SchedConfig.from_env(),
    )
    sizes = [b.nbytes // 4 for b in planned.buckets]
    print(f"phase kernel: ResNet-50 bf16-wire buckets (elements): {sizes}", flush=True)
    record = kernel_phase(kernels, sizes, log)

    # Phase 4: the slice, through the entry points a user calls.
    hvd.init("cuda")
    model = tresnet.ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                             device="cuda")
    step, opt = build_dp_step(hvd, model)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = (torch.rand(32, 224, 224, 3, generator=g, device="cuda"),
             torch.randint(0, 1000, (32,), generator=g, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.scale_cast.launches = 0
    seconds, losses = timed_throughput(step, batch, iters=TIMED, warmup=WARMUP)
    launches = kernels.scale_cast.launches
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    schedule = opt.schedule
    if schedule is None or not all(b.wire == "bf16" for b in schedule.buckets):
        fail("the step did not plan a bf16 wire on every bucket")
    expected = 2 * len(schedule) * (WARMUP + TIMED)
    if launches != expected:
        fail(f"B1 launched {launches} times; the schedule implies {expected} "
             f"(2 x {len(schedule)} buckets x {WARMUP + TIMED} steps)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite losses {losses}")
    step_ms = seconds / TIMED * 1e3
    img_s = 32 * TIMED / seconds
    actual = [b.nbytes // 4 for b in schedule.buckets]
    print(f"phase slice: ResNet-50 224x224 batch 32 bf16, bf16 wire, "
          f"{len(schedule)} buckets {actual} elements; losses "
          f"{[round(v, 5) for v in losses]}; B1 launches {launches} "
          f"(= 2 x {len(schedule)} x {WARMUP + TIMED}); step {step_ms:.2f} ms, "
          f"{img_s:.1f} img/s, peak {peak_gib:.2f} GiB on {card}", flush=True)
    if sorted(actual) != sorted(sizes):
        kernel_phase(kernels, actual, {"kernel_cases": []})
    log.update(losses=losses, step_ms=step_ms, img_s=img_s, peak_gib=peak_gib,
               buckets=actual, launches=launches)
    hvd.shutdown()
    del model, opt, step, batch
    torch.cuda.empty_cache()

    log["reference"] = reference_phase(hvd, tresnet, build_dp_step)

    kernels_line = {"kernels": [{
        "name": "scale_cast",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/scale_cast.cu",
        "replaces": "horovod_tpu/ops/pallas_kernels.py:56",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": "bytes",
        "library_ms": record["library_ms"],
    }]}
    log["kernels"] = kernels_line["kernels"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)
    print(f"card: {card}")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
