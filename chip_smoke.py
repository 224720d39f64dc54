#!/usr/bin/env python3
"""Drive horovod_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc``; it exits non-zero, printing no result, without
them or outside a checkout.  Phases, one line each or more (any failure
exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off
   for float32 matmuls and convolutions (stated).
2. build: ``horovod_tpu_torch/csrc/scale_cast.cu`` (kernel B1) and
   ``quant.cu`` (B3, B4, B5) compiled with ``nvcc`` for sm_90a, one
   ``nvcc`` per source, started together; the ptxas register lines.
3. kernel: B1 against its plain PyTorch version, bitwise, at the
   ResNet-50 bf16 wire's bucket sizes and at 1 / 127 / 65 537 elements,
   for f32->bf16, bf16->f32, bf16->bf16 at scale 1/3 and f32->f16 with
   NaN, infinities, f16 overflow and subnormals; then B3 (int8 and fp8,
   with and without the dequant), B4 (1, 2 and 4 arrivals) and B5,
   bitwise, at the int8 wire's padded bucket sizes and at a ragged size
   for blocks 64 / 128 / 512 / 96, with an all-zero, an inf, a NaN and a
   subnormal block.  Each with the kernel's, the plain version's and
   (where one call computes the same function) the library call's time,
   and the memory bound.
4. slice bf16: ``init`` on NCCL (world of one), full-width ResNet-50 at
   224x224, batch 32, bf16 compute, ``HVD_TPU_SCHED_WIRE=bf16``,
   ``build_dp_step``; 2 warm-up + 5 timed steps with finite losses, B1
   launched exactly twice per bucket per step (world of one: ``_scale``
   skips the factor 1.0).
5. slice int8: the same model, weights and batch with
   ``HVD_TPU_SCHED_WIRE=int8`` and error feedback: 2 warm-up + 5 timed
   steps, finite losses, the first equal to the bf16 run's (rtol 1e-5:
   the same forward before any update), every bucket on int8, non-zero
   residuals, and per bucket per step B3 twice, B4 and B5 once, B1
   never.  Then fp8 for 1 warm-up + 2 steps, with its counts.
6. reference: a small float32 ResNet on the card against the CPU path
   (plain versions), three steps on the bf16 wire and three on int8, to
   stated tolerances.
7. result: the card line, the kernels JSON line, then
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
FP8_WARMUP, FP8_TIMED = 1, 2
BLOCK = 512  # HVD_TPU_QUANT_BLOCK default
SOURCES = ["scale_cast", "quant"]
REPLACES = {
    "scale_cast": "horovod_tpu/ops/pallas_kernels.py:56",
    "quant_pack": "horovod_tpu/ops/pallas_quant.py:139",
    "dequant_accum": "horovod_tpu/ops/pallas_quant.py:174",
    "dequant_rows": "horovod_tpu/ops/pallas_quant.py:197",
}


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
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = time_ms(lib) if lib is not None else None
        bound_ms = nbytes / H100_BYTES_PER_S * 1e3
        rec = {"kernel": name, "case": what, "elements": v, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bytes": nbytes}
        log["kernel_cases"].append(rec)
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"phase kernel: {what}, {v} elements: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_txt}, bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB; {bound_ms / ms:.1%} of bound)", flush=True)
        if name not in records:
            records[name] = dict(rec, max_abs_err=max_err[name])
    after = (qk.quant_packed.launches, qk.dequant_accum.launches,
             qk.dequant_rows.launches)
    print(f"phase kernel: {[a - b for a, b in zip(after, before)]} B3/B4/B5 "
          "launches for timing (not counted for the main path)", flush=True)
    return records


def slice_phase(hvd, tresnet, build_dp_step, timed_throughput, kernels, qk,
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
                    qk.dequant_rows)
        for c in counters:
            c.launches = 0
        seconds, losses = timed_throughput(step, batch, iters=timed, warmup=warmup)
        launches = dict(zip(("scale_cast", "quant_pack", "dequant_accum",
                             "dequant_rows"), (c.launches for c in counters)))
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
                    "dequant_accum": 0, "dequant_rows": 0}
    else:
        # Per bucket per step: B3 for the reduce-scatter (with the
        # dequant, for the residual) and for the all-gather, B4 and B5
        # once each; no B1 at a world of one.
        expected = {"scale_cast": 0, "quant_pack": 2 * buckets * steps,
                    "dequant_accum": buckets * steps,
                    "dequant_rows": buckets * steps}
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
    from horovod_tpu_torch.ops import quant_kernels as qk
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
    build.build(SOURCES)
    build_s = time.perf_counter() - t0
    for name in SOURCES:
        ptxas = " | ".join(
            line.strip() for line in build.build_logs.get(name, "").splitlines()
            if "registers" in line
        )
        print(f"phase build: {name}.cu; ptxas: {ptxas or 'cached'}", flush=True)
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
    print(f"phase kernel: ResNet-50 buckets (elements): {sizes}; padded to the "
          f"int8 block: {padded}", flush=True)
    record = kernel_phase(kernels, sizes, log)
    qrecords = quant_kernel_phase(qk, padded, log)

    # Phases 4 and 5: the slice on each wire, through the entry points a
    # user calls; the counts are set to 0 before each run.
    runs = {}
    for wire, warmup, timed in (("bf16", WARMUP, TIMED), ("int8", WARMUP, TIMED),
                                ("fp8", FP8_WARMUP, FP8_TIMED)):
        runs[wire] = slice_phase(hvd, tresnet, build_dp_step, timed_throughput,
                                 kernels, qk, wire, warmup, timed, card)
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

    log["reference"] = [reference_phase(hvd, tresnet, build_dp_step, w)
                        for w in ("bf16", "int8")]

    entries = [("scale_cast", "scale_cast.cu", record, runs["bf16"])]
    entries += [(k, "quant.cu", qrecords[k], runs["int8"])
                for k in ("quant_pack", "dequant_accum", "dequant_rows")]
    kernels_line = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"horovod_tpu_torch/csrc/{src}",
        "replaces": REPLACES[name],
        "launches": run["launches"][name],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": "bytes",
        "library_ms": rec["library_ms"],
    } for name, src, rec, run in entries]}
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
