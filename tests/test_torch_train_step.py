"""The ported data-parallel step against the JAX package's, end to end.

* World of one: the JAX ``build_dp_step`` (on ``jax.devices()[:1]``) and
  the port's (on a gloo world of one) train the same tiny float32
  ResNet, from the same weights, on the same numpy batches for three
  steps with ``HVD_TPU_SCHED_WIRE=bf16``.  The two packages' float32
  gradients differ in the last bits (up to 1.3e-4 of a tensor's largest
  gradient, through BatchNorm's backward), so the bf16 wire can round
  an element the other way: one bf16 ulp, at most 2^-7 of its update.
  After the first step each weight must agree to 2^-7 of its own
  update plus 4e-4 of its tensor's largest update (+1e-7: three times
  the gradient difference measured).  Later steps feed those
  differences through the network; BatchNorm biases, whose gradients
  are sums that normalisation drives toward zero, see them amplified.
  After three steps each weight agrees to 15% of its tensor's largest
  move (+1e-5), losses to rtol 1e-4 (the first, before any update, to
  1e-6), running statistics to rtol 1e-4 / atol 1e-4 (the forward's
  own tolerance, ``test_torch_resnet.py``).
* World of one, ``HVD_TPU_SCHED_WIRE=int8`` / ``fp8`` with error
  feedback: the same three steps.  The two packages quantize blocks of
  512 elements of one flat bucket, but not the same elements: the JAX
  package flattens its pytree (sorted names, HWIO convolution kernels),
  the port its modules (registration order, OIHW).  Each package's
  update of an element is within one quantization step S of the exact
  one (half a step in each of its two quantizations), where S is the
  element's block maximum / 127 for int8 and 2^-3 of the element plus
  2^-9 of the block maximum / 448 for fp8 (three mantissa bits).  So
  after the first step each weight agrees to S_jax + S_port + 4e-4 of
  its tensor's largest update + 1e-7 (the float32 gradient difference
  allowance of the bf16 case), with S measured on the JAX step's first
  update in both layouts (measured: half of that).  After three steps,
  each weight agrees to 6·(S_jax + S_port) (three updates with momentum
  0.9 weigh a step-one error 1 + 1.9 + 2.71 times) + 60% of its
  tensor's largest move + 1e-5: the differences pass through BatchNorm
  in steps two and three, which the fp8 wire's coarser relative grid
  shows most (measured: 0.89 of the same bound at 50%).  Losses agree
  to rtol 1e-2 after the first update (measured 3.6e-3, fp8), the
  first to 1e-6.
* World of two: two gloo processes of the port and the JAX
  ``distributed_train_step`` on ``jax.devices()[:2]`` train a linear
  model on dyadic data (every value exact in bf16) with SGD at lr 1.
  Over the bf16 wire the weights must be bitwise equal.  Over the int8
  wire with error feedback the weights and each rank's residuals
  agree to 5e-7 (measured 6e-8 and 1.3e-7: float32 ulps): XLA:CPU contracts the dequant-accumulate ``acc + q·s``
  and the residual ``e − q·s`` into fused multiply-adds, one rounding
  where the port, like its CUDA kernels, rounds the product first.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
import horovod_tpu_torch as thvd
from horovod_tpu.models.resnet import ResNet as JaxResNet
from horovod_tpu.utils.benchmarks import build_dp_step as jax_build_dp_step
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.utils.benchmarks import build_dp_step

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, CLASSES, LR = 3, 4, 10, 0.01


def _batches():
    rng = np.random.default_rng(0)
    return [
        (rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
         rng.integers(0, CLASSES, BATCH).astype(np.int32))
        for _ in range(STEPS)
    ]


def _copy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


class _JittedInit:
    """The flax model with ``init`` jitted: op-by-op init compiles every
    op and costs seconds; the values are the same function of the key."""

    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames=("train",))
        self.apply = model.apply


def _run_jax(batches):
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    try:
        model = JaxResNet(stage_sizes=[1, 1, 1, 1], num_filters=8,
                          num_classes=CLASSES, dtype=jnp.float32)
        step, params, stats, opt_state = jax_build_dp_step(
            hvd, _JittedInit(model), 32
        )
        start = (_copy_tree(params), _copy_tree(stats))  # the step donates
        losses, after, first = [], [], None
        for x, y in batches:
            params, stats, opt_state, loss = step(
                params, stats, opt_state, (jnp.asarray(x), jnp.asarray(y))
            )
            losses.append(float(loss))
            first = _copy_tree(params) if first is None else first
            after.append(tresnet.load_jax_params(
                _copy_tree(params), _copy_tree(stats)
            ))
        return start, losses, after, first
    finally:
        hvd.shutdown()


def _run_port(start, batches):
    thvd.init("cpu")
    try:
        model = tresnet.ResNet([1, 1, 1, 1], num_classes=CLASSES,
                               num_filters=8, dtype=torch.float32,
                               device="cpu")
        model.load_state_dict(tresnet.load_jax_params(*start))
        step, opt = build_dp_step(thvd, model, lr=LR)
        tmetrics.reset("sched.")
        losses, after = [], []
        for x, y in batches:
            losses.append(
                float(step((torch.from_numpy(x), torch.from_numpy(y).long())))
            )
            after.append({k: v.clone() for k, v in model.state_dict().items()})
        return losses, after, opt
    finally:
        thvd.shutdown()


def test_world1_bf16_wire_step_matches_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")
    batches = _batches()
    start, losses_j, after_j, _ = _run_jax(batches)
    losses_t, after_t, opt = _run_port(start, batches)

    # The port really ran the bf16 wire on every bucket.
    assert opt.schedule is not None and len(opt.schedule) >= 1
    assert all(b.wire == "bf16" for b in opt.schedule.buckets)
    assert tmetrics.get_counter("sched.buckets") == STEPS * len(opt.schedule)
    assert tmetrics.get_gauge("sched.wire_bytes", {"wire": "bf16"}) == \
        opt.schedule.total_bytes // 2

    np.testing.assert_allclose(losses_t[0], losses_j[0], rtol=1e-6)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    start_sd = tresnet.load_jax_params(*start)
    for name, ref in after_j[-1].items():
        got, ref = after_t[-1][name].numpy(), ref.numpy()
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
            continue
        p0 = start_sd[name].numpy()
        move1 = after_j[0][name].numpy() - p0
        np.testing.assert_array_less(
            np.abs(after_t[0][name].numpy() - after_j[0][name].numpy()),
            2.0 ** -7 * np.abs(move1) + 4e-4 * np.abs(move1).max() + 1e-7,
            err_msg=f"{name} after step 1",
        )
        moved = np.abs(ref - p0).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 + 0.15 * moved,
                                   err_msg=name)


def _steps_in_blocks(absflat, wire, block=512):
    """Per element of a flat bucket, the quantization step S of the
    module docstring, from the block maxima of ``absflat``."""
    pad = np.zeros(-(-absflat.size // block) * block, np.float32)
    pad[:absflat.size] = absflat
    bmax = np.repeat(pad.reshape(-1, block).max(-1), block)[:absflat.size]
    if wire == "int8":
        return bmax / 127
    return absflat * 2.0 ** -3 + bmax * 2.0 ** -9 / 448


def _split(flat, shapes):
    out, off = [], 0
    for shape in shapes:
        size = int(np.prod(shape))
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return out


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_world1_quantized_wire_step_matches_jax(monkeypatch, wire):
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)
    monkeypatch.delenv("HVD_TPU_SCHED_WIRE_EF", raising=False)
    monkeypatch.delenv("HVD_TPU_QUANT_BLOCK", raising=False)
    batches = _batches()
    start, losses_j, after_j, first_j = _run_jax(batches)
    losses_t, after_t, opt = _run_port(start, batches)

    assert len(opt.schedule) == 1 and opt.schedule.buckets[0].wire == wire
    assert tmetrics.get_counter("sched.buckets") == STEPS
    assert opt.residuals is not None
    assert sum(float(r.abs().sum()) for r in opt.residuals) > 0

    # S in the JAX layout (pytree leaves in order, flax layouts), mapped
    # to the port's names and layouts.
    leaves, treedef = jax.tree.flatten(
        jax.tree.map(lambda a, b: np.abs(a - b), first_j, start[0])
    )
    steps_j = tresnet.load_jax_params(jax.tree.unflatten(treedef, _split(
        _steps_in_blocks(np.concatenate([v.ravel() for v in leaves]), wire),
        [v.shape for v in leaves],
    )))
    # S in the port's layout: the bucket's parameters in index order.
    names = [n for n, _ in tresnet.ResNet(
        [1, 1, 1, 1], num_classes=CLASSES, num_filters=8, device="meta"
    ).named_parameters()]
    start_sd = tresnet.load_jax_params(*start)
    move1 = {n: np.abs(after_j[0][n].numpy() - start_sd[n].numpy())
             for n in names}
    order = [names[i] for i in opt.schedule.buckets[0].indices]
    steps_t = dict(zip(order, _split(
        _steps_in_blocks(np.concatenate([move1[n].ravel() for n in order]), wire),
        [move1[n].shape for n in order],
    )))

    np.testing.assert_allclose(losses_t[0], losses_j[0], rtol=1e-6)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2)
    for n in names:
        both = steps_j[n].numpy() + steps_t[n]
        np.testing.assert_array_less(
            np.abs(after_t[0][n].numpy() - after_j[0][n].numpy()),
            both + 4e-4 * move1[n].max() + 1e-7, err_msg=f"{n} after step 1",
        )
        moved = np.abs(after_j[-1][n].numpy() - start_sd[n].numpy()).max()
        np.testing.assert_array_less(
            np.abs(after_t[-1][n].numpy() - after_j[-1][n].numpy()),
            6 * both + 0.6 * moved + 1e-5, err_msg=n,
        )


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=2,
             timeout_s=100)
    try:
        data = np.load(out + "/data.npz")
        model = torch.nn.Module()
        model.w = torch.nn.Parameter(torch.from_numpy(data["w"]))
        model.b = torch.nn.Parameter(torch.from_numpy(data["b"]))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1.0),
            named_parameters=model.named_parameters(),
        )

        def loss_fn(m, batch):
            x, y = batch
            return ((x @ m.w + m.b - y) ** 2).mean()

        step = hvd.TrainStep(model, opt, loss_fn)
        rows = slice(4 * rank, 4 * rank + 4)
        for x, y in zip(data["x"], data["y"]):
            step((torch.from_numpy(x[rows]), torch.from_numpy(y[rows])))
        res = {}
        if opt.residuals is not None:
            # Rank-local: broadcasting the optimizer state leaves them.
            before = [r.clone() for r in opt.residuals]
            hvd.broadcast_optimizer_state(opt, root_rank=0)
            assert all(torch.equal(a, r) for a, r in zip(before, opt.residuals))
            res = {"res_w": before[0].numpy(), "res_b": before[1].numpy()}
        from horovod_tpu_torch import metrics
        fused = [metrics.get_counter("quant.fused_collectives"),
                 metrics.get_counter("quant.fused_bytes")]
        np.savez(f"{out}/rank{rank}.npz", w=model.w.detach().numpy(),
                 b=model.b.detach().numpy(), fused=np.array(fused), **res)
    finally:
        hvd.shutdown()
""")


def _dyadic_problem():
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, (2, 8, 6)).astype(np.float32) / 2
    y = rng.integers(-3, 4, (2, 8, 1)).astype(np.float32) / 4
    w = rng.integers(-2, 3, (6, 1)).astype(np.float32) / 8
    b = np.array([0.25], np.float32)
    return x, y, w, b


def _run_jax_world2(x, y, w, b):
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:2])
    try:
        def loss_fn(p, batch):
            bx, by = batch
            return jnp.mean((bx @ p["w"] + p["b"] - by) ** 2)

        step = hvd.distributed_train_step(
            loss_fn, hvd.DistributedOptimizer(optax.sgd(1.0))
        )
        params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        opt_state = step.init(params)
        for bx, by in zip(x, y):
            params, opt_state, _ = step(
                params, opt_state, (jnp.asarray(bx), jnp.asarray(by))
            )
        return _copy_tree(params), _copy_tree(opt_state.residual)
    finally:
        hvd.shutdown()


def _spawn(tmp_path, source, n, **env_extra):
    """Run ``source`` as ranks 0..n-1 of a gloo world joined through a
    FileStore under ``tmp_path``; each rank's saved arrays."""
    script = tmp_path / "worker.py"
    script.write_text(source)
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r),
                 str(tmp_path / "store"), str(tmp_path)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]


def _run_port_world2(tmp_path, wire, x, y, w, b):
    """The port's two gloo ranks on the dyadic problem."""
    np.savez(tmp_path / "data.npz", x=x, y=y, w=w, b=b)
    return _spawn(tmp_path, _WORKER, 2, HVD_TPU_SCHED_WIRE=wire)


def test_world2_bf16_wire_is_bitwise_with_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")
    x, y, w, b = _dyadic_problem()
    want, _ = _run_jax_world2(x, y, w, b)
    for got in _run_port_world2(tmp_path, "bf16", x, y, w, b):
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(want["w"], w)  # the step moved the weights


def test_world2_int8_wire_matches_jax(monkeypatch, tmp_path):
    """Error feedback on: weights and each rank's residuals against the
    JAX package's, to 5e-7 (module docstring)."""
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "int8")
    monkeypatch.delenv("HVD_TPU_SCHED_WIRE_EF", raising=False)
    x, y, w, b = _dyadic_problem()
    want, res = _run_jax_world2(x, y, w, b)
    got = _run_port_world2(tmp_path, "int8", x, y, w, b)
    for r, g in enumerate(got):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], want[k], rtol=0, atol=5e-7)
            np.testing.assert_allclose(g[f"res_{k}"], res[k][r], rtol=0,
                                       atol=5e-7)
        np.testing.assert_array_equal(g["w"], got[0]["w"])
        # One reduce-scatter and one all-gather per step, each moving
        # n·(c + 4·c/block) bytes: c = 512, one block per chunk.
        np.testing.assert_array_equal(g["fused"], [4, 4 * 2 * (512 + 4)])
    # Rank-local residuals: the ranks' gradients differ, so do they.
    assert not np.array_equal(got[0]["res_w"], got[1]["res_w"])
    assert np.abs(got[0]["res_w"]).max() > 0
    assert not np.array_equal(want["w"], w)


_WORKER3 = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import quantized as tq
    from horovod_tpu_torch.optim.distributed_optimizer import _pmean_

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=3,
             timeout_s=100)
    try:
        x = torch.from_numpy(np.load(out + "/data.npz")["x"][rank])
        mean = x.clone()
        _pmean_([mean])
        np.savez(f"{out}/rank{rank}.npz", pmean=mean.numpy(),
                 allreduce=tq.quantized_allreduce(x, block=128).numpy(),
                 shard=tq.quantized_reduce_scatter(x, block=128).numpy())
    finally:
        hvd.shutdown()
""")


def _grid_problem():
    """Three ranks' float32 rows on the int8 grid: multiples of 1/4 in
    [-10, 10] with 31.75 (= 127/4) once in every 128-block, so every
    block's scale is exactly 1/4, every q·s is exact and so is every sum
    of three; 1024 elements pad to 3 chunks of 384 with one zero block."""
    rng = np.random.default_rng(4)
    x = rng.integers(-40, 41, (3, 1024)).astype(np.float32) / 4
    x.reshape(3, 8, 128)[:, :, 7] = 31.75
    return x


def test_world3_averages_match_jax(tmp_path):
    """At a world of three the averages are bitwise with the JAX
    package's: ``lax.pmean`` and the quantized wire's ``/ n`` compile to
    a multiply by float32(1/3) under ``jit``, and the sums here are
    exact, so any other rounding of the average shows."""
    from horovod_tpu.ops.quantized import (
        quantized_allreduce,
        quantized_reduce_scatter,
    )
    from horovod_tpu.runtime import WORLD_AXIS, get_runtime
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    x = _grid_problem()
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:3])
    try:
        def body(v):
            v = v[0]
            return (jax.lax.pmean(v, WORLD_AXIS)[None],
                    quantized_allreduce(v, block=128)[None],
                    quantized_reduce_scatter(v, block=128)[None])

        fn = jax.jit(shard_map(
            body, mesh=get_runtime().mesh, in_specs=(P(WORLD_AXIS),),
            out_specs=(P(WORLD_AXIS),) * 3, check_vma=False,
        ))
        pmean, allreduce, shard = [np.array(a) for a in fn(jnp.asarray(x))]
    finally:
        hvd.shutdown()
    np.savez(tmp_path / "data.npz", x=x)
    for r, got in enumerate(_spawn(tmp_path, _WORKER3, 3)):
        np.testing.assert_array_equal(got["pmean"], pmean[r])
        np.testing.assert_array_equal(got["allreduce"], allreduce[r])
        np.testing.assert_array_equal(got["shard"], shard[r])
    assert not np.array_equal(pmean[0], (x.sum(0) / np.float32(3)))


def _linear_step(**kwargs):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        named_parameters=model.named_parameters(), **kwargs,
    )
    return model, opt


def test_distributed_optimizer_api_and_readiness_order():
    thvd.init("cpu")
    try:
        model, opt = _linear_step(fusion_threshold_bytes=0)
        assert isinstance(opt, torch.optim.SGD)
        with pytest.raises(ValueError):
            thvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=list(model.named_parameters())[:1],
            )
        x = torch.ones(2, 4)
        model(x).sum().backward()
        opt.step()
        # Threshold 0: one bucket per parameter, in the order the
        # post-accumulate-grad hooks saw them ready (last layer first).
        order = [b.indices[0] for b in opt.schedule.buckets]
        assert order[:2] == [3, 2] and sorted(order) == [0, 1, 2, 3]
    finally:
        thvd.shutdown()


def test_predivide_and_local_accumulation_world1():
    """World of one: predivide 1/4 then x4 is exact, so the update equals
    plain SGD's; with backward_passes_per_step=2 the first TrainStep call
    only accumulates and the second applies the mean of the two
    gradients, then clears them."""
    thvd.init("cpu")
    try:
        x = torch.arange(8.0).reshape(2, 4) / 8
        model, opt = _linear_step(gradient_predivide_factor=4.0)
        ref, _ = _linear_step()
        ref_opt = torch.optim.SGD(ref.parameters(), lr=0.5)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # two GEMM computations compared bitwise
        try:
            for m, o in ((model, opt), (ref, ref_opt)):
                m(x).sum().backward()
                o.step()
        finally:
            torch.set_num_threads(threads)
        for a, b in zip(model.parameters(), ref.parameters()):
            assert torch.equal(a, b)

        model, opt = _linear_step(backward_passes_per_step=2)
        step = thvd.TrainStep(model, opt, lambda m, b: m(b).sum())
        before = [p.detach().clone() for p in model.parameters()]
        step(x)
        assert opt.accumulating
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))
        grads = [p.grad.clone() for p in model.parameters()]
        step(x)  # same batch: the mean of the two gradients is g
        assert not opt.accumulating
        for p, p0, g in zip(model.parameters(), before, grads):
            torch.testing.assert_close(p, p0 - 0.5 * g, rtol=0, atol=1e-6)
        assert all(p.grad is None for p in model.parameters())
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("case", ["ef_off", "compressor", "legacy"])
def test_quantized_wire_options_world1(monkeypatch, case):
    """``HVD_TPU_SCHED_WIRE_EF=0`` keeps no residual; ``Compression.int8``
    wins over the knob and keeps residuals; with ``HVD_TPU_SCHED=off``
    ``Compression.fp8`` reduces each bucket with ``quantized_allreduce``
    and no residual.  Each step's update is that exchange's output."""
    from horovod_tpu_torch.ops import quantized as tq

    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16" if case != "ef_off" else "int8")
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE_EF", "0" if case == "ef_off" else "1")
    monkeypatch.setenv("HVD_TPU_SCHED", "off" if case == "legacy" else "on")
    compression = {"ef_off": thvd.Compression.none,
                   "compressor": thvd.Compression.int8,
                   "legacy": thvd.Compression.fp8}[case]
    wire = "fp8" if case == "legacy" else "int8"
    thvd.init("cpu")
    try:
        model, opt = _linear_step(compression=compression)
        x = torch.arange(8.0).reshape(2, 4) / 8 - 0.3
        before = [p.detach().clone() for p in model.parameters()]
        model(x).square().sum().backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opt.step()
        assert (opt.residuals is not None) == (case == "compressor")
        want_wire = "off" if case == "legacy" else "int8"
        assert [b.wire for b in opt.schedule.buckets] == [want_wire]
        flat = torch.cat([grads[i].reshape(-1) for i in opt.schedule.buckets[0].indices])
        reduced = tq.quantized_allreduce(flat, wire=wire)
        off = 0
        for i in opt.schedule.buckets[0].indices:
            n = grads[i].numel()
            want = before[i] - 0.5 * reduced[off:off + n].view(grads[i].shape)
            assert torch.equal(list(model.parameters())[i], want)
            off += n
        if case == "compressor":
            assert sum(float(r.abs().sum()) for r in opt.residuals) > 0
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("request_wire", ["knob", "compressor", "none"])
def test_quantized_wire_refuses_other_ops(monkeypatch, request_wire):
    """An op other than Sum/Average (4 is the JAX package's Max) raises
    ``QuantizedWireError`` when a quantized wire is requested, and a
    plain ``ValueError`` otherwise."""
    from horovod_tpu_torch.exceptions import QuantizedWireError

    monkeypatch.setenv("HVD_TPU_SCHED_WIRE",
                       "int8" if request_wire == "knob" else "off")
    compression = (thvd.Compression.int8 if request_wire == "compressor"
                   else thvd.Compression.none)
    thvd.init("cpu")
    try:
        with pytest.raises(ValueError) as err:
            _linear_step(op=4, compression=compression)
        assert isinstance(err.value, QuantizedWireError) == (request_wire != "none")
    finally:
        thvd.shutdown()
