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
* World of two: two gloo processes of the port and the JAX
  ``distributed_train_step`` on ``jax.devices()[:2]`` train a linear
  model on dyadic data (every value exact in bf16) with SGD at lr 1
  over the bf16 wire; the weights must be bitwise equal.
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
        losses, after = [], []
        for x, y in batches:
            params, stats, opt_state, loss = step(
                params, stats, opt_state, (jnp.asarray(x), jnp.asarray(y))
            )
            losses.append(float(loss))
            after.append(tresnet.load_jax_params(
                _copy_tree(params), _copy_tree(stats)
            ))
        return start, losses, after
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
    start, losses_j, after_j = _run_jax(batches)
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
        np.savez(f"{out}/rank{rank}.npz", w=model.w.detach().numpy(),
                 b=model.b.detach().numpy())
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
        return _copy_tree(params)
    finally:
        hvd.shutdown()


def test_world2_bf16_wire_is_bitwise_with_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")
    x, y, w, b = _dyadic_problem()
    want = _run_jax_world2(x, y, w, b)

    np.savez(tmp_path / "data.npz", x=x, y=y, w=w, b=b)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, HVD_TPU_SCHED_WIRE="bf16")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = []
    try:
        for r in range(2):
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
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(want["w"], w)  # the step moved the weights


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
        for m, o in ((model, opt), (ref, ref_opt)):
            m(x).sum().backward()
            o.step()
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
