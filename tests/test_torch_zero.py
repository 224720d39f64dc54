"""The port's ZeRO-1 and FSDP steps against the JAX package's.

The counterparts of ``tests/test_zero.py`` on its problem (a linear
regression: ``w [5, 3]``, ``b [3]``, 32 rows, the mean squared error),
in one gloo world of four processes, rank r taking rows ``8r:8r+8``.
The JAX side runs ``horovod_tpu.optim.zero`` on ``jax.devices()[:4]``
(``hvd.init(devices=...)``: the same world) while the ranks run, and the
unsharded reference is one PyTorch optimizer on all 32 rows.  The port's
module registers ``b`` before ``w``, so its flat layout (module order) is
the JAX package's (sorted keys) here; the tests still compare gathered
parameters, not shards.

* ZeRO-1, five steps of SGD (lr 0.1, momentum 0.9) and of AdamW (lr
  1e-2, weight decay 1e-4): the parameters against the JAX step and
  against the unsharded optimizer to rtol 1e-5, atol 1e-5
  (``test_zero.py``'s tolerance: float32 sums over ranks and
  optimizer arithmetic in another order); the losses to rtol 1e-5.
  Thirty AdamW steps (lr 5e-2) take the loss below 0.3 of the first.
* The optimizer state is sharded: AdamW's moments hold ``padded / 4``
  elements on every rank, ``padded`` the parameter count rounded up to
  a multiple of four.
* ZeRO-1 on the int8 wire with error feedback, three SGD steps: against
  the JAX int8 step to one quantization step of the update (ROADMAP
  Queue C's block-layout and FMA divergences: the port rounds each
  product where XLA:CPU fuses it, which may move an element to the next
  grid point; the lr 0.1 times 2^-7 of the largest gradient element,
  per step; measured 1.2e-7), with non-zero residuals on every rank.
* ``clip_by_global_norm`` as ZeRO-1's ``pre_update`` (max norm 0.05,
  below the gradient's): against the JAX step to rtol 1e-5, atol 1e-6;
  ``global_norm`` of the shards equals the unsharded norm to rtol 1e-6.
* FSDP, five steps of SGD and of AdamW: the gathered parameters against
  the JAX step's and the unsharded optimizer's to rtol 1e-4, atol 1e-5
  (``test_zero.py``'s); the parameters and AdamW's moments are
  ``shard_len`` long; forty AdamW steps take the loss below half the
  first.
* FSDP restored from shards with ``example_params`` on the meta device
  (no ``init``): ``gather`` bitwise with the first step's, and a step
  runs; without a layout, ``gather`` raises naming ``example_params``.
* FSDP with ``Compression.bf16`` on the reduce-scatter, three SGD steps:
  within rtol 2e-2, atol 2e-3 of the uncompressed step
  (``test_zero.py``'s), and of the JAX bf16 step to what the sum's
  rounding allows: gloo adds the ranks' bf16 gradients in bf16, one
  rounding (2^-9 of the partial sum) per addition, where XLA:CPU adds
  them in float32 and rounds once, so each step's update may differ by
  ``lr·(N − 1)·2^-9·N·G/N``, G the largest element of a rank's gradient
  at the start (three steps: three times that; measured 7.8e-4 against
  a bound of 5.4e-3).
* ``examples/torch_fsdp_gpt.py`` runs three steps of ``gpt_tiny`` on two
  gloo ranks and prints the JAX example's lines.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
import horovod_tpu_torch as thvd
from horovod_tpu.optim import zero as jzero

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS = 4, 5
OPTS = {"sgd": (lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
                lambda: optax.sgd(0.1, momentum=0.9)),
        "adamw": (lambda p: torch.optim.AdamW(p, lr=1e-2, weight_decay=1e-4),
                  lambda: optax.adamw(1e-2, weight_decay=1e-4))}

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60)
    data = dict(np.load(out + "/data.npz"))
    rows = slice(8 * rank, 8 * rank + 8)
    batch = (torch.from_numpy(data["x"][rows]), torch.from_numpy(data["y"][rows]))
    res = {}

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.b = torch.nn.Parameter(torch.from_numpy(data["b"].copy()))
            self.w = torch.nn.Parameter(torch.from_numpy(data["w"].copy()))

        def forward(self, x):
            return x @ self.w + self.b

    def zero_loss(model, batch):
        x, y = batch
        return torch.mean((model(x) - y) ** 2)

    def fsdp_loss(params, batch):
        x, y = batch
        return torch.mean((x @ params["w"] + params["b"] - y) ** 2)

    OPTS = {"sgd": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
            "adamw": lambda p: torch.optim.AdamW(p, lr=1e-2, weight_decay=1e-4),
            "adamw5": lambda p: torch.optim.AdamW(p, lr=5e-2, weight_decay=1e-4),
            "sgd1": lambda p: torch.optim.SGD(p, lr=0.1)}

    def put(prefix, named):
        for k, v in named.items():
            res[f"{prefix}|{k}"] = v.detach().numpy().copy()

    try:
        for name in ("sgd", "adamw"):
            step = hvd.zero_train_step(zero_loss, OPTS[name], wire="off")
            model = Linear()
            state = step.init(model)
            losses = []
            for _ in range(STEPS_LITERAL):
                model, state, loss = step(model, state, batch)
                losses.append(float(loss))
            put("zero|" + name, dict(model.named_parameters()))
            res[f"zero|{name}|losses"] = np.array(losses)
            if name == "adamw":
                st = state.optimizer.state[state.shard]
                res["zero_state"] = np.array([state.padded, state.shard_len,
                                              st["exp_avg"].numel(), st["exp_avg_sq"].numel()])

        step = hvd.zero_train_step(zero_loss, OPTS["adamw5"], wire="off")
        model = Linear()
        state = step.init(model)
        res["zero_conv"] = np.array([float(step(model, state, batch)[2]) for _ in range(30)])

        step = hvd.zero_train_step(zero_loss, OPTS["sgd1"], wire="int8")
        model = Linear()
        state = step.init(model)
        for _ in range(3):
            step(model, state, batch)
        put("zero_int8", dict(model.named_parameters()))
        res["zero_int8|ef"] = state.ef.numpy().copy()

        step = hvd.zero_train_step(zero_loss, OPTS["sgd1"], wire="off",
                                   pre_update=hvd.clip_by_global_norm(0.05))
        model = Linear()
        state = step.init(model)
        for _ in range(3):
            step(model, state, batch)
        put("clip", dict(model.named_parameters()))
        model = Linear()  # every rank shards the same, full-batch gradient
        zero_loss(model, (torch.from_numpy(data["x"]), torch.from_numpy(data["y"]))).backward()
        g = torch.cat([model.b.grad, model.w.grad.reshape(-1)])
        g = torch.nn.functional.pad(g, (0, -(-g.numel() // n) * n - g.numel()))
        shard = g.numel() // n
        res["global_norm"] = hvd.global_norm(g[rank * shard:(rank + 1) * shard]).numpy()

        for name in ("sgd", "adamw"):
            step = hvd.fsdp_train_step(fsdp_loss, OPTS[name])
            pshard, opt = step.init(dict(Linear().named_parameters()))
            losses = []
            for _ in range(STEPS_LITERAL):
                pshard, opt, loss = step(pshard, opt, batch)
                losses.append(float(loss))
            put("fsdp|" + name, step.gather(pshard))
            res[f"fsdp|{name}|losses"] = np.array(losses)
            if name == "adamw":
                st = opt.state[pshard]
                res["fsdp_state"] = np.array([pshard.numel(), st["exp_avg"].numel(),
                                              st["exp_avg_sq"].numel()])

        step = hvd.fsdp_train_step(fsdp_loss, OPTS["adamw5"])
        pshard, opt = step.init(dict(Linear().named_parameters()))
        res["fsdp_conv"] = np.array([float(step(pshard, opt, batch)[2]) for _ in range(40)])

        step1 = hvd.fsdp_train_step(fsdp_loss, OPTS["sgd1"])
        pshard, opt = step1.init(dict(Linear().named_parameters()))
        pshard, opt, _ = step1(pshard, opt, batch)
        put("restore_trained", step1.gather(pshard))
        step2 = hvd.fsdp_train_step(fsdp_loss, OPTS["sgd1"],
                                    example_params=Linear().to("meta"))
        put("restore_restored", step2.gather(pshard))
        res["restore_loss"] = np.array(float(step2(pshard, opt, batch)[2]))

        for comp in ("bf16", "none"):
            step = hvd.fsdp_train_step(fsdp_loss, OPTS["sgd1"],
                                       compression=getattr(hvd.Compression, comp))
            pshard, opt = step.init(dict(Linear().named_parameters()))
            for _ in range(3):
                pshard, opt, _ = step(pshard, opt, batch)
            put("fsdp_" + comp, step.gather(pshard))
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""").replace("STEPS_LITERAL", str(STEPS))


def _data():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(5, 3).astype(np.float32), "b": np.zeros(3, np.float32),
            "x": rng.randn(32, 5).astype(np.float32), "y": rng.randn(32, 3).astype(np.float32)}


def _jloss(p, batch):
    xb, yb = batch
    return jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2)


def _jax_world(d):
    hvd.init(devices=jax.devices()[:N])
    try:
        params = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
        batch = (jnp.asarray(d["x"]), jnp.asarray(d["y"]))
        want = {}

        def put(prefix, tree):
            for k, v in tree.items():
                want[f"{prefix}|{k}"] = np.asarray(v)

        def zero(tx, steps, **kw):
            step = jzero.zero_train_step(_jloss, tx, **kw)
            st = step.init(params)
            p, losses = jax.tree.map(jnp.array, params), []
            for _ in range(steps):
                p, st, loss = step(p, st, batch)
                losses.append(float(loss))
            return p, losses

        def fsdp(tx, steps, **kw):
            step = jzero.fsdp_train_step(_jloss, tx, **kw)
            ps, st = step.init(params)
            losses = []
            for _ in range(steps):
                ps, st, loss = step(ps, st, batch)
                losses.append(float(loss))
            return step.gather(ps), losses

        for name, (_, make) in OPTS.items():
            p, losses = zero(make(), STEPS)
            put("zero|" + name, p)
            want[f"zero|{name}|losses"] = np.array(losses)
            p, losses = fsdp(make(), STEPS)
            put("fsdp|" + name, p)
            want[f"fsdp|{name}|losses"] = np.array(losses)
        put("zero_int8", zero(optax.sgd(0.1), 3, wire="int8")[0])
        put("clip", zero(optax.sgd(0.1), 3, pre_update=jzero.clip_by_global_norm(0.05))[0])
        put("fsdp_bf16", fsdp(optax.sgd(0.1), 3, compression=hvd.Compression.bf16)[0])
        g = jax.grad(_jloss)(params, batch)
        want["global_norm"] = np.asarray(optax.global_norm(g))
        return want
    finally:
        hvd.shutdown()


def _unsharded(d):
    """The unsharded optimizers on all 32 rows, five steps each."""
    out = {}
    for name, (make, _) in OPTS.items():
        w = torch.nn.Parameter(torch.from_numpy(d["w"].copy()))
        b = torch.nn.Parameter(torch.from_numpy(d["b"].copy()))
        opt = make([b, w])
        for _ in range(STEPS):
            opt.zero_grad()
            loss = torch.mean((torch.from_numpy(d["x"]) @ w + b - torch.from_numpy(d["y"])) ** 2)
            loss.backward()
            opt.step()
        out[name] = {"w": w.detach().numpy(), "b": b.detach().numpy()}
    return out


def _run_world(tmp):
    d = _data()
    np.savez(tmp / "data.npz", **d)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_SCHED_WIRE", "HVD_TPU_SCHED_WIRE_EF",
              "HVD_TPU_QUANT_BLOCK", "HVD_TPU_QUANT_BACKEND"):
        env.pop(k, None)
    procs = []
    try:
        for r in range(N):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(N), str(tmp / "store"), str(tmp)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        hvd.shutdown()
        want = _jax_world(d)  # while the ranks run
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        hvd.shutdown()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return d, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)], want, _unsharded(d)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Computed once: under xdist by the first worker that needs it (a
    file under the session's shared temporary root, behind a lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_zero_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        result = _run_world(tmp_path_factory.mktemp("zero"))
        with open(path, "wb") as f:
            pickle.dump(result, f)
    return result


@pytest.mark.parametrize("kind,rtol", [("zero", 1e-5), ("fsdp", 1e-4)])
@pytest.mark.parametrize("name", list(OPTS))
def test_matches_the_unsharded_step_and_jax(world, kind, rtol, name):
    _, ranks, want, ref = world
    for got in ranks:
        for leaf in ("w", "b"):
            g = got[f"{kind}|{name}|{leaf}"]
            np.testing.assert_allclose(g, want[f"{kind}|{name}|{leaf}"], rtol=rtol, atol=1e-5)
            np.testing.assert_allclose(g, ref[name][leaf], rtol=rtol, atol=1e-5)
        np.testing.assert_allclose(got[f"{kind}|{name}|losses"], want[f"{kind}|{name}|losses"],
                                   rtol=1e-5)
    for leaf in ("w", "b"):  # the replicas agree bitwise
        for got in ranks[1:]:
            np.testing.assert_array_equal(got[f"{kind}|{name}|{leaf}"],
                                          ranks[0][f"{kind}|{name}|{leaf}"])


def test_zero_state_is_sharded(world):
    _, ranks, _, _ = world
    for got in ranks:
        padded, shard_len, mu, nu = (int(v) for v in got["zero_state"])
        assert padded == 20 and shard_len == padded // N == mu == nu


@pytest.mark.parametrize("kind,ratio", [("zero_conv", 0.3), ("fsdp_conv", 0.5)])
def test_training_converges(world, kind, ratio):
    _, ranks, _, _ = world
    losses = ranks[0][kind]
    assert losses[-1] < losses[0] * ratio, (losses[0], losses[-1])


def test_zero_int8_wire_with_error_feedback_matches_jax(world):
    d, ranks, want, _ = world
    x, y = d["x"], d["y"]
    g_max = np.abs(2 * x.T @ (x @ d["w"] - y) / y.size).max()
    grid = 0.1 * g_max / 127  # one int8 step of an update, per step
    for got in ranks:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got["zero_int8|" + leaf], want["zero_int8|" + leaf],
                                       rtol=0, atol=3 * grid)
        assert np.abs(got["zero_int8|ef"]).max() > 0
        assert got["zero_int8|ef"].shape == (N * 512,)


def test_clip_by_global_norm_matches_jax(world):
    _, ranks, want, _ = world
    for got in ranks:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got["clip|" + leaf], want["clip|" + leaf],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["global_norm"], want["global_norm"], rtol=1e-6)
    assert float(want["global_norm"]) > 0.05  # the clip engaged


def test_fsdp_params_and_adam_state_are_sharded(world):
    _, ranks, _, _ = world
    for got in ranks:
        assert [int(v) for v in got["fsdp_state"]] == [5, 5, 5]  # 18 -> 20 / 4


def test_fsdp_restore_without_full_params(world):
    _, ranks, _, _ = world
    for got in ranks:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got["restore_restored|" + leaf],
                                          got["restore_trained|" + leaf])
        assert np.isfinite(got["restore_loss"])


def test_fsdp_layout_required_error():
    thvd.init("cpu")
    try:
        step = thvd.fsdp_train_step(lambda p, b: 0.0, lambda p: torch.optim.SGD(p, lr=0.1))
        with pytest.raises(RuntimeError, match="example_params"):
            step.gather(torch.zeros(8))
    finally:
        thvd.shutdown()


def _bf16_bound(d):
    """3 steps x lr x (N - 1) roundings of 2^-9 of a sum of N local
    gradients, over N (the average)."""
    x, y = d["x"].reshape(N, 8, 5), d["y"].reshape(N, 8, 3)
    g = max(np.abs(2 * xr.T @ (xr @ d["w"] - yr) / yr.size).max() for xr, yr in zip(x, y))
    return 3 * 0.1 * (N - 1) * 2.0 ** -9 * g


def test_fsdp_bf16_wire_compression(world):
    d, ranks, want, _ = world
    for got in ranks:
        np.testing.assert_allclose(got["fsdp_bf16|w"], got["fsdp_none|w"], rtol=2e-2,
                                   atol=2e-3)
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got["fsdp_bf16|" + leaf], want["fsdp_bf16|" + leaf],
                                       rtol=0, atol=_bf16_bound(d))
        assert not np.array_equal(got["fsdp_bf16|w"], got["fsdp_none|w"])


def test_the_fsdp_example_runs(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK") and not k.startswith("HVD_TPU_")}
    env["PYTHONPATH"] = ROOT
    cmd = [sys.executable, os.path.join(ROOT, "examples", "torch_fsdp_gpt.py"), "--device",
           "cpu", "--steps", "3", "--seq", "32", "--init-method",
           f"file://{tmp_path / 'store'}", "--world-size", "2", "--rank"]
    procs = [subprocess.Popen(cmd + [str(r)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = outs[0].strip().splitlines()
    assert lines[0].startswith("params 0.1M; per-chip shard 0.04M elems"), lines
    assert lines[1].startswith("step   0  loss ") and lines[2].startswith("step   2  loss ")
    assert lines[-1] == "gathered eval logits: (1, 32, 256)", lines
