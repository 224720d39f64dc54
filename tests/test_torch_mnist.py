"""The MNIST models and example of the port against the JAX package's.

* ``MnistCNN`` and ``MnistMLP`` carry the flax parameters across with
  ``load_jax_params`` and agree on the logits of one numpy batch to
  rtol 1e-5 / atol 1e-5 (float32; the packages sum the convolutions and
  dot products in different orders, ~1e-7 relative).
* ``examples/torch_port_mnist.py --device cpu`` in a gloo world of two
  prints a loss per step; the JAX ``DistributedOptimizer`` on two
  virtual CPU devices, from the same initial weights on the same
  shards, gives the same losses to rtol 1e-4: eight steps of SGD with
  momentum pass the float32 differences through the updates (measured
  under 1e-6).
* ``--use-adasum`` (``op=Adasum``, the learning rate scaled by
  ``local_size()``) in the same gloo world of two against the JAX
  ``DistributedOptimizer(op=Adasum)`` of ``examples/mnist.py
  --use-adasum`` on two virtual devices, to the same rtol 1e-4 (the
  float32 dot products of Adasum's coefficients are summed in other
  orders too); at a world of one Adasum changes nothing, so the run's
  losses are the plain run's.
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu.models.mnist import MnistCNN as JaxCNN
from horovod_tpu.models.mnist import MnistMLP as JaxMLP
from horovod_tpu_torch.models import mnist as tmnist

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "torch_port_mnist.py")


def _example():
    """The example as a module, loaded from its file."""
    spec = importlib.util.spec_from_file_location("torch_port_mnist", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flax(model, x):
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return params, jax.jit(model.apply)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_forward_matches_flax(kind):
    x = np.random.default_rng(0).random((6, 28, 28, 1)).astype(np.float32)
    jmodel, tmodel = ((JaxCNN(), tmnist.MnistCNN(device="cpu")) if kind == "cnn"
                      else (JaxMLP(hidden=32), tmnist.MnistMLP(32, device="cpu")))
    params, apply = _flax(jmodel, x)
    sd = tmnist.load_jax_params(jax.tree.map(np.asarray, params["params"]))
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    tmodel.load_state_dict(sd)
    want = np.asarray(apply(params, jnp.asarray(x)))
    got = tmodel(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _to_flax(model):
    """The port's CNN weights as the flax tree (the inverse map)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = {}
    for i in range(2):
        tree[f"Conv_{i}"] = {"kernel": sd[f"conv{i}.weight"].transpose(2, 3, 1, 0),
                             "bias": sd[f"conv{i}.bias"]}
        tree[f"Dense_{i}"] = {"kernel": sd[f"fc{i}.weight"].T, "bias": sd[f"fc{i}.bias"]}
    return {"params": jax.tree.map(jnp.asarray, tree)}


def _jax_losses(samples, batch, lr, momentum, adasum=False):
    """``examples/mnist.py``'s loop on two virtual devices from the
    port's seed-0 weights: one loss per step (``adasum``: ``op=Adasum``
    and the learning rate scaled by the local size, 2 here)."""
    synthetic_mnist = _example().synthetic_mnist
    params = _to_flax(tmnist.MnistCNN(seed=0, device="cpu"))
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:2])
    try:
        model = JaxCNN()
        tx = hvd.DistributedOptimizer(optax.sgd(lr * 2, momentum=momentum),
                                      op=hvd.Adasum if adasum else hvd.Average)

        def loss_fn(p, b):
            logits = model.apply(p, b[0])
            return optax.softmax_cross_entropy_with_integer_labels(logits, b[1]).mean()

        step = hvd.distributed_train_step(loss_fn, tx)
        state = step.init(params)
        X, Y = synthetic_mnist(n=samples)
        perm = np.random.RandomState(0).permutation(len(X))
        losses = []
        for i in range(len(X) // (2 * batch)):
            idx = perm[i * 2 * batch:(i + 1) * 2 * batch]
            params, state, loss = step(params, state,
                                       (jnp.asarray(X[idx]), jnp.asarray(Y[idx])))
            losses.append(float(loss))
        return losses
    finally:
        hvd.shutdown()


def _world2_losses(tmp_path, samples, batch, *extra):
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "HVD_TPU_SCHED_WIRE", "HVD_TPU_TOPO"):
        env.pop(k, None)
    cmd = [sys.executable, EXAMPLE, "--device", "cpu", "--epochs", "1",
           "--num-samples", str(samples), "--batch-size", str(batch),
           "--log-every", "1", "--world-size", "2",
           "--init-method", f"file://{tmp_path / 'store'}", *extra]
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                cmd + ["--rank", str(r)], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text
    assert "2 rank(s) on cpu" in outs[0] and outs[1].strip() == ""
    return [float(v) for v in re.findall(r"step \d+/\d+ loss ([0-9.]+)", outs[0])]


def test_example_world2_adasum_losses_match_jax(tmp_path):
    samples, batch = 256, 32
    got = _world2_losses(tmp_path, samples, batch, "--use-adasum")
    want = _jax_losses(samples, batch, 0.01, 0.5, adasum=True)
    assert len(got) == len(want) == samples // (2 * batch)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_example_world2_losses_match_jax(tmp_path):
    samples, batch = 512, 32
    got = _world2_losses(tmp_path, samples, batch)
    want = _jax_losses(samples, batch, 0.01, 0.5)
    assert len(got) == len(want) == samples // (2 * batch)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_example_refuses_adasum(capsys):
    """Kept under its first name: ``--use-adasum`` runs now; at a world of
    one it gives the plain run's losses."""
    main = _example().main
    args = ["--device", "cpu", "--num-samples", "128", "--epochs", "1", "--batch-size",
            "32", "--log-every", "1"]
    losses = []
    for extra in ([], ["--use-adasum"]):
        main(args + extra)
        losses.append(re.findall(r"loss ([0-9.]+)", capsys.readouterr().out))
    assert losses[0] == losses[1] and len(losses[0]) == 4
