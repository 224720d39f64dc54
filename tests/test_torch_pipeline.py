"""The port's GPipe pipeline against the JAX package's.

One gloo world of four processes (``pp4``, one stage a rank: ``tanh(h @
w + b)``, six microbatches of ``[2, 8]``), against
``horovod_tpu.parallel.pipeline_apply`` under ``shard_map`` on
``jax.devices()[:4]`` (``check_vma=False``, computed while the ranks
run), rank r against device r, with ``broadcast_outputs`` on and off and
``remat_stage`` off and on:

* the outputs to 2e-6 absolute (float32 products in another order;
  measured 2.4e-7), and with ``broadcast_outputs`` every rank's
  against the sequential application of the four stages;
* each stage's gradients of ``sum(out · wts)`` to 1e-6 of their largest
  element (measured 4.8e-7).  As under ``shard_map(check_vma=False)``,
  each rank's gradient is that of the sum of every rank's loss: with
  ``broadcast_outputs`` the four ranks' losses are equal, so it is four
  times the sequential model's gradient (held too), without it the last
  stage's loss alone;
* ``remat_stage=True`` gives gradients bitwise equal to ``False``.
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
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import pipeline_apply as jax_pipeline

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, B, F = 4, 6, 2, 8
CASES = [(bo, rm) for bo in (True, False) for rm in (False, True)]

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import make_mesh, pipeline_apply

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60)
    data = dict(np.load(out + "/data.npz"))
    res = {}

    def stage(params, h):
        w, b = params
        return torch.tanh(h @ w + b)

    try:
        mesh = make_mesh(pp=4)
        for bo in (True, False):
            for rm in (False, True):
                w = torch.from_numpy(data["w"][rank].copy()).requires_grad_()
                b = torch.from_numpy(data["b"][rank].copy()).requires_grad_()
                x = torch.from_numpy(data["x"].copy())
                o = pipeline_apply(stage, (w, b), x, mesh, broadcast_outputs=bo,
                                   remat_stage=rm)
                (o * torch.from_numpy(data["wts"])).sum().backward()
                key = f"{int(bo)}{int(rm)}"
                res[key + "|out"] = o.detach().numpy()
                res[key + "|dw"], res[key + "|db"] = w.grad.numpy(), b.grad.numpy()
        mesh.shutdown()
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""")


def _data():
    rng = np.random.default_rng(21)
    return {"w": (rng.standard_normal((N, F, F)) * 0.4).astype(np.float32),
            "b": (rng.standard_normal((N, F)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((M, B, F)).astype(np.float32),
            "wts": rng.standard_normal((M, B, F)).astype(np.float32)}


def _stage(params, h):
    w, b = params
    return jnp.tanh(h @ w + b)


def _jax_world(d):
    mesh = jax_make_mesh(devices=jax.devices()[:N], pp=4)
    want = {}
    for bo, rm in CASES:
        def body(w, b, x, wts, bo=bo, rm=rm):
            def loss(w, b):
                out = jax_pipeline(_stage, (w[0], b[0]), x, axis="pp",
                                   broadcast_outputs=bo, remat_stage=rm)
                return jnp.sum(out * wts), out
            (_, out), (gw, gb) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(w, b)
            return {"out": out[None], "dw": gw, "db": gb}
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pp"), P("pp"), P(), P()),
                              out_specs=P("pp"), check_vma=False))
        out = f(*(jnp.asarray(d[k]) for k in ("w", "b", "x", "wts")))
        want.update({f"{int(bo)}{int(rm)}|{k}": np.asarray(v) for k, v in out.items()})

    def seq_loss(w, b):
        h = jnp.asarray(d["x"])
        for i in range(N):
            h = _stage((w[i], b[i]), h)
        return jnp.sum(h * d["wts"]), h
    (_, h), (gw, gb) = jax.value_and_grad(seq_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(d["w"]), jnp.asarray(d["b"]))
    want["seq|out"], want["seq|dw"], want["seq|db"] = (np.asarray(h), np.asarray(gw),
                                                       np.asarray(gb))
    return want


def _run_world(tmp):
    d = _data()
    np.savez(tmp / "data.npz", **d)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_XIR_WIRE", "HVD_TPU_XIR"):
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
    return d, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)], want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Computed once: under xdist by the first worker that needs it (a
    file under the session's shared temporary root, behind a lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_pipeline_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        result = _run_world(tmp_path_factory.mktemp("pipeline"))
        with open(path, "wb") as f:
            pickle.dump(result, f)
    return result


@pytest.mark.parametrize("bo,rm", CASES)
def test_outputs_match_jax(world, bo, rm):
    _, ranks, want = world
    key = f"{int(bo)}{int(rm)}|out"
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[key], want[key][r], rtol=0, atol=2e-6)
        if bo:
            np.testing.assert_allclose(got[key], want["seq|out"], rtol=0, atol=2e-6)
        elif r < N - 1:
            assert not got[key].any()  # valid on the last stage only


@pytest.mark.parametrize("bo,rm", CASES)
@pytest.mark.parametrize("leaf", ["dw", "db"])
def test_gradients_match_jax_grad(world, bo, rm, leaf):
    _, ranks, want = world
    key = f"{int(bo)}{int(rm)}|{leaf}"
    for r, got in enumerate(ranks):
        w = want[key][r]
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-6 * np.abs(w).max())
        seq = want["seq|" + leaf][r] * (N if bo else 1)
        np.testing.assert_allclose(got[key], seq, rtol=0, atol=1e-6 * np.abs(seq).max())


@pytest.mark.parametrize("bo", [True, False])
def test_remat_stage_gives_the_same_gradients(world, bo):
    _, ranks, _ = world
    for got in ranks:
        for leaf in ("out", "dw", "db"):
            np.testing.assert_array_equal(got[f"{int(bo)}1|{leaf}"], got[f"{int(bo)}0|{leaf}"])
