"""The rest of ``DistributedOptimizer``'s surface, and the object
collectives, against the JAX package or the reference's contract.

* ``groups=``: each list of parameters becomes a pinned bucket; the
  port's plan equals the JAX ``build_schedule(pinned=...)`` of the same
  sizes (exact integer bookkeeping).  A parameter the optimizer does
  not update, or one named twice, raises ``ValueError``.
* ``sparse_as_dense=True``: a sparse COO gradient
  (``nn.Embedding(sparse=True)``) is densified as the JAX ``densify``
  scatter-adds (bitwise on dyadic values with repeated indices), and
  the step then equals the dense embedding's bitwise.  Without the flag
  a sparse gradient raises ``QuantizedWireError`` under a quantized wire;
  otherwise it takes the allgather path of ``ops/sparse.py`` (at a world
  of one, the step equals the dense embedding's bitwise).
* ``backward_passes_per_step`` (and its setter): the update of every
  second step equals the JAX ``DistributedOptimizer(backward_passes_per_
  step=2)``'s bitwise on a dyadic linear problem.
* In a gloo world of three: ``broadcast_object`` and
  ``allgather_object``, and the ``skip_synchronize`` contract: an
  explicit ``synchronize()`` before ``step()`` is not reduced again,
  with or without ``skip_synchronize()``; without the ``synchronize()``
  the local gradients are applied.  In a world of one they return
  the object itself and ``[obj]``; a ``process_set`` that is not a
  registered ``ProcessSet`` raises ``HorovodTpuError``, as the JAX
  package's ``_ps_id`` does, and the global set serves every rank.
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
from horovod_tpu.ops.sparse import IndexedSlices, densify as jax_densify
from horovod_tpu.sched import plan as jplan
from horovod_tpu_torch.exceptions import QuantizedWireError
from horovod_tpu_torch.optim.distributed_optimizer import densify

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world1(monkeypatch):
    for k in ("HVD_TPU_SCHED_WIRE", "HVD_TPU_SCHED", "HVD_TPU_SCHED_CAPTURE_ORDER"):
        monkeypatch.delenv(k, raising=False)
    thvd.init("cpu")
    try:
        yield
    finally:
        thvd.shutdown()


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Linear(5, 12), torch.nn.ReLU(), torch.nn.Linear(12, 9),
        torch.nn.ReLU(), torch.nn.Linear(9, 7), torch.nn.ReLU(),
        torch.nn.Linear(7, 2),
    )


@pytest.mark.parametrize("group_idx", [[[0, 5]], [[6, 1, 2], [7]], [[3], [4]]])
def test_groups_plan_matches_jax_pinned(world1, monkeypatch, group_idx):
    """The capture order off, so both plans take the reversed
    registration order."""
    monkeypatch.setenv("HVD_TPU_SCHED_CAPTURE_ORDER", "0")
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")
    model = _mlp()
    params = list(model.parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1), fusion_threshold_bytes=300,
        groups=[[params[i] for i in g] for g in group_idx],
    )
    model(torch.ones(3, 5)).sum().backward()
    opt.step()
    sizes = [p.numel() * 4 for p in params]
    want = jplan.build_schedule(
        sizes, ["float32"] * len(sizes),
        jplan.SchedConfig(bucket_bytes=300, lowering="flat", wire="bf16"),
        pinned=group_idx,
    )
    got = opt.schedule
    assert [tuple(b.indices) for b in want.buckets] == [b.indices for b in got.buckets]
    assert [b.nbytes for b in want.buckets] == [b.nbytes for b in got.buckets]
    assert [b.pinned for b in want.buckets] == [b.pinned for b in got.buckets]
    assert [b.wire for b in want.buckets] == [b.wire for b in got.buckets]


def test_groups_refuse_foreign_and_repeated_parameters(world1):
    model = _mlp()
    params = list(model.parameters())
    other = torch.nn.Linear(2, 2)
    for groups in ([[params[0], other.weight]], [[params[0]], [params[1], params[0]]]):
        with pytest.raises(ValueError, match="groups names a parameter"):
            thvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                      groups=groups)


def _sparse_problem():
    rng = np.random.default_rng(5)
    idx = np.array([3, 0, 3, 7, 1, 3], np.int64)  # repeats sum
    vals = rng.integers(-8, 9, (6, 4)).astype(np.float32) / 8
    return idx, vals


def test_densify_matches_jax():
    idx, vals = _sparse_problem()
    want = np.asarray(jax_densify(IndexedSlices(
        jnp.asarray(idx, jnp.int32), jnp.asarray(vals), (9, 4))))
    g = torch.sparse_coo_tensor(torch.from_numpy(idx)[None],
                                torch.from_numpy(vals), (9, 4))
    np.testing.assert_array_equal(densify(g).numpy(), want)


class _Embed(torch.nn.Module):
    def __init__(self, sparse):
        super().__init__()
        torch.manual_seed(1)
        self.emb = torch.nn.Embedding(9, 4, sparse=sparse)
        self.fc = torch.nn.Linear(4, 1)
        with torch.no_grad():  # dyadic weights: every sum is exact
            self.emb.weight.copy_(torch.round(self.emb.weight * 8) / 8)
            self.fc.weight.copy_(torch.round(self.fc.weight * 8) / 8)

    def forward(self, ids):
        return self.fc(self.emb(ids)).sum()


@pytest.mark.parametrize("wire", ["off", "int8"])
def test_sparse_as_dense_matches_the_dense_embedding(world1, monkeypatch, wire):
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)
    ids = torch.tensor([[3, 0, 3], [7, 1, 3]])
    weights = []
    for sparse in (True, False):
        model = _Embed(sparse)
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.5),
            sparse_as_dense=sparse,
        )
        for _ in range(3):
            model(ids).backward()
            if sparse:
                assert model.emb.weight.grad.is_sparse
            opt.step()
            opt.zero_grad()
        weights.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*weights):
        assert torch.equal(a, b)
    assert not torch.equal(weights[0][0], _Embed(False).emb.weight)


@pytest.mark.parametrize("request_wire,error", [
    ("none", NotImplementedError), ("knob", QuantizedWireError),
    ("compressor", QuantizedWireError),
])
def test_sparse_gradient_without_sparse_as_dense_raises(world1, monkeypatch,
                                                        request_wire, error):
    if request_wire == "knob":
        monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "int8")
    model = _Embed(True)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        compression=thvd.Compression.int8 if request_wire == "compressor"
        else thvd.Compression.none,
    )
    model(torch.tensor([[1, 2]])).backward()
    if error is NotImplementedError:
        # Kept under its first name: the sparse path is ported now, and
        # the step equals the dense embedding's.
        opt.step()
        dense = _Embed(False)
        dopt = thvd.DistributedOptimizer(torch.optim.SGD(dense.parameters(), lr=0.5))
        dense(torch.tensor([[1, 2]])).backward()
        dopt.step()
        for a, b in zip(model.parameters(), dense.parameters()):
            assert torch.equal(a, b)
        return
    with pytest.raises(error):
        opt.step()


def _dyadic_linear():
    rng = np.random.default_rng(7)
    xs = rng.integers(-2, 3, (4, 6, 3)).astype(np.float32) / 2
    ys = rng.integers(-2, 3, (4, 6, 1)).astype(np.float32) / 4
    w = rng.integers(-2, 3, (3, 1)).astype(np.float32) / 8
    return xs, ys, w


def _jax_two_pass(xs, ys, w):
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    try:
        step = hvd.distributed_train_step(
            lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2),
            hvd.DistributedOptimizer(optax.sgd(0.5), backward_passes_per_step=2),
        )
        params = {"w": jnp.asarray(w)}
        state = step.init(params)
        out = []
        for x, y in zip(xs, ys):
            params, state, _ = step(params, state, (jnp.asarray(x), jnp.asarray(y)))
            out.append(np.array(params["w"]))
        return out
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("how", ["constructor", "setter"])
def test_backward_passes_per_step_matches_jax(world1, how):
    xs, ys, w = _dyadic_linear()
    want = _jax_two_pass(xs, ys, w)
    model = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w.T))
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        backward_passes_per_step=2 if how == "constructor" else 1,
    )
    if how == "setter":
        opt.set_backward_passes_per_step(2)
    assert opt.backward_passes_per_step == 2
    step = thvd.TrainStep(model, opt,
                          lambda m, b: ((m(b[0]) - b[1]) ** 2).mean())
    for x, y, wj in zip(xs, ys, want):
        step((torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_array_equal(model.weight.detach().numpy().T, wj)
    with pytest.raises(ValueError):
        opt.set_backward_passes_per_step(0)


def test_object_collectives_in_a_world_of_one(world1):
    obj = {"epoch": 3, "names": ["a", "b"]}
    assert thvd.broadcast_object(obj, root_rank=0, name="state") is obj
    assert thvd.allgather_object(obj) == [obj]
    for bad in (object(), thvd.ProcessSet([0])):
        for fn in (lambda: thvd.broadcast_object(obj, process_set=bad),
                   lambda: thvd.allgather_object(obj, process_set=bad)):
            with pytest.raises(thvd.exceptions.HorovodTpuError):
                fn()
    world = thvd.global_process_set()
    assert thvd.broadcast_object(obj, process_set=world) is obj
    assert thvd.allgather_object(obj, process_set=world) == [obj]


_WORKER3 = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=3,
             timeout_s=100)
    try:
        got = {
            "bcast0": hvd.broadcast_object({"from": rank, "v": [rank] * 2}),
            "bcast2": hvd.broadcast_object(("r", rank), root_rank=2, name="t"),
            "gather": hvd.allgather_object({"rank": rank, "sq": rank * rank}),
        }
        # op=Sum on dyadic gradients: a second reduction would triple them.
        grads = {}
        for mode in ("skip", "plain", "drop"):
            torch.manual_seed(0)
            model = torch.nn.Linear(3, 2)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.0),
                named_parameters=model.named_parameters(), op=hvd.Sum)
            x = torch.full((2, 3), 0.5 * (rank + 1))
            for _ in range(2):  # the second backward launches from its hooks
                model(x).sum().backward()
                if mode != "drop":
                    opt.synchronize()
                grads[mode] = [p.grad.clone().numpy().tolist()
                               for p in model.parameters()]
                if mode != "plain":
                    with opt.skip_synchronize():
                        opt.step()
                else:
                    opt.step()
                grads[mode + "_after"] = [p.grad.clone().numpy().tolist()
                                          for p in model.parameters()]
                opt.zero_grad()
        got["grads"] = grads
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(got, f)
    finally:
        hvd.shutdown()
""")


def test_world3_object_collectives_and_skip_synchronize(tmp_path):
    import json

    script = tmp_path / "worker.py"
    script.write_text(_WORKER3)
    env = dict(os.environ, PYTHONPATH=ROOT, HVD_TPU_SCHED_BARRIERS="1")
    for k in ("RANK", "WORLD_SIZE", "HVD_TPU_SCHED_WIRE"):
        env.pop(k, None)
    procs = []
    try:
        for r in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(tmp_path / "store"),
                 str(tmp_path)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(3)]
    # d(sum(W x + b))/dW = column sums of x = 2·0.5·(r+1) per entry, db = 2.
    want_w = [[1.0 * sum(r + 1 for r in range(3))] * 3] * 2
    want = [want_w, [6.0, 6.0]]
    for r, got in enumerate(ranks):
        assert got["bcast0"] == {"from": 0, "v": [0, 0]}
        assert got["bcast2"] == ["r", 2]
        assert got["gather"] == [{"rank": i, "sq": i * i} for i in range(3)]
        for mode in ("skip", "plain"):
            assert got["grads"][mode] == want
            assert got["grads"][mode + "_after"] == want
        # skip_synchronize() alone: the local gradients are applied; the
        # buckets the second backward launched are finished and dropped.
        local = [[[float(r + 1)] * 3] * 2, [2.0, 2.0]]
        assert got["grads"]["drop"] == local
        assert got["grads"]["drop_after"] == local
