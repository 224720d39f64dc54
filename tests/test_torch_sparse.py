"""The port's sparse gradients against ``horovod_tpu/ops/sparse.py``.

One gloo world of four with the set {0,1,2} registered, run once (the
JAX side computed while it runs, shared across xdist workers behind a
``filelock``).  Each rank holds its own sparse COO tensor (10 x 4,
sparse along dim 0; ranks touch 3, 5, 2 and 4 rows, with repeats, so
the gathers are uneven), dyadic values:

* ``sparse_allreduce`` (Average and Sum) and ``sparse_allreduce_eager``
  over the world and over {0,1,2}, densified, against the JAX
  ``sparse_allreduce`` in ``shard_map`` on four CPU devices (each rank's
  ``IndexedSlices`` padded to the largest count with index 0 and zero
  rows, the JAX package's padding) and the JAX eager form on the stacked
  slices: bitwise (dyadic sums are exact in any order; the Average by 4
  is exact), but the Average over {0,1,2}: each row is divided by 3
  and rounded (the port divides, XLA may multiply by float32(1/3)),
  then rows at one index are summed in another order, so an element is
  a few float32 roundings off (rtol 1e-6, atol 1e-7; weights after the
  steps on {0,1,2}, 1e-6).
* The optimizer's sparse path: an ``nn.Embedding(10, 4, sparse=True)``
  and a linear head, two SGD steps (lr 1) of ``DistributedOptimizer``
  without ``sparse_as_dense`` (plain, with ``Compression.fp16`` and a
  prescale, and on {0,1,2}, where rank 3 keeps its own gradient),
  against the JAX ``DistributedOptimizer`` on the same weights with the
  embedding's gradient as ``IndexedSlices``
  (``dense_grad_to_indexed_slices``): bitwise but on {0,1,2} (above);
  and the step equals
  ``sparse_as_dense=True``'s.
* ``HVD_TPU_XIR_WIRE`` on the rows follows the shuffle rule
  (``parallel/wire.py``): int8 rides dense, bf16 on float32 rows raises
  naming ROADMAP Queue A entry A12 (rest).
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
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.ops import sparse as jsparse
from horovod_tpu.ops import traced
from horovod_tpu.runtime import WORLD_AXIS, get_runtime

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, ROWS, D = 4, 10, 4
NNZ = (3, 5, 2, 4)

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.sparse import densify

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    s012 = hvd.ProcessSet([0, 1, 2])
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60,
             process_sets=[s012])
    data = dict(np.load(out + "/data.npz"))
    res = {}
    try:
        idx, vals = data[f"idx{rank}"], data[f"vals{rank}"]
        t = torch.sparse_coo_tensor(torch.from_numpy(idx)[None], torch.from_numpy(vals),
                                    (10, 4), check_invariants=False)
        for tag, ps in (("world", None), ("set", s012)):
            for op_tag, op in (("avg", hvd.Average), ("sum", hvd.Sum)):
                res[f"ar|{tag}|{op_tag}"] = densify(hvd.sparse_allreduce(
                    t, op=op, process_set=ps)).numpy()
            res[f"eager|{tag}"] = densify(hvd.sparse_allreduce_eager(
                t, process_set=ps)).numpy()
        for kind in ("plain", "fp16", "set", "dense"):
            emb = torch.nn.Embedding(10, 4, sparse=True)
            head = torch.nn.Linear(4, 1, bias=False)
            with torch.no_grad():
                emb.weight.copy_(torch.from_numpy(data["emb"]))
                head.weight.copy_(torch.from_numpy(data["head"]).T)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(list(emb.parameters()) + list(head.parameters()), lr=1.0),
                compression=hvd.Compression.fp16 if kind == "fp16" else hvd.Compression.none,
                prescale_factor=0.5 if kind == "fp16" else 1.0,
                postscale_factor=2.0 if kind == "fp16" else 1.0,
                process_set=s012 if kind == "set" else None,
                sparse_as_dense=kind == "dense")
            for i in range(2):
                ids = torch.from_numpy(data["ids"][i, rank])
                head(emb(ids)).sum().backward()
                opt.step()
                opt.zero_grad()
            res[f"step|{kind}|emb"] = emb.weight.detach().numpy()
            res[f"step|{kind}|head"] = head.weight.detach().T.numpy()
        np.savez(out + f"/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""")


def _data():
    rng = np.random.default_rng(17)
    d = {}
    for r, nnz in enumerate(NNZ):
        d[f"idx{r}"] = rng.integers(0, ROWS, nnz).astype(np.int64)
        d[f"vals{r}"] = (rng.integers(-8, 9, (nnz, D)) / 8).astype(np.float32)
    d["emb"] = (rng.integers(-8, 9, (ROWS, D)) / 8).astype(np.float32)
    d["head"] = (rng.integers(-4, 5, (D, 1)) / 4).astype(np.float32)
    d["ids"] = rng.integers(0, ROWS, (2, N, 3)).astype(np.int64)
    return d


def _np(a):
    return np.asarray(a)


def _traced(fn, *xs):
    spec = P(WORLD_AXIS)
    f = shard_map(lambda *vs: jax.tree.map(lambda a: a[None], fn(*[v[0] for v in vs])),
                  mesh=get_runtime().mesh, in_specs=(spec,) * len(xs), out_specs=spec,
                  check_vma=False)
    return jax.tree.map(_np, jax.jit(f)(*xs))


def _padded(data):
    """Every rank's slices padded to the largest count (index 0, zero rows)."""
    m = max(NNZ)
    idx = np.zeros((N, m), np.int32)
    vals = np.zeros((N, m, D), np.float32)
    for r, nnz in enumerate(NNZ):
        idx[r, :nnz], vals[r, :nnz] = data[f"idx{r}"], data[f"vals{r}"]
    return idx, vals


def _jax_world(data):
    want = {}
    s012 = hvd.ProcessSet([0, 1, 2])
    hvd.init(devices=jax.devices()[:N], process_sets=[s012])
    idx, vals = _padded(data)

    def body(i, v):
        out = {}
        s = jsparse.IndexedSlices(i, v, (ROWS, D))
        for tag, ps in (("world", None), ("set", s012)):
            for op_tag, op in (("avg", traced.Average), ("sum", traced.Sum)):
                out[f"ar|{tag}|{op_tag}"] = jsparse.densify(
                    jsparse.sparse_allreduce(s, op=op, process_set=ps))
        return out

    want.update(_traced(body, jnp.asarray(idx), jnp.asarray(vals)))
    for tag, ps in (("world", None), ("set", s012)):
        got = jsparse.sparse_allreduce_eager(
            jsparse.IndexedSlices(jnp.asarray(idx), jnp.asarray(vals), (ROWS, D)),
            process_set=ps)
        want[f"eager|{tag}"] = np.stack([np.asarray(jsparse.densify(jsparse.IndexedSlices(
            got.indices[r], got.values[r], (ROWS, D)))) for r in range(N)])
    for kind in ("plain", "fp16", "set"):
        opt = hvd.DistributedOptimizer(
            optax.sgd(1.0),
            compression=hvd.Compression.fp16 if kind == "fp16" else hvd.Compression.none,
            prescale_factor=0.5 if kind == "fp16" else 1.0,
            postscale_factor=2.0 if kind == "fp16" else 1.0,
            process_set=s012 if kind == "set" else None)

        def step(emb, head, ids, opt=opt):
            params = {"emb": emb, "head": head}
            state = opt.init(params)
            for i in range(2):
                def loss(p):
                    return jnp.sum(p["emb"][ids[i]] @ p["head"])
                g = jax.grad(loss)(params)
                g = {"emb": jsparse.dense_grad_to_indexed_slices(g["emb"], ids[i], 3),
                     "head": g["head"]}
                updates, state = opt.update(g, state, params)
                params = optax.apply_updates(params, updates)
            return params["emb"], params["head"]

        stack = lambda a: jnp.asarray(np.stack([a] * N))  # noqa: E731
        ids = jnp.asarray(data["ids"].transpose(1, 0, 2).astype(np.int32))
        want[f"step|{kind}|emb"], want[f"step|{kind}|head"] = _traced(
            step, stack(data["emb"]), stack(data["head"]), ids)
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_sparse_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        tmp = tmp_path_factory.mktemp("sparse")
        data = _data()
        np.savez(tmp / "data.npz", **data)
        (tmp / "worker.py").write_text(_WORKER)
        env = dict(os.environ, PYTHONPATH=ROOT)
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_XIR_WIRE", "HVD_TPU_SCHED_WIRE"):
            env.pop(k, None)
        procs = [subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"), str(r), str(N), str(tmp / "store"),
             str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(N)]
        hvd.shutdown()
        try:
            want = _jax_world(data)
        finally:
            hvd.shutdown()
        try:
            outs = [p.communicate(timeout=150)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
        with open(path, "wb") as f:
            pickle.dump((data, ranks, want), f)
    return data, ranks, want


@pytest.mark.parametrize("key", ["ar|world|avg", "ar|world|sum", "ar|set|avg",
                                 "ar|set|sum", "eager|world", "eager|set"])
def test_sparse_allreduce_matches_jax(world, key):
    """Each member's densified result against row r of the JAX one (off
    the set the JAX single-controller gather hands rank 3 rows too; the
    port's non-member gets none: ROADMAP Queue C, process sets)."""
    _, ranks, want = world
    members = [0, 1, 2] if "set" in key else range(N)
    for r in members:
        got, exp = ranks[r][key], want[key][r]
        if key in ("ar|set|avg", "eager|set"):
            np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-7, err_msg=f"{key} {r}")
        else:
            np.testing.assert_array_equal(got, exp, err_msg=f"{key} {r}")
    if "set" in key:
        assert not ranks[3][key].any()


@pytest.mark.parametrize("kind", ["plain", "fp16", "set"])
def test_the_sparse_step_matches_jax(world, kind):
    """Two steps through the allgather path; every member the same, and
    ``sparse_as_dense`` gives the same weights on the world."""
    _, ranks, want = world
    for r in range(N):
        for part in ("emb", "head"):
            got, exp = ranks[r][f"step|{kind}|{part}"], want[f"step|{kind}|{part}"][r]
            if kind == "set":
                np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6,
                                           err_msg=f"{kind} {part} {r}")
            else:
                np.testing.assert_array_equal(got, exp, err_msg=f"{kind} {part} {r}")
    if kind == "plain":
        for r in range(N):
            for part in ("emb", "head"):
                np.testing.assert_array_equal(ranks[r][f"step|plain|{part}"],
                                              ranks[r][f"step|dense|{part}"])


def test_the_sparse_rows_follow_the_shuffle_wire_rule(monkeypatch):
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.ops.sparse import densify

    t = torch.sparse_coo_tensor(torch.tensor([[1, 3, 1]]), torch.ones(3, 2), (5, 2),
                                check_invariants=False)
    thvd.init("cpu")
    try:
        monkeypatch.setenv("HVD_TPU_XIR_WIRE", "int8")
        assert torch.equal(densify(thvd.sparse_allreduce(t)), densify(t))
        monkeypatch.setenv("HVD_TPU_XIR_WIRE", "bf16")
        with pytest.raises(NotImplementedError, match=r"A12 \(rest\)"):
            thvd.sparse_allreduce(t)
        with pytest.raises(ValueError, match="Average or Sum"):
            thvd.sparse_allreduce(t, op=thvd.Max)
        with pytest.raises(ValueError, match="sparse COO"):
            thvd.sparse_allreduce(torch.ones(3))
    finally:
        thvd.shutdown()


def test_adasum_refuses_sparse_gradients_as_jax_does():
    import horovod_tpu_torch as thvd

    thvd.init("cpu")
    try:
        emb = torch.nn.Embedding(5, 2, sparse=True)
        opt = thvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=1.0),
                                        op=thvd.Adasum)
        emb(torch.tensor([1, 2])).sum().backward()
        with pytest.raises(ValueError, match="op=Average or Sum only"):
            opt.step()
    finally:
        thvd.shutdown()
