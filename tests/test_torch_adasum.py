"""The port's Adasum against the JAX package's.

Two gloo worlds, started together and run once (the JAX side computed
while they run, shared across xdist workers behind a ``filelock``, as
``tests/test_torch_process_sets.py`` does):

* a world of four under ``HVD_TPU_TOPO=2x2`` with the set {0,1,2}
  registered: ``allreduce(op=Adasum)`` flat (the VHDD tree), with
  ``HVD_TPU_HIERARCHICAL_ALLREDUCE=1`` (a sum inside each domain, the
  rails' VHDD across), on {0,1,2} (a straggler folded in; rank 3, off
  the set, keeps its input), with a pre- and postscale, on bf16, as a
  grouped allreduce, async, and its gradient (the Adasum of the
  incoming gradients, ``interop/_grads.py`` ``allreduce_grad``);
  ``hierarchical_adasum_all_reduce`` (Sum and Average) on the off,
  bf16 and int8 wires; and the data-parallel step: two SGD steps of
  ``DistributedOptimizer(op=Adasum)`` (every bucket ``hier_adasum``, and
  with ``lowering="flat"`` the flat tree) and of
  ``DistributedAdasumOptimizer``, against the JAX optimizers on the same
  weights and data;
* a world of three (no topology): the flat tree with one straggler.

Each is held against the JAX function in ``shard_map`` on as many CPU
devices.  Tolerance: 2e-6 of the largest element of the JAX result (1e-2
on bf16: a bf16 rounding of an element can flip).  The float32 dot
products and norms are summed in another order (torch's reductions, and
gloo's and XLA's all-reduces), so each coefficient moves by a few float32
ulps and so does each element; a wrong pairing or a lost half moves
whole elements, O(1) of the largest.  The steps: 1e-6 absolute on
weights of order one (the deltas of ``DistributedAdasumOptimizer`` are
taken as the difference of the weights before and after the local
update, which rounds once more than the JAX update).  Every rank of a
result ends bitwise equal to rank 0's, and rank 0 also holds each
combined vector against a float64 NumPy Adasum written as the recursive
pairwise definition, to 1e-5 of its largest element.
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
from horovod_tpu.ops import traced
from horovod_tpu.runtime import WORLD_AXIS, get_runtime
from horovod_tpu.topo import hierarchical as jh
from horovod_tpu.topo import model as jmodel

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 128
TOL, TOL_BF16, STEP_TOL, REF_TOL = 2e-6, 1e-2, 1e-6, 1e-5

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.topo import hierarchical as th

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    sets = [hvd.ProcessSet([0, 1, 2])] if n == 4 else []
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60,
             process_sets=sets)
    data = dict(np.load(out + "/data.npz"))
    res = {}

    def save(key, t):
        res[key] = t.detach().float().numpy() if t.dtype == torch.bfloat16 else \\
            t.detach().numpy()

    try:
        x = torch.from_numpy(data["x"][rank].copy())
        y = torch.from_numpy(data["y"][rank].copy())
        save("flat", hvd.allreduce(x, op=hvd.Adasum))
        save("flat_y", hvd.allreduce(y, op=hvd.Adasum))
        if n == 4:
            ps = sets[0]  # registered at init
            save("set", hvd.allreduce(x, op=hvd.Adasum, process_set=ps))
            save("scaled", hvd.allreduce(x, op=hvd.Adasum, prescale_factor=0.5,
                                         postscale_factor=3.0))
            save("bf16", hvd.allreduce(x.to(torch.bfloat16), op=hvd.Adasum))
            for i, o in enumerate(hvd.grouped_allreduce([x, y], op=hvd.Adasum)):
                save(f"grouped_{i}", o)
            save("async", hvd.synchronize(hvd.allreduce_async(x, op=hvd.Adasum)))
            xg = x.clone().requires_grad_()
            (hvd.allreduce(xg, op=hvd.Adasum) * torch.from_numpy(data["w"][rank])).sum().backward()
            save("grad", xg.grad)
            os.environ["HVD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
            save("hierarchical", hvd.allreduce(x, op=hvd.Adasum))
            save("hierarchical_set", hvd.allreduce(x, op=hvd.Adasum, process_set=ps))
            os.environ.pop("HVD_TPU_HIERARCHICAL_ALLREDUCE")
            for w in ("off", "bf16", "int8"):
                save(f"hier_adasum|{w}|sum", th.hierarchical_adasum_all_reduce(
                    x, op=hvd.Sum, wire=w))
                save(f"hier_adasum|{w}|avg", th.hierarchical_adasum_all_reduce(
                    x, op=hvd.Average, wire=w))
            for kind in ("op", "op_flat", "optimizer"):
                lin = torch.nn.Linear(6, 1)
                with torch.no_grad():
                    lin.weight.copy_(torch.from_numpy(data["sw"].T.copy()))
                    lin.bias.copy_(torch.from_numpy(data["sb"]))
                sgd = torch.optim.SGD(lin.parameters(), lr=0.5)
                if kind == "optimizer":
                    opt = hvd.DistributedAdasumOptimizer(sgd)
                else:
                    opt = hvd.DistributedOptimizer(
                        sgd, op=hvd.Adasum, lowering="flat" if kind == "op_flat" else None)
                for i in range(2):
                    xs = torch.from_numpy(data["sx"][i, 4 * rank:4 * rank + 4])
                    ys = torch.from_numpy(data["sy"][i, 4 * rank:4 * rank + 4])
                    torch.mean((lin(xs) - ys) ** 2).backward()
                    opt.step()
                    opt.zero_grad()
                res[f"step|{kind}|lowerings"] = np.array(
                    [b.lowering for b in opt.schedule.buckets])
                res[f"step|{kind}|p2p"] = np.array(opt.point_to_point)
                save(f"step|{kind}|w", lin.weight.T)
                save(f"step|{kind}|b", lin.bias)
        np.savez(out + f"/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""")


def _data():
    rng = np.random.default_rng(5)
    return {
        "x": rng.standard_normal((4, 300)).astype(np.float32),
        "y": rng.standard_normal((4, 37)).astype(np.float32),
        "w": rng.standard_normal((4, 300)).astype(np.float32),
        "sx": rng.standard_normal((2, 16, 6)).astype(np.float32),
        "sy": rng.standard_normal((2, 16, 1)).astype(np.float32),
        "sw": (0.3 * rng.standard_normal((6, 1))).astype(np.float32),
        "sb": np.array([0.25], np.float32),
    }


def _spawn(tmp, n, env_extra):
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_SCHED_WIRE", "HVD_TPU_ONESTEP",
              "HVD_TPU_TOPO_LOWER", "HVD_TPU_HIERARCHICAL_ALLREDUCE", "HVD_TPU_TOPO"):
        if k not in env_extra:
            env.pop(k, None)
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(n), str(tmp / "store"),
         str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]


def _collect(procs, tmp):
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _traced(fn, *xs):
    spec = P(WORLD_AXIS)
    f = shard_map(lambda *vs: jax.tree.map(lambda a: a[None], fn(*[v[0] for v in vs])),
                  mesh=get_runtime().mesh, in_specs=(spec,) * len(xs), out_specs=spec,
                  check_vma=False)
    return jax.tree.map(_np, jax.jit(f)(*xs))


def _jax_steps(data, n):
    """Two SGD (lr 0.5) steps of each optimizer on every rank's rows."""
    out = {}
    opts = {"op": hvd.DistributedOptimizer(optax.sgd(0.5), op=hvd.Adasum),
            "op_flat": hvd.DistributedOptimizer(optax.sgd(0.5), op=hvd.Adasum,
                                                lowering="flat"),
            "optimizer": hvd.DistributedAdasumOptimizer(optax.sgd(0.5))}
    for kind, opt in opts.items():
        def body(w, b, xs, ys, opt=opt):
            params = {"w": w, "b": b}
            state = opt.init(params)
            for i in range(2):
                def loss(p):
                    return jnp.mean((xs[i] @ p["w"] + p["b"] - ys[i]) ** 2)
                updates, state = opt.update(jax.grad(loss)(params), state, params)
                params = optax.apply_updates(params, updates)
            return params["w"], params["b"]

        stack = lambda a: jnp.asarray(np.stack([a] * n))  # noqa: E731
        xs = jnp.asarray(data["sx"].reshape(2, n, 4, 6).transpose(1, 0, 2, 3))
        ys = jnp.asarray(data["sy"].reshape(2, n, 4, 1).transpose(1, 0, 2, 3))
        w, b = _traced(body, stack(data["sw"]), stack(data["sb"]), xs, ys)
        out[f"step|{kind}|w"], out[f"step|{kind}|b"] = w, b
    return out


def _jax_world4(data, mp):
    mp.setenv("HVD_TPU_TOPO", "2x2")
    mp.setenv("HVD_TPU_TOPO_FIT", "off")
    mp.setenv("HVD_TPU_QUANT_BLOCK", str(BLOCK))
    jset = hvd.ProcessSet([0, 1, 2])
    hvd.init(devices=jax.devices()[:4], process_sets=[jset])
    jmodel.reset()
    x, y, w = (jnp.asarray(data[k]) for k in ("x", "y", "w"))

    def body(x, y, w):
        ad = lambda v, **kw: traced.allreduce(v, op=traced.Adasum, **kw)  # noqa: E731
        out = {"flat": ad(x), "flat_y": ad(y), "set": ad(x, process_set=jset),
               "scaled": ad(x, prescale_factor=0.5, postscale_factor=3.0),
               "bf16": ad(x.astype(jnp.bfloat16)), "grad": ad(w),
               "hierarchical": ad(x, hierarchical=True),
               "hierarchical_set": ad(x, process_set=jset, hierarchical=True)}
        for i, o in enumerate(traced.grouped_allreduce([x, y], op=traced.Adasum)):
            out[f"grouped_{i}"] = o
        for wire in ("off", "bf16", "int8"):
            for tag, op in (("sum", traced.Sum), ("avg", traced.Average)):
                out[f"hier_adasum|{wire}|{tag}"] = jh.hierarchical_adasum_all_reduce(
                    x, op=op, wire=wire)
        return out

    want = _traced(body, x, y, w)
    want["async"] = want["flat"]
    want.update(_jax_steps(data, 4))
    return want


def _jax_world3(data):
    hvd.init(devices=jax.devices()[:3])
    x, y = jnp.asarray(data["x"][:3]), jnp.asarray(data["y"][:3])
    return _traced(lambda x, y: {"flat": traced.allreduce(x, op=traced.Adasum),
                                 "flat_y": traced.allreduce(y, op=traced.Adasum)}, x, y)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_adasum_worlds.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        data = _data()
        tmps = {n: tmp_path_factory.mktemp(f"adasum{n}") for n in (4, 3)}
        for tmp in tmps.values():
            np.savez(tmp / "data.npz", **data)
        procs = {4: _spawn(tmps[4], 4, {"HVD_TPU_TOPO": "2x2",
                                        "HVD_TPU_QUANT_BLOCK": str(BLOCK)}),
                 3: _spawn(tmps[3], 3, {})}
        hvd.shutdown()
        mp = pytest.MonkeyPatch()
        want = {}
        try:
            want[4] = _jax_world4(data, mp)
            mp.undo()
            hvd.shutdown()
            jmodel.reset()
            want[3] = _jax_world3(data)
        finally:
            mp.undo()
            hvd.shutdown()
            jmodel.reset()
        ranks = {n: _collect(p, tmps[n]) for n, p in procs.items()}
        with open(path, "wb") as f:
            pickle.dump((data, ranks, want), f)
    return data, ranks, want


def _adasum64(vs):
    """Adasum as the recursive pairwise definition, in float64: the two
    halves of the members (the first 2^⌊log2 k⌋ after each straggler is
    folded into its partner) combined pair by pair, level by level."""
    vs = [np.asarray(v, np.float64) for v in vs]

    def pair(a, b):
        dot, na, nb = a @ b, a @ a, b @ b
        ca = 1 - dot / (2 * na) if na > 0 else 1.0
        cb = 1 - dot / (2 * nb) if nb > 0 else 1.0
        return ca * a + cb * b

    p = 1 << (len(vs).bit_length() - 1)
    vs = [pair(vs[i], vs[p + i]) for i in range(len(vs) - p)] + vs[len(vs) - p:p]
    while len(vs) > 1:
        vs = [pair(vs[2 * i], vs[2 * i + 1]) for i in range(len(vs) // 2)]
    return vs[0]


def _close(got, exp, tol, what):
    got, exp = np.asarray(got, np.float32), np.asarray(exp, np.float32)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    err = np.abs(got - exp).max() if got.size else 0.0
    assert err <= tol * np.abs(exp).max(), (what, err)


KEYS4 = ["flat", "flat_y", "set", "scaled", "bf16", "grouped_0", "grouped_1", "async",
         "grad", "hierarchical", "hierarchical_set"] + [
    f"hier_adasum|{w}|{t}" for w in ("off", "bf16", "int8") for t in ("sum", "avg")]


@pytest.mark.parametrize("key", KEYS4)
def test_adasum_at_world_four_matches_jax(worlds, key):
    """Every member against row r of the JAX function; the members equal
    one another bitwise; a non-member of {0,1,2} keeps its input."""
    data, ranks, want = worlds
    members = [0, 1, 2] if key.endswith("set") else [0, 1, 2, 3]
    tol = TOL_BF16 if "bf16" in key else TOL
    for r in range(4):
        got = ranks[4][r][key]
        if r not in members:
            np.testing.assert_array_equal(got, data["x"][r])
            continue
        _close(got, want[4][key][r], tol, f"{key} rank {r}")
        np.testing.assert_array_equal(got, ranks[4][members[0]][key])


@pytest.mark.parametrize("key", ["flat", "flat_y"])
def test_adasum_at_world_three_matches_jax(worlds, key):
    data, ranks, want = worlds
    for r in range(3):
        _close(ranks[3][r][key], want[3][key][r], TOL, f"{key} rank {r}")
        np.testing.assert_array_equal(ranks[3][r][key], ranks[3][0][key])


@pytest.mark.parametrize("case", ["flat4", "set", "flat3", "hier_adasum", "hierarchical"])
def test_adasum_matches_the_float64_definition(worlds, case):
    """Rank 0's result against :func:`_adasum64` of the contributions: the
    ranks' vectors, or for the two-level forms the domains' sums
    (``hier_adasum`` Sum) or means (``HVD_TPU_HIERARCHICAL_ALLREDUCE``)."""
    data, ranks, _ = worlds
    x = data["x"].astype(np.float64)
    got, want = {
        "flat4": (ranks[4][0]["flat"], lambda: _adasum64(x)),
        "set": (ranks[4][0]["set"], lambda: _adasum64(x[:3])),
        "flat3": (ranks[3][0]["flat"], lambda: _adasum64(x[:3])),
        "hier_adasum": (ranks[4][0]["hier_adasum|off|sum"],
                        lambda: _adasum64([x[0] + x[1], x[2] + x[3]])),
        "hierarchical": (ranks[4][0]["hierarchical"],
                         lambda: _adasum64([(x[0] + x[1]) / 2, (x[2] + x[3]) / 2])),
    }[case]
    _close(got, want(), REF_TOL, case)


@pytest.mark.parametrize("kind", ["op", "op_flat", "optimizer"])
def test_adasum_steps_match_jax(worlds, kind):
    """``DistributedOptimizer(op=Adasum)`` on the 2x2 topology plans every
    bucket ``hier_adasum`` (captured like any collective), ``lowering=
    "flat"`` the flat tree (point to point, so a captured step refuses),
    and ``DistributedAdasumOptimizer`` combines the deltas on
    ``hier_adasum``: each within 1e-6 of the JAX optimizer, every rank
    the same."""
    _, ranks, want = worlds
    lowering = "flat" if kind == "op_flat" else "hier_adasum"
    for r in range(4):
        rec = ranks[4][r]
        assert list(rec[f"step|{kind}|lowerings"]) == [lowering]
        assert bool(rec[f"step|{kind}|p2p"]) == (kind == "op_flat")
        for k in ("w", "b"):
            got, exp = rec[f"step|{kind}|{k}"], want[4][f"step|{kind}|{k}"][r]
            np.testing.assert_allclose(got, exp.reshape(got.shape), rtol=0, atol=STEP_TOL,
                                       err_msg=f"{kind} {k} rank {r}")
            np.testing.assert_array_equal(got, ranks[4][0][f"step|{kind}|{k}"])


def test_flat_adasum_refuses_under_capture(monkeypatch):
    """The flat tree's point-to-point hops refuse in a capture; a world of
    one returns its input (nothing to combine) and runs anywhere."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.optim.distributed_optimizer import capture_blocker

    thvd.init("cpu")
    try:
        x = torch.arange(5.0)
        assert torch.equal(thvd.allreduce(x, op=thvd.Adasum), x)
        assert torch.equal(thvd.allreduce(x, op=thvd.Adasum, prescale_factor=2.0,
                                          postscale_factor=0.5), x)
        opt = thvd.DistributedOptimizer(torch.optim.SGD([torch.nn.Parameter(x.clone())],
                                                        lr=0.1), op=thvd.Adasum)
        assert not opt.point_to_point  # a world of one exchanges nothing
    finally:
        thvd.shutdown()
    reason = capture_blocker("nccl", 1, False, True, point_to_point=True)
    assert "point to point" in reason and "hier_adasum" in reason
    assert capture_blocker("nccl", 1, False, True) is None
