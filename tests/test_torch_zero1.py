"""The port's bucketed ZeRO-1 step and reduce-scatter exchange mode
against the JAX package's.

One gloo world of four processes joined through a ``FileStore`` under
``HVD_TPU_TOPO=2x2`` (domains {0,1} and {2,3}), with the set {0,1}
registered and ``HVD_TPU_FUSION_THRESHOLD=32`` (every leaf its own
bucket), run once and shared across xdist workers behind a ``filelock``
(``tests/test_torch_process_sets.py``).  The JAX side runs in three fresh
interpreters (the flat steps, the hierarchical steps, the exchanges
with the optimizer) on
``jax.devices()[:4]`` with the same topology and knobs, while the ranks
run.  The problem is ``tests/test_zero.py``'s
linear regression (``w [5, 3]``, ``b [3]``, 32 rows, rank r taking rows
``8r:8r+8``); the module registers ``b`` before ``w``, so its flat
order (module order) is the JAX package's (sorted keys).

* ``bucketed_zero_step`` against ``horovod_tpu.sched.bucketed_zero_step``
  (two buckets: ``w``, then ``b``):
  - dense SGD (lr 1/8, momentum 1/2) for two steps on dyadic data with
    the loss ``Σ(xw + b − y)² / 16`` (every gradient exact): bitwise,
    flat and ``hier``;
  - AdamW (lr 1e-2, weight decay 1e-4) for five steps on normal data:
    rtol 1e-5, atol 1e-5 (``tests/test_torch_zero.py``'s: float32 sums
    over ranks and optimizer arithmetic in another order);
  - int8 and fp8 with error feedback, three SGD steps (lr 0.1) on normal
    data: within one quantization step of the update per step (ROADMAP
    Queue C's FMA and block-layout divergences; int8: lr·G/127, fp8:
    lr·G·2^-3, G the largest gradient element), with a non-zero
    residual of ``padded`` elements on every rank;
  - ``hier`` on int8 (the cross-domain hop quantized, no residual):
    5e-7 absolute on weights of order one, the FMA divergence's bound
    of ``tests/test_torch_topo.py``'s hierarchical int8 step;
  - ``hier_adasum``: 1e-6 absolute (``tests/test_torch_adasum.py``'s
    step tolerance: the float32 dot products and norms are summed in
    another order, a few ulps of each coefficient);
  - ``pre_update=clip_by_global_norm(0.05)``: rtol 1e-5, atol 1e-6;
  - the optimizer's state: ``padded / 4`` elements a rank per bucket
    (flat) and ``padded / 2`` (``hier``: sharded over the domain), the
    layouts equal to the JAX package's.
* ``sched/execute.py`` ``reduce_scatter_flat`` (with a pre- and a
  postscale, with ``shard_update``, on bf16), ``hier_reduce_scatter_flat``
  (off and bf16 wires, ``shard_update``) and ``quantized_exchange_flat``'s
  ``shard_update`` hook (int8 on grid inputs, with and without the
  residual): bitwise with the JAX functions under ``shard_map``.
* ``DistributedOptimizer`` under ``HVD_TPU_SCHED_MODE=reduce_scatter``,
  two SGD steps (lr 1) on dyadic data, on the off and bf16 wires and
  with ``lowering="hier"``: bitwise with the JAX optimizer; the process
  set {0,1} and ``op=Adasum`` keep the allreduce lowering (no
  reduce-scatter call, the allreduce mode's bits); a mode changed
  between two steps of one optimizer re-plans.
* The capture of the three sharded steps, with the card and the graph
  faked as in ``tests/test_torch_onestep.py``: two warm-up steps, one
  capture, replays equal to the eager steps; a new batch shape captures
  beside the first; a new model drops the graphs; ``HVD_TPU_ONESTEP=on``
  refuses AdamW without ``capturable=True`` and ``auto`` runs it
  eagerly.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import filelock
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_unflatten

import horovod_tpu_torch as thvd
from horovod_tpu_torch import metrics
from horovod_tpu_torch.exceptions import HorovodTpuError
from horovod_tpu_torch.optim import distributed_optimizer as dopt
from horovod_tpu_torch.sched import bucketed_zero_step
from horovod_tpu_torch.sched.plan import SchedConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BLOCK = 4, 512
KNOBS = {"HVD_TPU_TOPO": "2x2", "HVD_TPU_TOPO_FIT": "off", "HVD_TPU_FUSION_THRESHOLD": "32"}
# name: (HVD_TPU_TOPO_LOWER, HVD_TPU_SCHED_WIRE, optimizer, data, steps, clip)
RUNS = {"sgd": ("flat", "off", "sgd", "d", 2, False),
        "adamw": ("flat", "off", "adamw", "", 5, False),
        "int8": ("flat", "int8", "sgd1", "", 3, False),
        "fp8": ("flat", "fp8", "sgd1", "", 3, False),
        "clip": ("flat", "off", "sgd1", "", 3, True),
        "hier": ("hier", "off", "sgd", "d", 2, False),
        "hier_int8": ("hier", "int8", "sgd", "d", 2, False),
        "hier_adasum": ("hier_adasum", "off", "sgd", "d", 2, False)}
# The rank processes and the JAX process each finish well inside this
# (about 10 s unloaded); a rank that has not is named with its output.
WORLD_TIMEOUT = 600

_COMMON = """
import os, sys
import numpy as np

RUNS = RUNS_LITERAL
N, OUT = 4, sys.argv[-1]
data = dict(np.load(OUT + "/data.npz"))


def upd(s):  # the shard_update hook of both sides
    return s * 2.0 + 1.0
"""

_WORKER = textwrap.dedent("""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.sched import bucketed_zero_step, execute

    rank, n, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    s01 = hvd.ProcessSet([0, 1])
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=300,
             process_sets=[s01])
    rows = slice(8 * rank, 8 * rank + 8)
    res = {}

    class Linear(torch.nn.Module):
        def __init__(self, w, b):
            super().__init__()
            self.b = torch.nn.Parameter(torch.from_numpy(data[b].copy()))
            self.w = torch.nn.Parameter(torch.from_numpy(data[w].copy()))

        def forward(self, x):
            return x @ self.w + self.b

    def loss_fn(kind):
        def mse(model, batch):
            d = model(batch[0]) - batch[1]
            return torch.sum(d * d) / 16 if kind == "d" else torch.mean(d * d)
        return mse

    OPTS = {"sgd": lambda p: torch.optim.SGD(p, lr=0.125, momentum=0.5),
            "sgd1": lambda p: torch.optim.SGD(p, lr=0.1),
            "adamw": lambda p: torch.optim.AdamW(p, lr=1e-2, weight_decay=1e-4)}

    def put(key, t):
        res[key] = t.detach().float().numpy().copy()

    calls = {"rs": 0, "hrs": 0}
    for name, fn in (("rs", "reduce_scatter_flat"), ("hrs", "hier_reduce_scatter_flat")):
        def counted(*a, _fn=getattr(execute, fn), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(execute, fn, counted)

    try:
        for name, (lower, wire, opt, kind, steps, clip) in RUNS.items():
            os.environ["HVD_TPU_TOPO_LOWER"] = lower
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            step = bucketed_zero_step(loss_fn(kind), OPTS[opt],
                                      pre_update=hvd.clip_by_global_norm(0.05) if clip else None)
            model = Linear(kind + "w", kind + "b")
            state = step.init(model)
            batch = (torch.from_numpy(data[kind + "x"][rows]),
                     torch.from_numpy(data[kind + "y"][rows]))
            for _ in range(steps):
                model, state, loss = step(model, state, batch)
            put(f"{name}|w", model.w)
            put(f"{name}|b", model.b)
            res[f"{name}|layout"] = np.array(
                [[lay.n, lay.padded, lay.shard_len, lay.shards] for lay in state.layouts])
            res[f"{name}|lowering"] = np.array([lay.lowering for lay in state.layouts])
            lens = [[t.numel() for t in state.optimizer.state[s].values() if t.dim() == 1]
                    for s in state.shards]  # each bucket's 1-d state tensors
            res[f"{name}|state"] = np.array([[len(v), min(v, default=0), max(v, default=0)]
                                             for v in lens])
            res[f"{name}|ef"] = np.array([-1.0 if e is None else float(e.abs().max())
                                          for e in state.ef])
            res[f"{name}|ef_len"] = np.array([0 if e is None else e.numel() for e in state.ef])
        os.environ["HVD_TPU_TOPO_LOWER"] = "flat"
        os.environ["HVD_TPU_SCHED_WIRE"] = "off"

        # The exchanges on their own.
        x = torch.from_numpy(data["xd"][rank])
        put("rsf|scaled", execute.reduce_scatter_flat(x, average=True, prescale_factor=0.5,
                                                      postscale_factor=3.0))
        put("rsf|upd", execute.reduce_scatter_flat(x, average=False, shard_update=upd))
        put("rsf|bf16", execute.reduce_scatter_flat(x.bfloat16(), average=True))
        put("hrs|off", execute.hier_reduce_scatter_flat(x, average=True, prescale_factor=0.5,
                                                        postscale_factor=3.0))
        put("hrs|bf16", execute.hier_reduce_scatter_flat(x, average=True, wire="bf16"))
        put("hrs|upd", execute.hier_reduce_scatter_flat(x, average=False, shard_update=upd))
        xg = torch.from_numpy(data["xg"][rank])
        out, _ = execute.quantized_exchange_flat(xg, average=True, wire="int8",
                                                 shard_update=upd)
        put("qx|upd", out)
        out, r = execute.quantized_exchange_flat(xg, average=True, wire="int8",
                                                 shard_update=upd,
                                                 residual=torch.from_numpy(data["rq"][rank]))
        put("qx|ef", out)
        put("qx|ef_res", r)

        # DistributedOptimizer under HVD_TPU_SCHED_MODE.
        srows = slice(4 * rank, 4 * rank + 4)

        def do_step(mode, wire="off", **kw):
            os.environ["HVD_TPU_SCHED_MODE"] = mode
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            w = torch.nn.Parameter(torch.from_numpy(data["sw"].copy()))
            b = torch.nn.Parameter(torch.from_numpy(data["sb"].copy()))
            opt = hvd.DistributedOptimizer(torch.optim.SGD([b, w], lr=1.0),
                                           named_parameters=[("b", b), ("w", w)], **kw)
            before = dict(calls)
            for i in range(2):
                xs = torch.from_numpy(data["sx"][i][srows])
                ys = torch.from_numpy(data["sy"][i][srows])
                torch.mean((xs @ w + b - ys) ** 2).backward()
                opt.step()
                opt.zero_grad()
            res["do_calls"] = res.get("do_calls", []) + [
                [calls[k] - before[k] for k in ("rs", "hrs")] + [len(opt.schedule)]]
            return torch.cat([w.detach().reshape(-1), b.detach()]).numpy().copy()

        for mode in ("reduce_scatter", "allreduce"):
            for wire in ("off", "bf16"):
                res[f"do|{mode}|{wire}"] = do_step(mode, wire)
            res[f"do|{mode}|hier"] = do_step(mode, lowering="hier")
            res[f"do|{mode}|set"] = do_step(mode, process_set=s01)
            res[f"do|{mode}|adasum"] = do_step(mode, op=hvd.Adasum, lowering="flat")
        res["do_calls"] = np.array(res["do_calls"])

        # One optimizer, the mode changed between its steps: re-planned.
        os.environ["HVD_TPU_SCHED_MODE"] = "allreduce"
        w = torch.nn.Parameter(torch.from_numpy(data["sw"].copy()))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0))
        seen = []
        for mode in ("allreduce", "reduce_scatter", "allreduce"):
            os.environ["HVD_TPU_SCHED_MODE"] = mode
            before = calls["rs"]
            torch.sum(torch.from_numpy(data["sx"][0][srows]) @ w).backward()
            opt.step()
            opt.zero_grad()
            seen.append(calls["rs"] - before)
        res["mode_switch"] = np.array(seen)
        os.environ.pop("HVD_TPU_SCHED_MODE")
        np.savez(f"{OUT}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""")

_JAX = textwrap.dedent("""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as hvd
    from horovod_tpu import sched
    from horovod_tpu.optim.zero import clip_by_global_norm
    from horovod_tpu.runtime import WORLD_AXIS, get_runtime
    from horovod_tpu.sched import execute as jx
    from horovod_tpu.sched.zero1 import bucket_layouts

    hvd.init(devices=jax.devices()[:N], process_sets=[hvd.ProcessSet([0, 1])])
    res = {}

    def np32(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a

    def traced(fn, *xs):
        spec = P(WORLD_AXIS)
        f = shard_map(lambda *vs: jax.tree.map(lambda a: a[None], fn(*[v[0] for v in vs])),
                      mesh=get_runtime().mesh, in_specs=(spec,) * len(xs), out_specs=spec,
                      check_vma=False)
        return jax.tree.map(np32, jax.jit(f)(*xs))

    def loss_fn(kind):
        def mse(p, batch):
            d = batch[0] @ p["w"] + p["b"] - batch[1]
            return jnp.sum(d * d) / 16 if kind == "d" else jnp.mean(d * d)
        return mse

    OPTS = {"sgd": lambda: optax.sgd(0.125, momentum=0.5), "sgd1": lambda: optax.sgd(0.1),
            "adamw": lambda: optax.adamw(1e-2, weight_decay=1e-4)}


    def steps(lowerings):
        for name, (lower, wire, opt, kind, steps, clip) in RUNS.items():
            if lower not in lowerings:
                continue
            os.environ["HVD_TPU_TOPO_LOWER"] = lower
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            step = sched.bucketed_zero_step(
                loss_fn(kind), OPTS[opt](),
                pre_update=clip_by_global_norm(0.05) if clip else None)
            params = {"w": jnp.asarray(data[kind + "w"]), "b": jnp.asarray(data[kind + "b"])}
            st = step.init(params)
            batch = (jnp.asarray(data[kind + "x"]), jnp.asarray(data[kind + "y"]))
            for _ in range(steps):
                params, st, loss = step(params, st, batch)
            res[f"{name}|w"], res[f"{name}|b"] = np.asarray(params["w"]), np.asarray(params["b"])
            lays = bucket_layouts(params, N)
            res[f"{name}|layout"] = np.array([[l.n, l.padded, l.shard_len, l.shards]
                                              for l in lays])
            res[f"{name}|lowering"] = np.array([l.lowering for l in lays])


    def exchanges():
        os.environ["HVD_TPU_TOPO_LOWER"] = "flat"
        os.environ["HVD_TPU_SCHED_WIRE"] = "off"
        res.update(traced(body, jnp.asarray(data["xd"]), jnp.asarray(data["xg"]),
                          jnp.asarray(data["rq"])))
        for wire in ("off", "bf16"):
            res[f"do|{wire}"] = do_step("reduce_scatter", wire)
        res["do|hier"] = do_step("reduce_scatter", lowering="hier")


    def body(x, xg, rq):
        out = {}
        kw = dict(axis=WORLD_AXIS)
        out["rsf|scaled"] = jx.reduce_scatter_flat(x, average=True, prescale_factor=0.5,
                                                   postscale_factor=3.0, **kw)
        out["rsf|upd"] = jx.reduce_scatter_flat(x, average=False, shard_update=upd, **kw)
        out["rsf|bf16"] = jx.reduce_scatter_flat(x.astype(jnp.bfloat16), average=True, **kw)
        out["hrs|off"] = jx.hier_reduce_scatter_flat(x, average=True, prescale_factor=0.5,
                                                     postscale_factor=3.0, **kw)
        out["hrs|bf16"] = jx.hier_reduce_scatter_flat(x, average=True, wire="bf16", **kw)
        out["hrs|upd"] = jx.hier_reduce_scatter_flat(x, average=False, shard_update=upd, **kw)
        out["qx|upd"] = jx.quantized_exchange_flat(xg, average=True, wire="int8",
                                                   shard_update=upd, **kw)[0]
        out["qx|ef"], out["qx|ef_res"] = jx.quantized_exchange_flat(
            xg, average=True, wire="int8", shard_update=upd, residual=rq, **kw)
        return out

    def do_step(mode, wire="off", **kw):
        os.environ["HVD_TPU_SCHED_MODE"] = mode
        os.environ["HVD_TPU_SCHED_WIRE"] = wire
        opt = hvd.DistributedOptimizer(optax.sgd(1.0), **kw)

        def body(w, b, xs, ys):
            params = {"w": w, "b": b}
            state = opt.init(params)
            for i in range(2):
                def loss(p):
                    return jnp.mean((xs[i] @ p["w"] + p["b"] - ys[i]) ** 2)
                updates, state = opt.update(jax.grad(loss)(params), state, params)
                params = optax.apply_updates(params, updates)
            return jnp.concatenate([params["w"].reshape(-1), params["b"]])

        stack = lambda a: jnp.asarray(np.stack([a] * N))
        xs = jnp.asarray(data["sx"].reshape(2, N, 4, 6).transpose(1, 0, 2, 3))
        ys = jnp.asarray(data["sy"].reshape(2, N, 4, 1).transpose(1, 0, 2, 3))
        return traced(body, stack(data["sw"]), stack(data["sb"]), xs, ys)

    # Three processes, run side by side: the flat steps, the hierarchical
    # steps, and the exchanges with the optimizer.
    {"flat": lambda: steps(("flat",)), "hier": lambda: steps(("hier", "hier_adasum")),
     "exchanges": exchanges}[sys.argv[1]]()
    np.savez(f"{OUT}/jax_{sys.argv[1]}.npz", **res)
    hvd.shutdown()
""")


def _grid(rng, rows, cols):
    """float32 multiples of 1/4 in [-10, 10] with 31.75 (= 127/4) once in
    every ``BLOCK``-block: every int8 scale is exactly 1/4
    (``tests/test_torch_process_sets.py``)."""
    x = rng.integers(-40, 41, (rows, cols)).astype(np.float32) / 4
    x.reshape(rows, -1, BLOCK)[:, :, 5] = 31.75
    return x


def _data():
    rng = np.random.RandomState(0)
    d = {"w": rng.randn(5, 3).astype(np.float32), "b": np.zeros(3, np.float32),
         "x": rng.randn(32, 5).astype(np.float32), "y": rng.randn(32, 3).astype(np.float32)}
    g = np.random.default_rng(5)
    d.update({
        "dw": (g.integers(-4, 5, (5, 3)) / 8).astype(np.float32),
        "db": (g.integers(-4, 5, 3) / 8).astype(np.float32),
        "dx": (g.integers(-4, 5, (32, 5)) / 4).astype(np.float32),
        "dy": (g.integers(-4, 5, (32, 3)) / 4).astype(np.float32),
        "xd": (g.integers(-8, 9, (N, 37)) / 8).astype(np.float32),
        "xg": _grid(g, N, 3 * BLOCK),
        "rq": (g.integers(-2, 3, (N, 3 * BLOCK)) / 8).astype(np.float32),
        "sx": (g.integers(-2, 3, (2, 16, 6)) / 2).astype(np.float32),
        "sy": (g.integers(-3, 4, (2, 16, 1)) / 4).astype(np.float32),
        "sw": (g.integers(-2, 3, (6, 1)) / 8).astype(np.float32),
        "sb": np.array([0.25], np.float32),
    })
    return d


def _clean_env():
    """The environment of a child: the parent's, less every knob of either
    package and the launcher's rank variables (a test that ran before in
    this worker may have left one set), plus this file's knobs."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_TPU_", "HOROVOD_"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "XLA_FLAGS")}
    env.update(KNOBS, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    return env


def _run_world(tmp):
    data = _data()
    np.savez(tmp / "data.npz", **data)
    common = _COMMON.replace("RUNS_LITERAL", repr(RUNS))
    (tmp / "worker.py").write_text(common + _WORKER)
    (tmp / "jax_side.py").write_text(common + _JAX)
    env = _clean_env()
    parts = ("flat", "hier", "exchanges")
    cmds = [[sys.executable, str(tmp / "worker.py"), str(r), str(N), str(tmp / "store"),
             str(tmp)] for r in range(N)]
    cmds += [[sys.executable, str(tmp / "jax_side.py"), part, str(tmp)] for part in parts]
    names = [f"rank {r}" for r in range(N)] + [f"the JAX side's {part}" for part in parts]
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = []
        for name, p in zip(names, procs):
            try:
                outs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                raise AssertionError(f"{name} did not finish within {WORLD_TIMEOUT} s: "
                                     f"{p.communicate()[0]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p, out in zip(names, procs, outs):
        assert p.returncode == 0, f"{name} exited with {p.returncode}:\n{out}"
    want = {}
    for part in parts:
        want.update(np.load(tmp / f"jax_{part}.npz"))
    return data, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)], want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_zero1_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        result = _run_world(tmp_path_factory.mktemp("zero1"))
        with open(path, "wb") as f:
            pickle.dump(result, f)
    return result


def _bitwise(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)


def _grad_max(d):
    """The largest element of a rank's gradient at the start (normal data)."""
    x, y = d["x"].reshape(N, 8, 5), d["y"].reshape(N, 8, 3)
    return max(np.abs(2 * xr.T @ (xr @ d["w"] - yr) / yr.size).max() for xr, yr in zip(x, y))


def _tolerance(name, d):
    """(rtol, atol) of a run against the JAX step (module docstring)."""
    if name in ("sgd", "hier"):
        return None  # bitwise
    if name == "adamw":
        return 1e-5, 1e-5
    if name == "clip":
        return 1e-5, 1e-6
    if name in ("int8", "fp8"):
        step = 1 / 127 if name == "int8" else 2.0 ** -3
        return 0, RUNS[name][4] * 0.1 * _grad_max(d) * step
    if name == "hier_int8":
        return 0, 5e-7
    return 0, 1e-6  # hier_adasum


@pytest.mark.parametrize("name", list(RUNS))
def test_bucketed_step_matches_jax(world, name):
    d, ranks, want = world
    tol = _tolerance(name, d)
    for r, got in enumerate(ranks):
        for leaf in ("w", "b"):
            key = f"{name}|{leaf}"
            if tol is None:
                _bitwise(got[key], want[key], f"{key} rank {r}")
            else:
                np.testing.assert_allclose(got[key], want[key], rtol=tol[0], atol=tol[1],
                                           err_msg=f"{key} rank {r}")
            _bitwise(got[key], ranks[0][key], f"{key}: rank {r} against rank 0")
        np.testing.assert_array_equal(got[f"{name}|layout"], want[f"{name}|layout"])
        np.testing.assert_array_equal(got[f"{name}|lowering"], want[f"{name}|lowering"])
    assert not np.array_equal(ranks[0][f"{name}|w"], d[RUNS[name][3] + "w"])


@pytest.mark.parametrize("name", ["adamw", "hier", "int8"])
def test_the_state_is_sharded(world, name):
    """AdamW's two moments, SGD's momentum: ``padded / 4`` elements a
    bucket on every rank (flat), ``padded / 2`` (hier); the int8 buckets
    padded to 4·512, each with a residual of that length."""
    _, ranks, _ = world
    shards = N if RUNS[name][0] == "flat" else 2
    for got in ranks:
        layout = got[f"{name}|layout"]
        assert len(layout) == 2  # w, then b: every leaf its own bucket
        assert list(layout[:, 3]) == [shards, shards]
        assert list(layout[:, 2]) == list(layout[:, 1] // shards)
        tensors = {"adamw": 2, "hier": 1, "int8": 0}[name]  # moments, momentum, none
        for (count, low, high), lay in zip(got[f"{name}|state"], layout):
            assert count == tensors and (not count or low == high == lay[2])
        if name == "int8":
            assert list(layout[:, 1]) == [N * BLOCK] * 2
            assert list(got["int8|ef_len"]) == [N * BLOCK] * 2
            assert (got["int8|ef"] > 0).all()


def test_hierarchical_buckets_run_without_error_feedback(world):
    _, ranks, _ = world
    for got in ranks:
        assert list(got["hier_int8|ef_len"]) == [0, 0]
        assert list(got["hier_int8|lowering"]) == ["hier", "hier"]
        assert list(got["hier_adasum|lowering"]) == ["hier_adasum", "hier_adasum"]


@pytest.mark.parametrize("key", ["rsf|scaled", "rsf|upd", "rsf|bf16", "hrs|off", "hrs|bf16",
                                 "hrs|upd", "qx|upd", "qx|ef", "qx|ef_res"])
def test_the_exchanges_match_jax(world, key):
    """Bitwise, but for the residual of the error feedback: with the
    residual added, ``g + r`` leaves the int8 grid, and XLA:CPU fuses
    ``e − q·s`` into an FMA where the port rounds the product first
    (ROADMAP Queue C, FMA contraction): 5e-7 of Σ|g + r| over the ranks
    (``tests/test_torch_process_sets.py``'s bound).  The gathered result
    is bitwise all the same here."""
    d, ranks, want = world
    for r, got in enumerate(ranks):
        if key == "qx|ef_res":
            bound = 5e-7 * (np.abs(d["xg"] + d["rq"]).sum(0) * 1.125).max()
            np.testing.assert_allclose(got[key], want[key][r], rtol=0, atol=bound)
        else:
            _bitwise(got[key], want[key][r], f"{key} rank {r}")


def _bf16_bound(d):
    """Two steps x lr 1 x (N - 1) roundings of 2^-9 of a sum of N local
    gradients, over N (the average): gloo adds the ranks' bf16 gradients
    in bf16, one rounding per addition, where XLA:CPU rounds the float32
    sum once (``tests/test_torch_zero.py``)."""
    x, y = d["sx"][0].reshape(N, 4, 6), d["sy"][0].reshape(N, 4, 1)
    g = sum(np.abs(2 * xr.T @ (xr @ d["sw"] + d["sb"] - yr) / yr.size).max()
            for xr, yr in zip(x, y))
    return 2 * (N - 1) * 2.0 ** -9 * g / N


@pytest.mark.parametrize("case", ["off", "bf16", "hier"])
def test_reduce_scatter_mode_matches_jax(world, case):
    """Bitwise with the JAX optimizer and with the allreduce mode on the
    dense wire (the dyadic sums are exact in any order); on bf16 within
    :func:`_bf16_bound` of the JAX optimizer."""
    d, ranks, want = world
    for r, got in enumerate(ranks):
        key = f"do|reduce_scatter|{case}"
        if case == "bf16":
            np.testing.assert_allclose(got[key], want[f"do|{case}"][r], rtol=0,
                                       atol=_bf16_bound(d))
        else:
            _bitwise(got[key], want[f"do|{case}"][r], f"{case} rank {r}")
            _bitwise(got[key], got[f"do|allreduce|{case}"], f"{case} modes")
        _bitwise(got[key], ranks[0][key], f"{case}: rank {r} against rank 0")


DO_CASES = ["off", "bf16", "hier", "set", "adasum"]


def test_calls_by_mode_a_set_and_adasum_keep_the_allreduce(world):
    """Per two steps: under ``reduce_scatter`` the world's dense and bf16
    buckets each take one ``reduce_scatter_flat`` a step, the hier
    buckets ``hier_reduce_scatter_flat``; the process set {0,1} and
    ``op=Adasum`` keep the allreduce and its bits; under ``allreduce``
    nothing takes the reduce-scatter.  A mode changed between two steps
    of one optimizer takes effect at the next step (the mode is part of
    the plan's key)."""
    _, ranks, _ = world
    for r, got in enumerate(ranks):
        calls = got["do_calls"].reshape(2, len(DO_CASES), 3)
        for m, mode in enumerate(("reduce_scatter", "allreduce")):
            for c, case in enumerate(DO_CASES):
                rs, hrs, buckets = calls[m, c]
                want_rs = 2 * buckets if mode == "reduce_scatter" and case in ("off", "bf16") else 0
                want_hrs = 2 * buckets if mode == "reduce_scatter" and case == "hier" else 0
                assert (rs, hrs) == (want_rs, want_hrs), (r, mode, case, calls[m, c])
        for case in ("set", "adasum"):
            _bitwise(got[f"do|reduce_scatter|{case}"], got[f"do|allreduce|{case}"],
                     f"{case} rank {r}")
        assert list(got["mode_switch"]) == [0, 1, 0]
    # Off the set, ranks 2 and 3 keep their own gradients.
    assert not np.array_equal(ranks[0]["do|reduce_scatter|set"], ranks[2]["do|reduce_scatter|set"])


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("wire", ["off", "int8"])
def test_bucket_layouts_match_jax(world, wire):
    """``bucket_layouts`` from the parameters' metadata alone (no world,
    no runtime), against the JAX package's on the same shapes (in its
    sorted key order) and knobs: indices, shapes, valid and padded
    lengths, shard length and shard count."""
    from horovod_tpu.sched import plan as jplan
    from horovod_tpu.sched.zero1 import bucket_layouts as jlayouts

    from horovod_tpu_torch.sched import bucket_layouts

    shapes = {"a": (300,), "b": (5, 3), "c": (7,), "d": (2, 64)}
    jcfg = jplan.SchedConfig(bucket_bytes=512, wire=wire, lowering="flat")
    tcfg = SchedConfig(bucket_bytes=512, wire=wire, lowering="flat")
    want = jlayouts({k: np.zeros(v, np.float32) for k, v in shapes.items()}, world, jcfg)
    got = bucket_layouts([torch.zeros(v) for v in shapes.values()], world, tcfg)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g.indices, g.shapes, g.sizes, g.n, g.padded, g.shard_len, g.wire,
                g.lowering, g.shards) == (tuple(w.indices), w.shapes, w.sizes, w.n, w.padded,
                                          w.shard_len, w.wire, w.lowering, w.shards)


def test_init_records_the_schedule_metrics():
    """``init`` publishes the JAX package's ``_record`` (``:384-391``):
    the buckets and bytes per step, one more ZeRO step built, the wire
    bytes per wire."""
    thvd.init("cpu")
    try:
        metrics.reset("sched.")
        step = bucketed_zero_step(_mse, lambda p: torch.optim.SGD(p, lr=0.1),
                                  cfg=SchedConfig(bucket_bytes=32, wire="int8"))
        step.init(_model())
        assert metrics.get_counter("sched.zero_steps_built") == 1
        assert metrics.get_gauge("sched.buckets_per_step") == len(step.schedule) > 1
        assert metrics.get_gauge("sched.bytes_per_step") == 4 * (3 * 4 + 4 + 4 * 2 + 2)
        wire = sum(b.nbytes // 4 + 4 for b in step.schedule.buckets)  # a block each
        assert metrics.get_gauge("sched.wire_bytes", {"wire": "int8"}) == wire
    finally:
        thvd.shutdown()


# -------------------------------------------- the capture, card faked


class _Graph:
    """Stands in for a CUDA graph: a replay runs the captured step eagerly
    on the static inputs and writes its loss into the static loss
    (``tests/test_torch_onestep.py``)."""

    def __init__(self, step, static, spec, loss):
        self.run = lambda: loss.copy_(step._step(tree_unflatten(static, spec)))
        self.resets = self.replays = 0

    def replay(self):
        self.replays += 1
        self.run()

    def reset(self):
        self.resets += 1


def _faked(monkeypatch, step):
    """``step`` on the CPU as if on a card of an NCCL world: its warm-up
    runs eagerly, a capture makes a :class:`_Graph`."""
    graphs = []

    def capture(leaves, spec):
        static = [t.clone() for t in leaves]
        loss = torch.zeros(())
        graphs.append(_Graph(step, static, spec, loss))
        metrics.inc_counter("xir.onestep.steps")
        return dopt._Captured(graphs[-1], static, loss, {})

    monkeypatch.setattr(thvd.runtime.get_runtime(), "backend", "nccl")
    monkeypatch.setattr(step, "_device", lambda: torch.device("cuda"))
    monkeypatch.setattr(step, "_side_stream_step",
                        lambda batch, mode, device: step._eager(batch, mode))
    monkeypatch.setattr(step, "_capture", capture)
    return graphs


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))


def _mse(model, batch):
    return ((model(batch[0]) - batch[1]) ** 2).mean()


def _fsdp_loss(params, batch):
    h = batch[0] @ params["0.weight"].T + params["0.bias"]
    return ((h @ params["1.weight"].T + params["1.bias"] - batch[1]) ** 2).mean()


def _sharded(kind, make_optimizer):
    """(step, call(batch) -> loss, a function of the weights) of ``kind``."""
    model = _model()
    if kind == "fsdp":
        step = thvd.fsdp_train_step(_fsdp_loss, make_optimizer)
        state = list(step.init(dict(model.named_parameters())))

        def call(batch):
            state[0], state[1], loss = step(state[0], state[1], batch)
            return loss
        return step, call, lambda: state[0].detach().clone()
    if kind == "zero":
        step = thvd.zero_train_step(_mse, make_optimizer, wire="off")
    else:
        step = bucketed_zero_step(_mse, make_optimizer, cfg=SchedConfig(bucket_bytes=32))
    state = step.init(model)
    return step, lambda batch: step(model, state, batch)[2], \
        lambda: torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _batch(i, rows):
    g = torch.Generator().manual_seed(i)
    return torch.randn(rows, 3, generator=g), torch.randn(rows, 2, generator=g)


KINDS = ["zero", "fsdp", "bucketed"]


@pytest.mark.parametrize("kind", KINDS)
def test_the_sharded_steps_capture_as_the_data_parallel_step(monkeypatch, kind):
    """Under ``on``: two warm-up steps, a capture, replays; a new batch
    shape warms up and captures beside the first, whose graph then
    replays at once; the losses and weights equal an eager run's.  A new
    model and state drop both graphs."""
    rows = [4, 4, 4, 4, 2, 2, 2, 4]

    def run(fake):
        monkeypatch.setenv("HVD_TPU_ONESTEP", "on" if fake else "off")
        metrics.reset("xir.")
        thvd.init("cpu")
        try:
            step, call, weights = _sharded(kind, lambda p: torch.optim.SGD(p, lr=0.1,
                                                                          momentum=0.9))
            graphs = _faked(monkeypatch, step) if fake else []
            losses = [float(call(_batch(i, r))) for i, r in enumerate(rows)]
            out = weights()
            held = step.graphs
            if fake:  # another model and state under the same step
                if kind == "fsdp":
                    step(*step.init(dict(_model().named_parameters())), _batch(0, 4))
                else:
                    model = _model()
                    step(model, step.init(model), _batch(0, 4))
            return losses, out, graphs, held
        finally:
            thvd.shutdown()

    losses, weights, graphs, held = run(fake=True)
    want_losses, want_weights, _, _ = run(fake=False)
    assert losses == want_losses
    assert torch.equal(weights, want_weights)
    assert held == 2 and len(graphs) == 2
    assert [g.replays for g in graphs] == [3, 1]
    assert [g.resets for g in graphs] == [1, 1]  # dropped by the new state


@pytest.mark.parametrize("kind", KINDS)
def test_on_refuses_adamw_without_capturable(monkeypatch, kind):
    """AdamW reads its step count on the host unless ``capturable=True``:
    ``on`` raises naming it, ``auto`` runs the step eagerly."""
    thvd.init("cpu")
    try:
        step, call, weights = _sharded(kind, lambda p: torch.optim.AdamW(p, lr=1e-2))
        monkeypatch.setattr(thvd.runtime.get_runtime(), "backend", "nccl")
        monkeypatch.setattr(step, "_device", lambda: torch.device("cuda"))
        monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
        before = weights()
        with pytest.raises(HorovodTpuError, match="capturable=False"):
            call(_batch(0, 4))
        assert torch.equal(weights(), before)
        monkeypatch.setenv("HVD_TPU_ONESTEP", "auto")
        for i in range(4):
            assert torch.isfinite(call(_batch(i, 4)))
        assert step.graphs == 0
        assert metrics.get_gauge("sched.onestep.engaged", {"mode": "auto"}) == 0.0
    finally:
        thvd.shutdown()


def test_a_changed_mode_drops_the_data_parallel_graphs(monkeypatch):
    """``HVD_TPU_SCHED_MODE`` is part of ``TrainStep``'s key: changed
    after a capture, the graph is dropped and the step warms up and
    captures anew."""
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    thvd.init("cpu")
    try:
        model = _model()
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        step = thvd.TrainStep(model, opt, _mse)
        graphs = _faked(monkeypatch, step)
        for i, mode in enumerate(["allreduce"] * 4 + ["reduce_scatter"] * 3):
            monkeypatch.setenv("HVD_TPU_SCHED_MODE", mode)
            step(_batch(i, 4))
        assert len(graphs) == 2 and [g.resets for g in graphs] == [1, 0]
        assert [g.replays for g in graphs] == [2, 1]
    finally:
        thvd.shutdown()
