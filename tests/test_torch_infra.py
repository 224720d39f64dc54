"""The port's infrastructure against the JAX package's: the metrics
registry and its renders, the event log, fault plans, the retry policy,
the hierarchical Sum and Average allreduce and ``metric_average``.

* In this process, pure Python: the same seeded sequence of counters,
  labelled gauges and histogram observations fed to both registries
  (``horovod_tpu.metrics`` and ``horovod_tpu_torch.metrics``, each saved
  and restored around the test) gives equal ``snapshot()``, string-equal
  ``render_json()`` and ``render_prometheus()`` (with and without extra
  labels), and equal quantiles and prefix extractions.  ``FaultPlan.parse``
  of one spec and seed fires on the same arrivals (``arm``), with the
  same errors for malformed specs; ``inject`` raises, sleeps, corrupts
  and resizes alike and counts the same ``faults.injected.*`` counters.
  ``RetryPolicy.delay_s`` gives the same sequence for a seed, and
  ``call`` the same attempts, counters and exhaustion.  Event logs
  written by either are read back alike by both ``read_events``.
* One gloo world of four processes under ``HVD_TPU_TOPO=2x2`` (the host
  grid overlaid on one host), run once per session: the world Sum and
  Average allreduce of a dyadic buffer (odd length, so the host's shard
  is padded) with ``HVD_TPU_HIERARCHICAL_ALLREDUCE=1``, bitwise against
  the JAX ``traced.allreduce(..., hierarchical=True)`` on four CPU devices
  with the runtime's host grid overlaid (``local_size, cross_size = 2,
  2``, as ``tests/test_collectives.py`` overlays it) and against the flat
  allreduce; a ``topo.dcn_phase:slow`` plan selecting rank 1 fires on
  rank 1 only; ``metric_average`` over the world and over the set {0, 1}
  against the JAX ``metric_average`` fed the same rows (its runtime and
  process allgather stood in for four processes); and the eager
  histograms (``collective.<op>.bytes_hist``, ``.dispatch_seconds``) and
  the fit's flat ``topo.obs.*`` cells the calls leave.  In the same
  world, an ``AutotuneDriver`` and a ``ScheduleTuner`` on every rank, each
  timing its windows on a clock of its own whose best variant differs by
  rank, freeze rank 0's variant on every rank, over the same windows
  (each alone freezes its own), and an unsettled call on one rank
  restarts every rank's window.
"""

import copy
import json
import os
import pickle
import random
import subprocess
import sys
import textwrap
import types

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import events as jevents
from horovod_tpu import faults as jfaults
from horovod_tpu import metrics as jmetrics
from horovod_tpu.exceptions import FaultInjected as JaxFaultInjected
from horovod_tpu.exceptions import RetryTimeoutError as JaxRetryTimeoutError
from horovod_tpu.ops import traced
from horovod_tpu.runtime import WORLD_AXIS, get_runtime
from horovod_tpu.utils import retry as jretry
from horovod_tpu_torch import events as tevents
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.exceptions import FaultInjected, RetryTimeoutError
from horovod_tpu_torch.utils import retry as tretry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


@pytest.fixture(autouse=True)
def _registries():
    """Both registries empty for the test and restored after it; no fault
    plan or event log outlives it."""
    saved = []
    for m in (jmetrics, tmetrics):
        lock = getattr(m, "_counter_lock", None) or m._lock
        with lock:
            saved.append((dict(m._counters), dict(m._gauges),
                          copy.deepcopy(m._histograms)))
            m._counters.clear()
            m._gauges.clear()
            m._histograms.clear()
    yield
    for m, (c, g, h) in zip((jmetrics, tmetrics), saved):
        lock = getattr(m, "_counter_lock", None) or m._lock
        with lock:
            m._counters.clear()
            m._counters.update(c)
            m._gauges.clear()
            m._gauges.update(g)
            m._histograms.clear()
            m._histograms.update(h)
    for f in (jfaults, tfaults, jevents, tevents):
        f.reset()


# ------------------------------------------------------------ metrics


def _feed(seed):
    """A seeded sequence of registry records, the same on both sides."""
    rng = random.Random(seed)
    names = ["a", "sched.buckets", "collective.allreduce.bytes", "x.y-z", "q:w"]
    ops = []
    for _ in range(60):
        kind = rng.choice(["counter", "gauge", "observe", "observe_bytes"])
        name = rng.choice(names)
        if kind == "counter":
            ops.append(("inc_counter", (name, rng.randint(1, 1 << 20)), {}))
        elif kind == "gauge":
            labels = rng.choice([None, {"wire": rng.choice(["int8", 'b"f\\16'])},
                                 {"op": "ar", "rank": str(rng.randint(0, 3))}])
            ops.append(("set_gauge", (name, rng.uniform(-1e3, 1e3)), {"labels": labels}))
        elif kind == "observe":
            ops.append(("observe", (name + ".seconds", rng.expovariate(20.0)), {}))
        else:
            ops.append(("observe", (name + ".bytes_hist", float(rng.randint(0, 1 << 31))),
                        {"buckets": jmetrics.BYTES_BUCKETS}))
    if rng.random() < 0.5:
        ops.append(("clear_gauge", (rng.choice(names),), {}))
    return ops


def _apply(m, ops):
    for fn, args, kw in ops:
        if fn == "observe" and "buckets" in kw:
            kw = {"buckets": m.BYTES_BUCKETS}
        getattr(m, fn)(*args, **kw)


@pytest.mark.parametrize("seed", range(6))
def test_registry_renders_match_jax(seed):
    ops = _feed(seed)
    _apply(jmetrics, ops)
    _apply(tmetrics, ops)
    assert tmetrics.snapshot() == jmetrics.snapshot()
    assert tmetrics.render_json() == jmetrics.render_json()
    assert tmetrics.render_prometheus() == jmetrics.render_prometheus()
    assert (tmetrics.render_prometheus(prefix="p", extra_labels={"rank": "3"})
            == jmetrics.render_prometheus(prefix="p", extra_labels={"rank": "3"}))
    for prefix in ("", "a", "sched.", "x.y"):
        assert tmetrics.get_counters(prefix) == jmetrics.get_counters(prefix)
        assert tmetrics.histograms_by_prefix(prefix) == jmetrics.histograms_by_prefix(prefix)
        assert tmetrics.gauges_by_prefix(prefix) == jmetrics.gauges_by_prefix(prefix)
    for name in tmetrics.snapshot()["histograms"]:
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert tmetrics.quantile(name, q) == jmetrics.quantile(name, q)
    tmetrics.reset_counters("sched")
    jmetrics.reset_counters("sched")
    assert tmetrics.render_prometheus() == jmetrics.render_prometheus()
    tmetrics.reset()
    assert tmetrics.snapshot() == {"counters": {}, "gauges": [], "histograms": {}}


@pytest.mark.parametrize("hist", [
    {"buckets": [1.0, 2.0], "counts": [0, 0, 0], "sum": 0.0, "count": 0},
    {"buckets": [1.0, 2.0, 4.0], "counts": [1, 0, 3, 2], "sum": 17.0, "count": 6},
    {"buckets": [], "counts": [5], "sum": 5.0, "count": 5},
])
def test_hist_quantile_matches_jax(hist):
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert tmetrics.hist_quantile(hist, q) == jmetrics.hist_quantile(hist, q)
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError):
            tmetrics.hist_quantile(hist, bad)


# ------------------------------------------------------------ events


def test_event_logs_read_alike(tmp_path):
    assert {k: v for k, v in vars(tevents).items() if k.isupper()} == \
        {k: v for k, v in vars(jevents).items() if k.isupper()}
    for m, name in ((jevents, "j.jsonl"), (tevents, "t.jsonl")):
        log = m.EventLog(str(tmp_path / name))
        m.set_event_log(log)
        m.emit(m.ROUND_START, round=1)
        m.emit(m.BLACKLIST, host="h1", reason={"a": [1, 2]})
        m.set_event_log(None)
        m.emit(m.ROUND_END, round=1)  # no log: a no-op
    with open(tmp_path / "t.jsonl", "a") as f:
        f.write('{"event": "torn')  # a crashed writer's partial line
    for path in (tmp_path / "j.jsonl", tmp_path / "t.jsonl"):
        got, want = tevents.read_events(str(path)), jevents.read_events(str(path))
        assert got == want
    drop = ("wall_ts", "mono_ts", "pid")
    j = [{k: v for k, v in e.items() if k not in drop}
         for e in jevents.read_events(str(tmp_path / "j.jsonl"))]
    t = [{k: v for k, v in e.items() if k not in drop}
         for e in tevents.read_events(str(tmp_path / "t.jsonl"))]
    assert t == j and [e["seq"] for e in t] == [1, 2]


# ------------------------------------------------------------ faults

PLANS = [
    "seed=3;a.b:error:p=0.5,times=0",
    "a.b:error:nth=2;a.b:slow:secs=0,times=2;c:corrupt:rank=1",
    "seed=11;a.b:flake:p=0.3,times=3,round=2;c:resize_to:np=3,nth=4",
    "seed=7;c:corrupt:p=0.7,times=0,host=h2;a.b:kill_at_step:step=5;a.b:hang:secs=0,nth=3",
]


@pytest.mark.parametrize("spec", PLANS)
def test_fault_plans_fire_alike(spec):
    jp, tp = jfaults.FaultPlan.parse(spec), tfaults.FaultPlan.parse(spec)
    assert tp.seed == jp.seed and tp.sites() == jp.sites()
    rng = random.Random(spec)
    for _ in range(200):
        site = rng.choice(["a.b", "c", "zz"])
        ctx = {"rank": rng.randint(0, 2), "round": rng.randint(1, 3),
               "host": rng.choice(["h1", "h2"]), "step": rng.randint(1, 6)}
        js, ts = jp.arm(site, ctx), tp.arm(site, ctx)
        assert (None if ts is None else (ts.site, ts.kind, ts.secs, ts.code, ts.np)) == \
            (None if js is None else (js.site, js.kind, js.secs, js.code, js.np))
    assert tp.counters() == jp.counters()


@pytest.mark.parametrize("spec", ["a", "a:nope", "a:error:x", "a:resize_to",
                                  "a:kill_at_step:nth=1"])
def test_malformed_fault_plans_raise_alike(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        tfaults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_inject_acts_and_counts_alike():
    spec = "e:error:msg=boom;s:slow:secs=0;c:corrupt;r:resize_to:np=2;topo.dcn_phase:slow:secs=0"
    for m, exc in ((jfaults, JaxFaultInjected), (tfaults, FaultInjected)):
        m.set_plan(spec)
        with pytest.raises(exc) as e:
            m.inject("e", rank=0)
        assert str(e.value) == "boom" and e.value.site == "e"
        assert m.inject("s") is False
        assert m.inject("c") is True
        assert m.inject("r") == {"np": 2}
        assert m.inject("c") is False  # times=1: fired once
        assert m.inject("unarmed") is False
        m.set_plan(None)
        assert m.inject("e") is False
    assert tmetrics.get_counters("faults.") == jmetrics.get_counters("faults.")
    assert tfaults.FaultPlan.parse("topo.dcn_phase:slow").arms_step()
    assert not tfaults.FaultPlan.parse("worker.commit:crash").arms_step()


# ------------------------------------------------------------ retry


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_retry_delays_and_attempts_match_jax(seed):
    kw = dict(max_attempts=6, base_delay_s=0.05, multiplier=3.0, max_delay_s=1.0,
              jitter=0.25, seed=seed)
    jp, tp = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
    assert [tp.delay_s(k) for k in range(1, 12)] == [jp.delay_s(k) for k in range(1, 12)]

    def run(mod, fails):
        slept = []
        left = [fails]

        def flaky():
            if left[0]:
                left[0] -= 1
                raise OSError("flake")
            return "ok"

        pol = mod.RetryPolicy(name="probe", sleep=slept.append, **kw)
        try:
            out = pol.call(flaky)
        except OSError:
            out = "exhausted"
        return out, slept

    for fails in (0, 2, 9):
        assert run(tretry, fails) == run(jretry, fails)
    assert tmetrics.get_counters("retry.") == jmetrics.get_counters("retry.")


def test_retry_attempt_timeout_matches_jax():
    import time

    for mod, exc in ((jretry, JaxRetryTimeoutError), (tretry, RetryTimeoutError)):
        pol = mod.RetryPolicy(max_attempts=2, attempt_timeout_s=0.05, jitter=0,
                              base_delay_s=0, name="slow", sleep=lambda s: None)
        with pytest.raises(exc):
            pol.call(time.sleep, 0.5)
    assert tmetrics.get_counters("retry.") == jmetrics.get_counters("retry.")


# ------------------------------------------------------------ the world of four

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults, metrics
    from horovod_tpu_torch.ops import collectives

    from horovod_tpu_torch.sched.tune import ScheduleTuner
    from horovod_tpu_torch.utils import autotune


    def tune_world(rank):
        # An AutotuneDriver and a ScheduleTuner, each rank timing its
        # windows on its own clock: rank r's best threshold is near
        # 2^(18+2r), the hierarchical lowering wins on the even ranks, the
        # int8 wire on rank 0 alone; rank 1 alone reports its third call
        # unsettled.
        os.environ.update(HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES="3",
                          HVD_TPU_AUTOTUNE_HIER_WINDOWS="1",
                          HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED="1")
        cost = lambda thr, hier, quant: 1e-3 * (1 + abs(np.log2(thr) - 18 - 2 * rank)) * (
            0.5 if hier == (rank % 2 == 0) else 1.0) * (0.8 if quant == (rank == 0) else 1.0)
        drv = autotune.AutotuneDriver(window_steps=3, quant_eligible=True)
        clock = [0.0]
        drv._time = types.SimpleNamespace(perf_counter=lambda: clock[0])
        calls = 0
        while not drv.converged and calls < 300:
            clock[0] += cost(drv.threshold_bytes(), drv.hierarchical(), drv.quantized())
            calls += 1
            drv.after_step(torch.zeros(()), settled=not (rank == 1 and calls == 3))
        frozen = [drv.threshold_bytes(), drv.hierarchical(), drv.quantized()]
        windows = [[w["threshold"], w["hierarchical"], w["quantized"], w["score"],
                    list(w["calls"])] for w in drv.windows]
        tuner = ScheduleTuner(warmup_windows=3)
        while not tuner.converged:
            tuner.begin_window()
            metrics.inc_counter("train.steps", 4)
            metrics.observe("train.step_seconds", 4 * cost(tuner.bucket_bytes(), 0, 0))
            tuner.end_window()
        for k in ("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "HVD_TPU_AUTOTUNE_HIER_WINDOWS",
                  "HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED"):
            os.environ.pop(k)
        return (np.array(json.dumps(frozen)), np.array(json.dumps(windows)),
                np.array(tuner.bucket_bytes()))


    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    pair = hvd.ProcessSet([0, 1])
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60,
             process_sets=[pair])
    data = dict(np.load(out + "/data.npz"))
    res = {}
    try:
        x = torch.from_numpy(data["x"][rank].copy())
        for op, name in ((hvd.Sum, "sum"), (hvd.Average, "avg")):
            res[f"flat|{name}"] = hvd.allreduce(x, op=op).numpy()
            os.environ["HVD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
            res[f"hier|{name}"] = hvd.allreduce(x, op=op).numpy()
            os.environ.pop("HVD_TPU_HIERARCHICAL_ALLREDUCE")
            # "override": the explicit argument a tuned optimizer passes.
            res[f"override|{name}"] = collectives.allreduce_(
                x.clone(), op, hierarchical=True).numpy()
        faults.set_plan("topo.dcn_phase:slow:rank=1,secs=0.05,times=0")
        collectives.allreduce_(x.clone(), hvd.Sum, hierarchical=True)
        collectives.allreduce_(x.clone(), hvd.Sum, hierarchical=True)
        faults.set_plan(None)
        res["fired"] = np.array(metrics.get_counter("faults.injected.topo.dcn_phase.slow"))
        value = {"a": rank + 1.0, "b": [rank * 0.5 - 0.25, 2.0 ** -rank]}
        res["avg|world"] = np.array(json.dumps(metrics.metric_average(value)))
        res["avg|pair"] = np.array(json.dumps(metrics.metric_average(value, pair)))
        metrics.reset()
        y = torch.from_numpy(data["x"][rank][:512].copy())
        for _ in range(4):
            hvd.allreduce(y, op=hvd.Sum)
            hvd.allgather(y)
            hvd.reducescatter(y, op=hvd.Sum)
        hvd.allreduce(y, process_set=pair)
        res["snapshot"] = np.array(json.dumps(metrics.snapshot()))
        tuned = tune_world(rank)
        autotune._world, world = (lambda: None), autotune._world
        res["tune|alone"] = tune_world(rank)[0]
        autotune._world = world
        res["tune|frozen"], res["tune|windows"], res["tune|sched"] = tuned
        np.savez(out + f"/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""").replace("import os, sys", "import json, os, sys, types")


def _data():
    rng = np.random.default_rng(5)
    return {"x": (rng.integers(-64, 65, (N, 1001)) / 16).astype(np.float32)}


def _spawn(tmp, n):
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, HVD_TPU_TOPO="2x2")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_HIERARCHICAL_ALLREDUCE",
              "HVD_TPU_FAULT_PLAN", "HVD_TPU_TOPO_LOWER"):
        env.pop(k, None)
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(n), str(tmp / "store"), str(tmp)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        return procs
    except BaseException:
        for p in procs:
            p.kill()
        raise


def _collect(procs, tmp, n):
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]


def _jax_world(data):
    """The JAX hierarchical allreduce on four CPU devices with the host
    grid overlaid."""
    hvd.init(devices=jax.devices()[:N])
    rt = get_runtime()
    old = rt.local_size, rt.cross_size
    rt.local_size, rt.cross_size = 2, 2
    try:
        spec = P(WORLD_AXIS)

        def body(x):
            return {f"{name}": traced.allreduce(x[0], op=op, hierarchical=True)[None]
                    for op, name in ((traced.Sum, "sum"), (traced.Average, "avg"))}

        f = shard_map(body, mesh=rt.mesh, in_specs=(spec,), out_specs=spec,
                      check_vma=False)
        return {k: np.asarray(v) for k, v in jax.jit(f)(jnp.asarray(data["x"])).items()}
    finally:
        rt.local_size, rt.cross_size = old


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo world of four, run once, beside the JAX results; shared
    across xdist workers behind a lock."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_infra_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        tmp = tmp_path_factory.mktemp("infra")
        data = _data()
        np.savez(tmp / "data.npz", **data)
        procs = _spawn(tmp, N)
        hvd.shutdown()
        try:
            want = _jax_world(data)
        finally:
            hvd.shutdown()
        ranks = _collect(procs, tmp, N)
        with open(path, "wb") as f:
            pickle.dump((data, ranks, want), f)
    return data, ranks, want


def _bitwise(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)


@pytest.mark.parametrize("how", ["hier", "override"])
@pytest.mark.parametrize("op", ["sum", "avg"])
def test_hierarchical_allreduce_matches_jax_and_flat(world, op, how):
    _, ranks, want = world
    for r in range(N):
        _bitwise(ranks[r][f"{how}|{op}"], want[op][r], f"{how} {op} rank {r}")
        _bitwise(ranks[r][f"{how}|{op}"], ranks[r][f"flat|{op}"], f"flat {op} rank {r}")


def test_dcn_fault_fires_on_the_selected_rank_only(world):
    _, ranks, _ = world
    # Two hierarchical calls, one cross-domain hop each.
    assert [int(ranks[r]["fired"]) for r in range(N)] == [0, 2, 0, 0]


def _jax_metric_average(rows, r, members, monkeypatch):
    """The JAX ``metric_average`` as process ``r`` of four sees it."""
    from jax.experimental import multihost_utils

    rt = types.SimpleNamespace(
        process_count=N, process_rank=r,
        devices=[types.SimpleNamespace(process_index=i) for i in range(N)])
    monkeypatch.setattr(jmetrics.runtime, "get_runtime", lambda: rt)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda arr: np.stack([np.asarray([
                            float(v) for v in jax.tree.leaves(row)], np.float64)
                            for row in rows]))
    ps = None if members is None else types.SimpleNamespace(ranks=members)
    return jmetrics.metric_average(rows[r], ps)


@pytest.mark.parametrize("which", ["world", "pair"])
def test_metric_average_matches_jax(world, which, monkeypatch):
    _, ranks, _ = world
    rows = [{"a": r + 1.0, "b": [r * 0.5 - 0.25, 2.0 ** -r]} for r in range(N)]
    members = None if which == "world" else [0, 1]
    for r in range(N):
        got = json.loads(str(ranks[r][f"avg|{which}"]))
        want = _jax_metric_average(rows, r, members, monkeypatch)
        assert got == json.loads(json.dumps(want)), (which, r)
    if which == "pair":
        assert json.loads(str(ranks[3]["avg|pair"])) == rows[3]


def test_eager_histograms_and_fit_cells(world):
    _, ranks, _ = world
    snap = json.loads(str(ranks[0]["snapshot"]))
    hists, counters = snap["histograms"], snap["counters"]
    for op in ("allreduce", "allgather", "reducescatter"):
        h = hists[f"collective.{op}.bytes_hist"]
        assert h["buckets"] == list(jmetrics.BYTES_BUCKETS)
        assert h["count"] == 4 + (op == "allreduce") and h["sum"] == 2048 * h["count"]
        assert hists[f"collective.{op}.dispatch_seconds"]["count"] == h["count"]
    # 512 float32 = 2048 bytes: bin 11; the set's allreduce feeds no cell.
    for c in ("all_reduce", "all_gather", "reduce_scatter"):
        cell = f"topo.obs.{c}.flat.n4.b11"
        assert hists[cell]["count"] == 4 and counters[cell + ".bytes"] == 4 * 2048
    assert not [k for k in hists if k.startswith("topo.obs.") and ".b11" not in k]


def test_the_tuners_follow_rank_0(world):
    _, ranks, _ = world
    alone = [json.loads(str(ranks[r]["tune|alone"])) for r in range(N)]
    frozen = [json.loads(str(ranks[r]["tune|frozen"])) for r in range(N)]
    windows = [json.loads(str(ranks[r]["tune|windows"])) for r in range(N)]
    # Alone, the ranks' clocks freeze different variants; together, every
    # rank freezes rank 0's, over the same windows and scores.
    assert len({json.dumps(a) for a in alone}) > 1
    assert frozen == [alone[0]] * N
    assert windows == [windows[0]] * N
    # Rank 1's unsettled third call restarted every rank's first window.
    assert windows[0][0][4] == [4, 5]
    assert [int(ranks[r]["tune|sched"]) for r in range(N)] == [int(ranks[0]["tune|sched"])] * N

