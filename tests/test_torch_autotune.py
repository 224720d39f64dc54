"""The port's native core, autotuner, schedule store, schedule tuner and
autotuned ``TrainStep`` against the JAX package's, on the CPU.

* Native core (``horovod_tpu_torch/native.py`` over its copy of
  ``horovod_tpu/cpp``): the library builds (``available()`` is True:
  ``g++`` is here, so a broken build fails instead of falling back), and
  the JAX package's ctypes bindings, loaded over the port's library (so
  nothing is built under ``horovod_tpu/``), give byte-equal
  ``fusion_plan``, ``encode_request``/``encode_response`` and equal
  decodes.  ``ops/fusion.py`` ``bucket_plan`` takes the native plan and
  equals the JAX package's pure-Python plan wherever the native plan
  keeps the look-ahead bound, and the Python plan where it does not.
* ``FusionAutotuner`` (native GP/EI and the grid fallback) suggests the
  same thresholds for the same scores; ``AutotuneDriver._observe_window``
  on the surfaces of ``tests/test_autotune.py::TestJointKnobSchedule``
  freezes the same (threshold, hierarchical, quantized); ``after_step``
  on a fake clock scores the same windows, and an unsettled step
  restarts the window's clock (the port's capture fence).
* ``sched/store.py``: ``make_key`` documents equal with the version field
  set equal; the fingerprint's resolved entries; ``ScheduleStore``
  record, keep-best, stale and corrupt-file handling with the same
  ``sched.tune.*`` counters.  ``sched/tune.py``: a ``ScheduleTuner`` miss
  that explores and stores, then a hit that converges at window 0, fed
  the same registry windows, with the same scores, suggestions and
  counters.
* ``TrainStep`` under ``HVD_TPU_AUTOTUNE=1``: a tiny MNIST model (a
  784-32-10 MLP, SGD) at a world of one on the CPU and the JAX
  ``distributed_train_step`` on one CPU device, both fed the same
  synthetic window times (the drivers' clocks stood in, each step's time
  a function of its variant), explore the same variants and freeze the
  same (threshold, hierarchical, quantized), the hierarchical knob
  explorable on both; each variant plans its own buckets.  On a faked
  card (``tests/test_torch_onestep.py``'s stand-in graph) each variant
  keeps its own graph, at most ``MAX_GRAPHS``, every timed step is a
  replay, and the losers' graphs are dropped at convergence.  A
  sparse-gradient model rejects the quantized probe; a fault plan that
  arms ``topo.dcn_phase`` blocks the capture.
"""

import ctypes
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu as hvd
import horovod_tpu_torch as thvd
from horovod_tpu import metrics as jmetrics
from horovod_tpu import native as jnative
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.sched import store as jstore
from horovod_tpu.sched import tune as jtune
from horovod_tpu.topo import model as jmodel
from horovod_tpu.utils import autotune as jautotune
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import native as tnative
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.optim import distributed_optimizer as dopt
from horovod_tpu_torch.sched import store as tstore
from horovod_tpu_torch.sched import tune as ttune
from horovod_tpu_torch.topo import model as tmodel
from horovod_tpu_torch.utils import autotune as tautotune

torch.set_num_threads(2)

_KNOBS = ("HVD_TPU_AUTOTUNE", "HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
          "HVD_TPU_AUTOTUNE_WINDOW", "HVD_TPU_AUTOTUNE_HIER_WINDOWS",
          "HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED", "HVD_TPU_AUTOTUNE_WARMUP_SAMPLES",
          "HVD_TPU_AUTOTUNE_STEPS_PER_SAMPLE", "HVD_TPU_AUTOTUNE_LOG",
          "HVD_TPU_FUSION_THRESHOLD", "HVD_TPU_SCHED_BUCKET_BYTES", "HVD_TPU_SCHED_WIRE",
          "HVD_TPU_HIERARCHICAL_ALLREDUCE", "HVD_TPU_TUNE_DB", "HVD_TPU_TOPO",
          "HVD_TPU_TOPO_FIT", "HVD_TPU_ONESTEP", "HVD_TPU_QUANT_BACKEND")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No knob from outside; the JAX package's native bindings over the
    port's library (built once, behind its lock); both registries saved
    and restored."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    assert tnative.available(), "the native core did not build"
    lib = ctypes.CDLL(tnative.lib_path())
    jnative._configure(lib)
    monkeypatch.setattr(jnative, "_lib", lib)
    saved = []
    for m in (jmetrics, tmetrics):
        lock = getattr(m, "_counter_lock", None) or m._lock
        with lock:
            saved.append((dict(m._counters), dict(m._gauges), dict(m._histograms)))
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
    tfaults.reset()
    jmodel.reset()
    tmodel.reset()


# ------------------------------------------------------------ native core


def _leaves(seed, n=40):
    rng = random.Random(seed)
    sizes = [rng.choice([4, 512, 4096, 1 << 16, 3 << 18, 1 << 22]) * rng.randint(1, 3)
             for _ in range(n)]
    dtypes = [rng.choice(["float32", "float32", "bfloat16", "int32"]) for _ in range(n)]
    return sizes, dtypes


@pytest.mark.parametrize("seed", range(4))
def test_native_plan_and_codecs_match_jax(seed):
    sizes, dtypes = _leaves(seed)
    ids = [{"float32": 0, "bfloat16": 1, "int32": 2}[d] for d in dtypes]
    for thr in (0, 1 << 16, 1 << 20, 64 << 20):
        assert tnative.fusion_plan(sizes, ids, thr) == jnative.fusion_plan(sizes, ids, thr)
    rng = random.Random(seed)
    for _ in range(20):
        dims = [rng.randint(0, 1 << 20) for _ in range(rng.randint(0, 6))]
        name = "g%d|ps=world|%s" % (rng.randint(0, 99), "x" * rng.randint(0, 3))
        args = (rng.randint(0, 7), rng.randint(0, 7), rng.randint(0, 12), rng.randint(-1, 3),
                dims, name)
        blob = tnative.encode_request(*args)
        assert blob == jnative.encode_request(*args)
        assert tnative.decode_request(blob) == jnative.decode_request(blob)
        names = [f"t{i}" for i in range(rng.randint(0, 4))]
        for err in ("", "process 1 submitted (0, 0, (3,), 'x', -1)"):
            rblob = tnative.encode_response(8 if err else args[1], names, err, dims)
            assert rblob == jnative.encode_response(8 if err else args[1], names, err, dims)
            assert tnative.decode_response(rblob) == jnative.decode_response(rblob)


@pytest.mark.parametrize("look_ahead", [3, 0, -1])
@pytest.mark.parametrize("seed", range(4))
def test_bucket_plan_prefers_native_and_matches_jax(seed, look_ahead, monkeypatch):
    sizes, dtypes = _leaves(seed + 10)
    monkeypatch.setattr(jnative, "fusion_plan", lambda *a: None)  # the JAX Python plan
    for thr in (1 << 16, 1 << 21, 64 << 20):
        want = jfusion.bucket_plan(sizes, dtypes, thr, look_ahead=look_ahead)
        assert tfusion.bucket_plan(sizes, dtypes, thr, look_ahead=look_ahead) == want
        native = tnative.fusion_plan(sizes, [dtypes.index(d) for d in dtypes], thr)
        kept = not tfusion._violates_look_ahead(native, dtypes, look_ahead)
        assert kept == (not jfusion._violates_look_ahead(native, dtypes, look_ahead))
        if kept:
            assert native == want
    monkeypatch.setenv("HVD_TPU_FUSION_THRESHOLD", str(1 << 16))
    assert tfusion.bucket_plan(sizes, dtypes) == \
        jfusion.bucket_plan(sizes, dtypes, 1 << 16)


# ------------------------------------------------------------ the tuners


def _score(thr):
    """A unimodal surface over log2 of the threshold, peak near 2^22."""
    x = np.log2(thr)
    return float(100.0 - (x - 22.3) ** 2)


@pytest.mark.parametrize("native", [True, False])
def test_fusion_autotuner_suggests_like_jax(native, monkeypatch):
    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "7")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_WARMUP_SAMPLES", "1")
    j, t = jautotune.FusionAutotuner(), tautotune.FusionAutotuner()
    seen = []
    while not j.converged:
        thr = j.threshold_bytes()
        assert t.threshold_bytes() == thr
        seen.append(thr)
        j.observe(_score(thr))
        t.observe(_score(thr))
    assert t.converged and t.threshold_bytes() == j.threshold_bytes()
    assert len(set(seen)) > 2


SURFACES = {
    "joint": {(False, False): 1.0, (True, False): 0.9, (False, True): 1.2,
              (True, True): 1.5},
    "keeps_hier_off": {(False, False): 1.0, (True, False): 0.8, (False, True): 1.3,
                       (True, True): 1.1},
    "quant_slower": {(False, False): 1.0, (True, False): 0.8, (False, True): 0.7,
                     (True, True): 0.6},
    "hier_wins": {(False, False): 1.0, (True, False): 1.4, (False, True): 1.1,
                  (True, True): 1.2},
}


@pytest.mark.parametrize("opt_in", [True, False])
@pytest.mark.parametrize("surface", list(SURFACES))
def test_driver_freezes_the_same_knobs(surface, opt_in, monkeypatch):
    """``tests/test_autotune.py::TestJointKnobSchedule``'s schedule on
    both drivers, window by window."""
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "2")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_HIER_WINDOWS", "1")
    if opt_in:
        monkeypatch.setenv("HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED", "1")
    drivers = []
    for mod in (jautotune, tautotune):
        d = mod.AutotuneDriver(window_steps=2, quant_eligible=True)
        monkeypatch.setattr(d, "_hier_explorable", lambda: True)
        drivers.append(d)
    j, t = drivers
    surf = SURFACES[surface]
    for _ in range(50):
        if j.converged:
            break
        state = (j.threshold_bytes(), j.hierarchical(), j.quantized())
        assert (t.threshold_bytes(), t.hierarchical(), t.quantized()) == state
        score = surf[(bool(state[1]), bool(state[2]))] * (1 + state[0] / 2 ** 40)
        j._observe_window(score)
        t._observe_window(score)
    assert j.converged and t.converged
    assert (t.threshold_bytes(), t.hierarchical(), t.quantized()) == \
        (j.threshold_bytes(), j.hierarchical(), j.quantized())


def test_reject_quantized_and_static_collapse_match_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "1")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_HIER_WINDOWS", "1")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED", "1")
    out = []
    for mod in (jautotune, tautotune):
        d = mod.AutotuneDriver(window_steps=2, quant_eligible=True)
        monkeypatch.setattr(d, "_hier_explorable", lambda: False)
        d._observe_window(1.0)
        seq = [(d.hierarchical(), d.quantized(), d.converged)]
        d._observe_window(1.0)
        seq.append((d.hierarchical(), d.quantized(), d.converged))
        d.reject_quantized()
        seq.append((d.hierarchical(), d.quantized(), d.converged))
        out.append(seq)
    assert out[1] == out[0]


class _Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_after_step_windows_match_jax_and_restart_after_unsettled(monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "3")
    drivers, clocks = [], []
    for mod in (jautotune, tautotune):
        d = mod.AutotuneDriver(window_steps=4)
        monkeypatch.setattr(d, "_hier_explorable", lambda: False)
        d._time = _Clock()
        drivers.append(d)
    j, t = drivers
    while not j.converged:
        thr = j.threshold_bytes()
        assert t.threshold_bytes() == thr
        for d in drivers:
            d._time.now += 1e-3 * (1 + abs(np.log2(thr) - 21))
        j.after_step(np.float32(0.0))
        t.after_step(torch.zeros(()))
    assert t.converged and t.threshold_bytes() == j.threshold_bytes()
    assert [w["timed_steps"] for w in t.windows] == [3, 3, 3]
    # The port's fence: a window restarts its clock after each unsettled
    # step, so these three slow calls are never timed.
    d = tautotune.AutotuneDriver(window_steps=3)
    d._time = _Clock()
    for settled, dt in ((False, 5.0), (False, 5.0), (False, 5.0), (True, 1.0),
                        (True, 1.0)):
        d._time.now += dt
        d.after_step(torch.zeros(()), settled=settled)
    assert [(w["score"], w["seconds"], w["timed_steps"], w["calls"]) for w in d.windows] \
        == [(1.0, 2.0, 2, (4, 5))]


# ------------------------------------------------------------ store and tuner


def test_key_documents_and_fingerprints(monkeypatch):
    sig = ((0, 1), 4096, ("float32",), False, "off", "flat")
    for kind in ("dense_grad", "moe"):
        for topo in ("1x8(8)", "2x4(4)"):
            jkey = jstore.make_key(sig, topo_spec=topo, jaxver="9.9", knobs="k", kind=kind)
            assert tstore.make_key(sig, topo_spec=topo, version="9.9", knobs="k",
                                   kind=kind) == jkey
    doc = tstore.key_document(sig, topo_spec="1x1()", version="9.9", knobs="k")
    assert doc["jax"] == "9.9" and sorted(doc) == ["jax", "kind", "knobs", "sig", "topo"]
    assert tstore.topology_spec(tmodel.Topology(2, 4, (2, 2))) == \
        jstore.topology_spec(jmodel.Topology(2, 4, (2, 2)))
    assert tstore.framework_version() == torch.__version__
    base = tstore.knob_fingerprint()
    monkeypatch.setenv("HVD_TPU_QUANT_BACKEND", "fused")  # the port's default
    assert tstore.knob_fingerprint() == base
    monkeypatch.setenv("HVD_TPU_ONESTEP", "auto")  # the default mode
    assert tstore.knob_fingerprint() == base
    monkeypatch.setenv("HVD_TPU_TUNE_DB", "/elsewhere")
    assert tstore.knob_fingerprint() == base
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")
    assert tstore.knob_fingerprint() != base
    monkeypatch.delenv("HVD_TPU_SCHED_WIRE")
    monkeypatch.setenv("HVD_TPU_ONESTEP", "off")
    assert tstore.knob_fingerprint() != base


def _same_topology():
    jmodel.set_topology_override(jmodel.Topology(1, 8))
    tmodel.set_topology_override(tmodel.Topology(1, 8))


def test_store_records_merges_and_tolerates_corruption(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_TOPO_FIT", "off")
    _same_topology()
    out = []
    for mod, name in ((jstore, "j.json"), (tstore, "t.json")):
        path = str(tmp_path / name)
        s = mod.ScheduleStore(path)
        a = s.record("k1", bucket_bytes=1 << 20, wire="off", lowering="flat", score=2.0)
        b = s.record("k1", bucket_bytes=1 << 22, wire="bf16", lowering="flat", score=1.0)
        assert b["bucket_bytes"] == a["bucket_bytes"]  # keep-best
        s.record("k2", bucket_bytes=1 << 24, wire="int8", lowering="hier", score=3.0,
                 meta={"backend": "fused"})
        changed = s.merge({"k1": dict(a, score=5.0, bucket_bytes=7), "bad": {"x": 1}})
        again = mod.ScheduleStore(path)
        hit = again.lookup("k1")
        stale = mod.ScheduleStore(path, stale_factor=1.0000001)
        stale._entries["k2"] = dict(stale._entries["k2"], pred_cost_s=1e-9)
        gone = stale.lookup("k2")
        with open(tmp_path / ("bad" + name), "w") as f:
            f.write("{nope")
        corrupt = mod.ScheduleStore(str(tmp_path / ("bad" + name)))
        drop = ("updated", "jax", "topo")
        out.append(({k: {f: v for f, v in e.items() if f not in drop}
                     for k, e in again.entries().items()}, changed,
                    {f: v for f, v in hit.items() if f not in drop}, gone,
                    corrupt.entries(), mod is tstore))
    assert out[1][:-1] == out[0][:-1]
    assert tmetrics.get_counters("sched.tune") == jmetrics.get_counters("sched.tune")


def _window(steps, dt, nbytes):
    for m in (jmetrics, tmetrics):
        m.set_gauge("sched.bytes_per_step", nbytes)
        for _ in range(steps):
            m.inc_counter("train.steps")
            m.observe("train.step_seconds", dt)


def test_schedule_tuner_miss_then_hit_match_jax(tmp_path, monkeypatch):
    sig = ((0, 1, 2), 123456, ("float32",), False, "bf16", "flat")
    monkeypatch.setenv("HVD_TPU_TOPO_FIT", "off")
    _same_topology()
    runs = []
    for phase in ("miss", "hit"):
        tuners = []
        for mod, db in ((jtune, "j.json"), (ttune, "t.json")):
            monkeypatch.setenv("HVD_TPU_TUNE_DB", str(tmp_path / db))
            tuners.append(mod.ScheduleTuner(store_key=sig, warmup_windows=4,
                                            explore_wire=phase == "miss"))
        j, t = tuners
        windows = 0
        while not j.converged:
            assert not t.converged
            assert (t.bucket_bytes(), t.wire(), t.lowering()) == \
                (j.bucket_bytes(), j.wire(), j.lowering())
            j.begin_window()
            t.begin_window()
            _window(5, 1e-3 * (1 + abs(np.log2(j.bucket_bytes()) - 22)) *
                    (0.5 if j.wire() == "int8" else 1.0), 1 << 24)
            assert t.end_window() == j.end_window()
            windows += 1
        assert t.converged
        assert (t.bucket_bytes(), t.wire(), t.lowering()) == \
            (j.bucket_bytes(), j.wire(), j.lowering())
        runs.append(windows)
        assert tmetrics.get_counters("sched.tune") == jmetrics.get_counters("sched.tune")
        assert tmetrics.get_gauge("sched.tune.warm_start") == \
            jmetrics.get_gauge("sched.tune.warm_start")
    assert runs[0] > 0 and runs[1] == 0
    assert tmetrics.get_counter("sched.tune.db_hit") == 1
    assert tmetrics.get_counter("sched.tune.db_miss") == 1
    assert tmetrics.get_counter("sched.tune.db_store") == 1
    assert tmetrics.get_counter("sched.tune_windows") == runs[0]


# ------------------------------------------------------------ TrainStep

D_IN, HIDDEN, CLASSES, BATCH = 784, 32, 10, 8


def _mnist_data(steps):
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 5, (steps, BATCH, D_IN)) / 4).astype(np.float32)
    y = rng.integers(0, CLASSES, (steps, BATCH)).astype(np.int64)
    w1 = (rng.integers(-4, 5, (D_IN, HIDDEN)) / 256).astype(np.float32)
    w2 = (rng.integers(-4, 5, (HIDDEN, CLASSES)) / 64).astype(np.float32)
    return x, y, w1, w2


def _cost(thr, hier, quant):
    """Synthetic seconds per step of a variant."""
    return 1e-3 * (1 + abs(np.log2(thr) - 20) / 4) * (0.7 if hier else 1.0) * \
        (0.8 if quant else 1.0)


def _torch_tuned(steps, monkeypatch, model=None, batches=None, explore=True,
                 after=None):
    thvd.init("cpu")
    try:
        x, y, w1, w2 = _mnist_data(steps)
        if model is None:
            model = torch.nn.Sequential(torch.nn.Linear(D_IN, HIDDEN), torch.nn.ReLU(),
                                        torch.nn.Linear(HIDDEN, CLASSES))
            with torch.no_grad():
                model[0].weight.copy_(torch.from_numpy(w1.T.copy()))
                model[0].bias.zero_()
                model[2].weight.copy_(torch.from_numpy(w2.T.copy()))
                model[2].bias.zero_()
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        step = thvd.TrainStep(model, opt, lambda m, b: F.cross_entropy(m(b[0]), b[1]))
        at = step.autotune
        if explore:
            monkeypatch.setattr(at, "_hier_explorable", lambda: True)
        at._time = _Clock()
        plans = {}
        for i in range(steps):
            variant = (at.threshold_bytes(), at.hierarchical(), at.quantized())
            at._time.now += _cost(*variant)
            b = batches(i) if batches else (torch.from_numpy(x[i]), torch.from_numpy(y[i]))
            step(b)
            plans[variant] = [(len(bk.indices), bk.wire) for bk in opt.schedule.buckets]
            if at.converged:
                break
        if after is not None:
            after(step)
        return step, plans, opt
    finally:
        thvd.shutdown()


def _jax_tuned(steps, monkeypatch):
    hvd.init(devices=jax.devices()[:1])
    try:
        x, y, w1, w2 = _mnist_data(steps)

        def loss_fn(p, batch):
            bx, by = batch
            h = jax.nn.relu(bx @ p["w1"] + p["b1"])
            logits = h @ p["w2"] + p["b2"]
            return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, by))

        step = hvd.distributed_train_step(loss_fn, hvd.DistributedOptimizer(optax.sgd(0.1)))
        at = step._autotune
        monkeypatch.setattr(at, "_hier_explorable", lambda: True)
        at._time = _Clock()
        params = {"w1": jnp.asarray(w1), "b1": jnp.zeros(HIDDEN),
                  "w2": jnp.asarray(w2), "b2": jnp.zeros(CLASSES)}
        opt_state = step.init(params)
        variants = []
        for i in range(steps):
            variant = (at.threshold_bytes(), at.hierarchical(), at.quantized())
            variants.append(variant)
            at._time.now += _cost(*variant)
            params, opt_state, _ = step(params, opt_state,
                                        (jnp.asarray(x[i]), jnp.asarray(y[i])))
            if at.converged:
                break
        return at, variants
    finally:
        hvd.shutdown()


def test_autotuned_step_freezes_the_jax_knobs(monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "3")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_WINDOW", "2")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_HIER_WINDOWS", "1")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED", "1")
    jat, jvariants = _jax_tuned(40, monkeypatch)
    step, plans, _ = _torch_tuned(40, monkeypatch)
    tat = step.autotune
    assert jat.converged and tat.converged
    frozen = (tat.threshold_bytes(), tat.hierarchical(), tat.quantized())
    assert frozen == (jat.threshold_bytes(), jat.hierarchical(), jat.quantized())
    assert [(w["threshold"], w["hierarchical"], w["quantized"]) for w in tat.windows] == \
        [v for v in jvariants[1::2]][:len(tat.windows)]
    assert tmetrics.get_counter("train.steps") == len(jvariants)
    assert tmetrics.get_histogram("train.step_seconds")["count"] == len(jvariants)
    # Each threshold plans its own buckets; the probe's are int8.
    by_thr = {v[0]: p for v, p in plans.items() if not v[2]}
    assert len({tuple(p) for p in by_thr.values()}) > 1
    assert any(w == "int8" for v, p in plans.items() if v[2] for _, w in p)
    assert all(w != "int8" for v, p in plans.items() if not v[2] for _, w in p)


def _fake_card(monkeypatch, graphs):
    """``TrainStep`` as if on a card of an NCCL world: warm-up eager, a
    capture makes a stand-in graph that replays the eager step."""
    cls = dopt.TrainStep

    class Graph:
        def __init__(self, step, static, spec, loss):
            self.run = lambda: loss.copy_(step._step(dopt.tree_unflatten(static, spec)))
            self.replays = self.resets = 0

        def replay(self):
            self.replays += 1
            self.run()

        def reset(self):
            self.resets += 1

    def capture(self, leaves, spec):
        static = [t.clone() for t in leaves]
        loss = torch.zeros(())
        graphs.append(Graph(self, static, spec, loss))
        return dopt._Captured(graphs[-1], static, loss, {}, buckets=self._units() - 1)

    monkeypatch.setattr(cls, "_device", lambda self: torch.device("cuda"))
    monkeypatch.setattr(cls, "blocker", lambda self: None)
    monkeypatch.setattr(cls, "_side_stream_step",
                        lambda self, batch, mode, device: self._eager(batch, mode))
    monkeypatch.setattr(cls, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def test_each_variant_keeps_its_graph_and_the_losers_are_dropped(monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "4")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_WINDOW", "3")
    graphs = []
    _fake_card(monkeypatch, graphs)
    settled, held = [], []
    real_call = dopt.TrainStep.__call__

    def call(self, batch):
        out = real_call(self, batch)
        settled.append(self.last_settled)
        held.append(self.graphs)
        return out

    monkeypatch.setattr(dopt.TrainStep, "__call__", call)
    dropped = {}

    def after(step):
        # The first call after convergence drops every loser's graph.
        before = len(graphs) - sum(g.resets for g in graphs)
        step((torch.zeros(BATCH, D_IN), torch.zeros(BATCH, dtype=torch.int64)))
        dropped.update(before=before, keys=[k[0] for k in step._graphs],
                       resets=sum(g.resets for g in graphs))

    step, plans, _ = _torch_tuned(60, monkeypatch, explore=False, after=after)
    at = step.autotune
    assert at.converged and len(at.windows) == 4
    # A new variant: CAPTURE_WARMUP eager steps and the capture, then
    # replays; a window times replays only.
    for w in at.windows:
        first, last = w["calls"]
        assert all(settled[first - 1:last]), (w, settled)
        assert w["timed_steps"] == 2
    assert not all(settled) and max(held) <= dopt.MAX_GRAPHS
    frozen = (at.threshold_bytes(), None, None)
    assert dropped["before"] > 1 and dropped["keys"] == [frozen]
    assert dropped["resets"] == len(graphs) - 1


def test_a_sparse_model_rejects_the_quantized_probe(monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "1")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_WINDOW", "2")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_HIER_WINDOWS", "1")
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED", "1")

    class Sparse(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Embedding(16, 4, sparse=True)
            self.out = torch.nn.Linear(4, CLASSES)

        def forward(self, ids):
            return self.out(self.emb(ids).mean(1))

    torch.manual_seed(0)
    batches = lambda i: (torch.randint(0, 16, (BATCH, 3)),  # noqa: E731
                         torch.randint(0, CLASSES, (BATCH,)))
    step, plans, opt = _torch_tuned(30, monkeypatch, model=Sparse(), batches=batches,
                                    explore=False)
    at = step.autotune
    assert at.converged and at.quantized() is None and not at._quant_eligible
    # The probe's call ran again without the int8 wire, within one call:
    # the driver's four windowed calls, then the probe's, counted once.
    assert at._calls == 4
    assert tmetrics.get_counter("train.steps") == 5
    assert tmetrics.get_histogram("train.step_seconds")["count"] == 5
    assert any(v[2] for v in plans)
    assert all(w != "int8" for p in plans.values() for _, w in p)


def test_a_fault_plan_on_the_path_blocks_the_capture(monkeypatch):
    assert dopt.capture_blocker("nccl", 1, False, fault_plan=True).startswith("fault_plan")
    thvd.init("cpu")
    try:
        model = torch.nn.Linear(3, 1)
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        step = thvd.TrainStep(model, opt, lambda m, b: m(b).sum())
        monkeypatch.setattr(thvd.runtime.get_runtime(), "backend", "nccl")
        assert step.blocker() is None
        tfaults.set_plan("topo.dcn_phase:slow:rank=1,secs=0")
        assert step.blocker().startswith("fault_plan")
        tfaults.set_plan("worker.commit:crash")
        assert step.blocker() is None
    finally:
        tfaults.reset()
        thvd.shutdown()


def test_import_of_the_new_modules_pulls_in_no_jax():
    import subprocess
    import sys

    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.native, "
            "horovod_tpu_torch.utils.autotune, horovod_tpu_torch.sched.tune, "
            "horovod_tpu_torch.topo.fit, horovod_tpu_torch.faults, horovod_tpu_torch.events, "
            "horovod_tpu_torch.utils.retry\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'horovod_tpu.'))]\n"
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
