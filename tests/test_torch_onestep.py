"""The port's whole-step capture (``HVD_TPU_ONESTEP``) on the CPU.

* The knob: ``horovod_tpu_torch.xir.interp`` against the JAX package's
  ``horovod_tpu.xir.interp`` on every spelling, a bad spelling, the
  override and the unit counts (the cases of
  ``tests/test_onestep.py::TestKnob``).
* Capturability, from static facts alone and without a card: a gloo
  process group, ``backward_passes_per_step=2`` and a sparse-gradient
  module block the capture; ``on`` raises for them on a card, and on
  the CPU every mode runs eagerly.
* The step under ``HVD_TPU_ONESTEP=on`` on both sides against the JAX
  package's ``distributed_train_step``, which folds the update into its
  exchange there, through the tests of ``tests/test_torch_train_step.py``
  and their tolerances: the narrow ResNet at a world of one on the bf16
  wire, its third step replayed from a stand-in capture (the card and
  the graph faked), and a gloo world of two on the int8 wire with error
  feedback, which runs eagerly on the CPU.  The bits of a real replay
  against the eager step are held on the card
  (``tests/test_torch_cuda.py::test_captured_step_is_bitwise_with_eager``).
* ``TrainStep``'s capture cache, with the card and the graph replaced
  by stand-ins that run the step eagerly: warm-up, one capture, replays;
  a changed knob, batch shape, mode, hyperparameter (a new ``lr``) or
  quantized wire knob drops the captured step; the results equal the
  eager step's.
* The kernels' launch counters under capture: every wrapper registers
  in ``ops.LAUNCH_COUNTED``, a capture winds its counts back and each
  replay adds them again.
* The error-feedback residuals are written back into the same tensors,
  so a replayed graph carries them on.
* The A/B timing windows' labels and knobs (``utils/benchmarks.py``).
"""

import contextlib
import itertools
import os

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.exceptions import HorovodTpuError as JaxHorovodTpuError
from horovod_tpu.xir import interp as jinterp
from horovod_tpu_torch import metrics
from horovod_tpu_torch.exceptions import HorovodTpuError
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.ops import LAUNCH_COUNTED, flash, kernels
from horovod_tpu_torch.ops import quant_kernels as qk
from horovod_tpu_torch.ops import ring_kernels as rk
from horovod_tpu_torch.optim import distributed_optimizer as dopt
from horovod_tpu_torch.utils.benchmarks import (
    build_dp_step,
    select_window,
    timed_window,
    window_labels,
)
from horovod_tpu_torch.xir import interp as tinterp

import test_torch_train_step as ts

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("HVD_TPU_ONESTEP", "HOROVOD_ONESTEP"):
        monkeypatch.delenv(knob, raising=False)
    try:
        yield
    finally:
        tinterp.set_onestep_override(None)
        jinterp.set_onestep_override(None)


# ----------------------------------------------------------- the knob


@pytest.mark.parametrize("raw", [
    None, "off", "0", "false", "no", "none", "", "on", "1", "true", "yes",
    "auto", "AUTO", " On ", "Off"])
@pytest.mark.parametrize("name", ["HVD_TPU_ONESTEP", "HOROVOD_ONESTEP"])
def test_mode_matches_jax(monkeypatch, name, raw):
    if raw is not None:
        monkeypatch.setenv(name, raw)
    assert tinterp.onestep_mode() == jinterp.onestep_mode()
    for n in range(4):
        assert tinterp.onestep_engaged(n) == jinterp.onestep_engaged(n), n


def test_default_is_auto():
    assert tinterp.onestep_mode() == jinterp.onestep_mode() == "auto"


def test_bad_spelling_raises_as_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_ONESTEP", "sideways")
    with pytest.raises(HorovodTpuError, match="ONESTEP") as got:
        tinterp.onestep_mode()
    with pytest.raises(JaxHorovodTpuError) as want:
        jinterp.onestep_mode()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", tinterp.ONESTEP_MODES)
def test_override_wins_as_jax(monkeypatch, mode):
    monkeypatch.setenv("HVD_TPU_ONESTEP", "off" if mode != "off" else "on")
    tinterp.set_onestep_override(mode)
    jinterp.set_onestep_override(mode)
    assert tinterp.onestep_mode() == jinterp.onestep_mode() == mode
    assert [tinterp.onestep_engaged(n) for n in range(4)] == \
        [jinterp.onestep_engaged(n) for n in range(4)]
    with pytest.raises(HorovodTpuError) as got:
        tinterp.set_onestep_override("diagonal")
    with pytest.raises(JaxHorovodTpuError) as want:
        jinterp.set_onestep_override("diagonal")
    assert str(got.value) == str(want.value)
    assert tinterp.onestep_mode() == mode  # a refused override changes nothing


# ------------------------------------------------------ capturability


def test_blocker_from_static_facts():
    assert dopt.capture_blocker("nccl", 1, False) is None
    assert dopt.capture_blocker(None, 1, False) is None  # no runtime: no collective
    assert "gloo" in dopt.capture_blocker("gloo", 1, False)
    assert "backward_passes_per_step is 2" in dopt.capture_blocker("nccl", 2, False)
    assert "sparse" in dopt.capture_blocker("nccl", 1, True)
    assert "capturable=False" in dopt.capture_blocker("nccl", 1, False, False)


def _linear(**kwargs):
    model = torch.nn.Linear(3, 2)
    opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                    **kwargs)
    return model, opt


def _mse(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def _batch(seed=0, rows=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, 3, generator=g), torch.randn(rows, 2, generator=g)


@pytest.mark.parametrize("case", ["gloo", "two passes", "sparse", "adamw"])
def test_on_raises_where_a_card_step_cannot_be_captured(monkeypatch, case):
    """The blocker of real objects: the runtime's gloo group, the
    optimizer's passes, the model's sparse embedding, AdamW's default
    ``capturable=False`` (the GPT step's optimizer).  With the device
    reported as a card, ``on`` raises naming the reason and the roadmap
    item, before the step runs; ``auto`` runs it eagerly.  Outside the
    gloo case the runtime reports NCCL, so each reason is the first."""
    thvd.init("cpu")
    try:
        if case != "gloo":
            monkeypatch.setattr(thvd.runtime.get_runtime(), "backend", "nccl")
        if case == "sparse":
            model = torch.nn.Sequential(torch.nn.Embedding(5, 2, sparse=True))
            opt = thvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1), sparse_as_dense=True)
            loss_fn = lambda m, b: m(b[0]).sum()  # noqa: E731
            batch = (torch.tensor([1, 3]),)
        elif case == "adamw":
            model = torch.nn.Linear(3, 2)
            opt = thvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
            loss_fn, batch = _mse, _batch()
        else:
            model, opt = _linear(backward_passes_per_step=2 if case == "two passes" else 1)
            loss_fn, batch = _mse, _batch()
        step = thvd.TrainStep(model, opt, loss_fn)
        want = {"gloo": "gloo", "two passes": "backward_passes_per_step is 2",
                "sparse": "sparse", "adamw": "capturable=False"}[case]
        assert want in step.blocker()
        monkeypatch.setattr(step, "_device", lambda: torch.device("cuda"))
        monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
        before = [p.detach().clone() for p in model.parameters()]
        with pytest.raises(HorovodTpuError, match="A12a"):
            step(batch)
        assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
        monkeypatch.setenv("HVD_TPU_ONESTEP", "auto")
        assert torch.isfinite(step(batch))
        assert metrics.get_gauge("sched.onestep.engaged", {"mode": "auto"}) == 0.0
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("mode", tinterp.ONESTEP_MODES)
def test_every_mode_runs_eagerly_on_the_cpu(monkeypatch, mode):
    """No graphs on the CPU: the same losses and weights in every mode,
    nothing captured, even under ``on``."""
    monkeypatch.setenv("HVD_TPU_ONESTEP", mode)
    metrics.reset("xir.")
    thvd.init("cpu")
    try:
        torch.manual_seed(0)
        model, opt = _linear()
        step = thvd.TrainStep(model, opt, _mse)
        losses = [float(step(_batch(i))) for i in range(4)]
    finally:
        thvd.shutdown()
    monkeypatch.setenv("HVD_TPU_ONESTEP", "off")
    thvd.init("cpu")
    try:
        torch.manual_seed(0)
        ref_model, ref_opt = _linear()
        ref = thvd.TrainStep(ref_model, ref_opt, _mse)
        assert [float(ref(_batch(i))) for i in range(4)] == losses
        for a, b in zip(model.parameters(), ref_model.parameters()):
            assert torch.equal(a, b)
    finally:
        thvd.shutdown()
    assert metrics.get_counter("xir.onestep.steps") == 0
    assert metrics.get_gauge("sched.onestep.engaged", {"mode": mode}) == 0.0


# ----------------------------------------------- against the JAX package


def test_world1_bf16_wire_step_matches_jax_under_onestep(monkeypatch):
    """``HVD_TPU_ONESTEP=on`` on both sides, with the port's card and
    graph faked (:func:`_faked_everywhere`): two eager warm-up steps, then
    the third replayed from the capture's static inputs (the batch copied
    in, the loss copied out), held to the assertions and tolerances of
    ``test_world1_bf16_wire_step_matches_jax``."""
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    metrics.reset("xir.")
    graphs = _faked_everywhere(monkeypatch)
    assert ts.STEPS == dopt.CAPTURE_WARMUP + 1
    ts.test_world1_bf16_wire_step_matches_jax(monkeypatch)
    assert len(graphs) == 1 and metrics.get_counter("xir.onestep.steps") == 1
    assert graphs[0].replays == 1 and graphs[0].resets == 1  # by shutdown()


def test_world2_int8_wire_matches_jax_under_onestep(monkeypatch, tmp_path):
    """A gloo world of two with ``HVD_TPU_ONESTEP=on`` on both sides runs
    eagerly on the CPU (no graphs there) and holds the weights and each
    rank's residuals as ``test_world2_int8_wire_matches_jax`` holds
    them; its ranks inherit the knob."""
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    ts.test_world2_int8_wire_matches_jax(monkeypatch, tmp_path)


# ---------------------------------------------- the capture cache, faked


class _Graph:
    """Stands in for a CUDA graph: ``replay`` runs the captured step
    eagerly on the static inputs and writes its loss into the static
    loss, as a replay writes the graph's output."""

    def __init__(self, step, static, spec, loss):
        self.run = lambda: loss.copy_(step._step(dopt.tree_unflatten(static, spec)))
        self.resets = self.replays = 0

    def replay(self):
        self.replays += 1
        self.run()

    def reset(self):
        self.resets += 1


def _fake_capture(step, leaves, spec, graphs):
    """A capture that makes a :class:`_Graph` (counted as the real one
    counts)."""
    static = [t.clone() for t in leaves]
    loss = torch.zeros(())
    graphs.append(_Graph(step, static, spec, loss))
    metrics.inc_counter("xir.onestep.steps")
    return dopt._Captured(graphs[-1], static, loss, {})


def _faked(monkeypatch, step):
    """``step`` on the CPU as if on a card of an NCCL world: its warm-up
    runs eagerly, and a capture makes a :class:`_Graph`."""
    graphs = []
    monkeypatch.setattr(step, "_device", lambda: torch.device("cuda"))
    monkeypatch.setattr(thvd.runtime.get_runtime(), "backend", "nccl")
    monkeypatch.setattr(step, "_side_stream_step",
                        lambda batch, mode, device: step._eager(batch, mode))
    monkeypatch.setattr(step, "_capture",
                        lambda leaves, spec: _fake_capture(step, leaves, spec, graphs))
    return graphs


def _faked_everywhere(monkeypatch):
    """:func:`_faked` for every ``TrainStep``, made later by the code
    under test (nothing blocks the capture)."""
    graphs = []
    cls = dopt.TrainStep
    monkeypatch.setattr(cls, "_device", lambda self: torch.device("cuda"))
    monkeypatch.setattr(cls, "blocker", lambda self: None)
    monkeypatch.setattr(cls, "_side_stream_step",
                        lambda self, batch, mode, device: self._eager(batch, mode))
    monkeypatch.setattr(cls, "_capture",
                        lambda self, leaves, spec: _fake_capture(self, leaves, spec, graphs))
    return graphs


def test_the_cache_captures_once_and_drops_on_a_changed_knob(monkeypatch):
    """Warm-up, one capture and replays under ``on``; a new batch shape
    warms up and captures beside the old one, whose graph then replays at
    once; a changed wire and ``off`` each drop every captured graph
    (reset), and the next calls warm up and capture anew.  The faked
    replays compute what the eager step computes, so the losses and
    weights equal an eager run's."""
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    metrics.reset("xir.")
    plan = (["on"] * 5 + ["rows"] * 4 + ["on"] * 2 + ["wire"] * 4 + ["off"] * 2
            + ["on"] * 4)

    def run(fake):
        thvd.init("cpu")
        try:
            torch.manual_seed(0)
            model, opt = _linear()
            step = thvd.TrainStep(model, opt, _mse)
            graphs = _faked(monkeypatch, step) if fake else None
            losses, engaged = [], []
            for i, what in enumerate(plan):
                monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16" if what == "wire" else "off")
                monkeypatch.setenv("HVD_TPU_ONESTEP", "off" if what == "off" or not fake
                                   else "on")
                losses.append(float(step(_batch(i, rows=6 if what == "rows" else 4))))
                engaged.append(metrics.get_gauge("sched.onestep.engaged",
                                                 {"mode": "on"}) == 1.0
                               and bool(step._graphs))
            return losses, [p.detach().clone() for p in model.parameters()], graphs, engaged
        finally:
            thvd.shutdown()

    losses, weights, graphs, engaged = run(fake=True)
    ref_losses, ref_weights, _, _ = run(fake=False)
    assert losses == ref_losses
    assert all(torch.equal(a, b) for a, b in zip(weights, ref_weights))
    # Each new signature or knob: two eager warm-up steps, then the
    # capture; the first shape's graph outlives the second's capture.
    assert engaged == [False, False, True, True, True] + [False, False, True, True] + \
        [True, True] + [False, False, True, True] + [False, False] + \
        [False, False, True, True]
    assert len(graphs) == 4 and metrics.get_counter("xir.onestep.steps") == 4
    assert [g.replays for g in graphs] == [3 + 2, 1 + 1, 1 + 1, 1 + 1]
    assert [g.resets for g in graphs] == [1, 1, 1, 1]  # the last by shutdown()


def _shape_plan(monkeypatch, plan, changes=None):
    """A faked step fed batches of ``plan``'s row counts under ``on``;
    ``changes[i]`` runs before call i.  The graphs made, whether each
    call replayed one, the losses, and those of the same run eagerly."""
    metrics.reset("xir.")

    def run(fake):
        monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "off")
        monkeypatch.setenv("HVD_TPU_ONESTEP", "on" if fake else "off")
        thvd.init("cpu")
        try:
            torch.manual_seed(0)
            model, opt = _linear()
            step = thvd.TrainStep(model, opt, _mse)
            graphs = _faked(monkeypatch, step) if fake else None
            losses, engaged = [], []
            for i, rows in enumerate(plan):
                if changes and i in changes:
                    changes[i](opt)
                losses.append(float(step(_batch(i, rows=rows))))
                engaged.append(metrics.get_gauge("sched.onestep.engaged",
                                                 {"mode": "on"}) == 1.0)
            return graphs, engaged, losses
        finally:
            thvd.shutdown()

    graphs, engaged, losses = run(fake=True)
    assert losses == run(fake=False)[2]
    return graphs, engaged


def test_alternating_batch_shapes_capture_once_each(monkeypatch):
    """Epochs of three full batches and a short last one: each shape
    warms up and captures once, then replays at once whenever it comes
    back; two captures in all, none dropped before ``shutdown()``."""
    graphs, engaged = _shape_plan(monkeypatch, [4, 4, 4, 2] * 4)
    assert len(graphs) == 2 and metrics.get_counter("xir.onestep.steps") == 2
    assert engaged == [False, False, True, False] + [True, True, True, False] + \
        [True, True, True, True] * 2
    assert [g.replays for g in graphs] == [10, 2]
    assert [g.resets for g in graphs] == [1, 1]  # by shutdown()


@pytest.mark.parametrize("change", ["lr", "wire"])
def test_a_changed_learning_rate_or_knob_drops_every_graph(monkeypatch, change):
    """With two shapes captured, a new ``lr`` or ``HVD_TPU_SCHED_WIRE``
    drops both graphs; each shape then warms up and captures anew."""
    def new_lr(opt):
        opt.param_groups[0]["lr"] = 0.05

    def new_wire(opt):
        monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")

    plan = [4, 4, 4, 2, 2, 2, 4, 2] + [4, 4, 4, 2, 2, 2, 4, 2]
    graphs, engaged = _shape_plan(monkeypatch, plan,
                                  {8: new_lr if change == "lr" else new_wire})
    assert engaged == [False, False, True, False, False, True, True, True] * 2
    assert len(graphs) == 4 and [g.replays for g in graphs] == [2, 2, 2, 2]
    assert [g.resets for g in graphs] == [1, 1, 1, 1]


def test_the_bound_evicts_the_least_recently_replayed_graph(monkeypatch):
    """``MAX_GRAPHS`` shapes each capture; the first replays again, so
    the next new shape's capture drops the second's graph (the least
    recently replayed), which warms up and captures anew when it comes
    back."""
    n = dopt.MAX_GRAPHS
    shapes = list(range(1, n + 2))  # rows of n + 1 shapes
    plan = [r for r in shapes[:n] for _ in range(dopt.CAPTURE_WARMUP + 1)]
    plan += [shapes[0]] + [shapes[n]] * (dopt.CAPTURE_WARMUP + 1) + \
        [shapes[1]] * (dopt.CAPTURE_WARMUP + 1)
    graphs, engaged = _shape_plan(monkeypatch, plan)
    warm_then_capture = [False] * dopt.CAPTURE_WARMUP + [True]
    assert engaged == warm_then_capture * n + [True] + warm_then_capture * 2
    assert len(graphs) == n + 2
    # Evicted: the second shape's graph by the (n+1)-th shape's capture,
    # then the third's by the second's capture anew; the rest by shutdown.
    assert [g.resets for g in graphs] == [1] * (n + 2)
    assert [g.replays for g in graphs] == [2] + [1] * (n + 1)


def test_a_changed_hyperparameter_or_quant_knob_drops_the_captured_step(monkeypatch):
    """A captured step holds the optimizer's hyperparameters and the
    quantized wire's knobs as they were at its capture; the eager step
    reads them anew.  So a new ``lr`` (a schedule's), ``momentum``,
    ``HVD_TPU_QUANT_BLOCK`` or ``HVD_TPU_QUANT_BACKEND`` drops the graph,
    and the next calls warm up and capture anew; a key that changes at
    every step never captures."""
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "off")
    for knob in ("HVD_TPU_QUANT_BLOCK", "HVD_TPU_QUANT_BACKEND"):
        monkeypatch.delenv(knob, raising=False)
    metrics.reset("xir.")
    changes = {4: ("lr", 0.05), 8: ("momentum", 0.5), 12: ("block", "256"),
               16: ("backend", "phase")}
    thvd.init("cpu")
    try:
        model = torch.nn.Linear(3, 2)
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        step = thvd.TrainStep(model, opt, _mse)
        graphs = _faked(monkeypatch, step)
        captured = []
        for i in range(20 + 4):
            what, value = changes.get(i, (None, None))
            if what in ("lr", "momentum"):
                opt.param_groups[0][what] = value
            elif what == "block":
                monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", value)
            elif what == "backend":
                monkeypatch.setenv("HVD_TPU_QUANT_BACKEND", value)
            if i >= 20:  # a new lr at every step
                opt.param_groups[0]["lr"] = 0.01 * i
            step(_batch(i))
            captured.append(bool(step._graphs))
        assert captured == [False, False, True, True] * 5 + [False] * 4
        assert len(graphs) == 5 and [g.resets for g in graphs] == [1] * 5
        assert metrics.get_counter("xir.onestep.steps") == 5
    finally:
        thvd.shutdown()


def test_host_state_keys_a_tensor_by_storage_and_a_host_one_by_value():
    """A hyperparameter tensor on the card is read by the replay where it
    lies, so only a new tensor changes the key; one on the host is read
    at capture, so its value is part of the key."""
    lr = torch.tensor(0.1)
    opt = torch.optim.SGD(torch.nn.Linear(3, 2).parameters(), lr=lr)
    key = dopt.host_state(opt)
    assert dopt.host_state(opt) == key
    lr.fill_(0.2)
    assert dopt.host_state(opt) != key
    key = dopt.host_state(opt)
    opt.param_groups[0]["lr"] = torch.tensor(0.2)
    assert dopt.host_state(opt) != key
    opt.param_groups[0]["lr"] = [1, [2.0]]  # containers, item by item
    assert hash(dopt.host_state(opt))


def test_every_kernel_wrapper_registers_its_launch_counter():
    """``TrainStep`` corrects the counts of the wrappers in
    ``ops.LAUNCH_COUNTED`` only, so every wrapper with a launch counter
    is there, each once."""
    with_counter = {obj for mod in (kernels, qk, rk, flash) for obj in vars(mod).values()
                    if callable(obj) and hasattr(obj, "launches")}
    assert {kernels.scale_cast, qk.quant_packed, qk.dequant_accum, qk.dequant_rows,
            rk.rs_ring, rk.ag_ring, flash.flash_forward, flash.flash_forward_wgmma,
            flash.flash_forward_mma} == with_counter
    assert set(LAUNCH_COUNTED) == with_counter
    assert len(LAUNCH_COUNTED) == len(with_counter)


def test_a_capture_winds_its_launches_back_and_each_replay_adds_them(monkeypatch):
    """The real ``_capture`` with the CUDA graph replaced by a stand-in
    that records nothing: a loss function that stands for one launch of
    every wrapper at each step.  Two eager warm-up steps count theirs;
    the capture's are wound back and added again on each replay, so five
    steps count five launches of every wrapper."""

    class Graph:
        def replay(self):
            pass

        def reset(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")

    def loss_fn(m, batch):
        for fn in LAUNCH_COUNTED:
            fn.launches += 1
        return _mse(m, batch)

    thvd.init("cpu")
    before = {fn: fn.launches for fn in LAUNCH_COUNTED}
    try:
        model = torch.nn.Linear(3, 2)
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        step = thvd.TrainStep(model, opt, loss_fn)
        monkeypatch.setattr(step, "_device", lambda: torch.device("cuda"))
        monkeypatch.setattr(thvd.runtime.get_runtime(), "backend", "nccl")
        monkeypatch.setattr(step, "_side_stream_step",
                            lambda batch, mode, device: step._eager(batch, mode))
        counts = []
        for i in range(5):
            step(_batch(i))
            counts.append({fn.launches - before[fn] for fn in LAUNCH_COUNTED})
        assert step._graphs
        assert counts == [{1}, {2}, {3}, {4}, {5}]
    finally:
        thvd.shutdown()
        for fn, n in before.items():
            fn.launches = n


def test_each_graph_adds_its_own_launches_on_each_replay(monkeypatch):
    """Two batch shapes whose steps stand for one and for two launches of
    every wrapper, alternating, through the real ``_capture`` with a
    stand-in graph: each replay adds the counts its own capture recorded,
    so the counters read what the eager steps would have launched."""

    class Graph:
        def replay(self):
            pass

        def reset(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")

    def loss_fn(m, batch):
        for fn in LAUNCH_COUNTED:
            fn.launches += 1 if len(batch[0]) == 4 else 2
        return _mse(m, batch)

    thvd.init("cpu")
    before = {fn: fn.launches for fn in LAUNCH_COUNTED}
    try:
        model = torch.nn.Linear(3, 2)
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        step = thvd.TrainStep(model, opt, loss_fn)
        monkeypatch.setattr(step, "_device", lambda: torch.device("cuda"))
        monkeypatch.setattr(thvd.runtime.get_runtime(), "backend", "nccl")
        monkeypatch.setattr(step, "_side_stream_step",
                            lambda batch, mode, device: step._eager(batch, mode))
        plan = [4, 4, 4, 2, 2, 2, 4, 2, 4, 2]
        counts = []
        for i, rows in enumerate(plan):
            step(_batch(i, rows=rows))
            counts.append({fn.launches - before[fn] for fn in LAUNCH_COUNTED})
        assert len(step._graphs) == 2
        want = list(itertools.accumulate(1 if rows == 4 else 2 for rows in plan))
        assert counts == [{c} for c in want]
        assert sorted(sum(c.launches.values()) for c in step._graphs.values()) == \
            [len(LAUNCH_COUNTED), 2 * len(LAUNCH_COUNTED)]
    finally:
        thvd.shutdown()
        for fn, n in before.items():
            fn.launches = n


def test_residuals_are_written_back_in_place(monkeypatch):
    """A replay carries the error-feedback residuals on only if each step
    writes them into the same tensors: their storage never changes, and
    they move."""
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "int8")
    thvd.init("cpu")
    try:
        model = tresnet.ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                               dtype=torch.float32, seed=3, device="cpu")
        step, opt = build_dp_step(thvd, model)
        ptrs = [r.data_ptr() for r in opt.residuals]
        sums = []
        for x, y in ts._batches():
            step((torch.from_numpy(x), torch.from_numpy(y).long()))
            assert [r.data_ptr() for r in opt.residuals] == ptrs
            sums.append(sum(float(r.abs().sum()) for r in opt.residuals))
        assert sums[0] > 0 and len(set(sums)) == len(sums)
    finally:
        thvd.shutdown()


# ------------------------------------------------------ timing windows


def test_window_labels_and_their_knobs(monkeypatch):
    """Captured against eager in A/B/B/A turns; each label's knobs, the
    ``+barriers`` suffix included; the older labels keep theirs, eager."""
    for knob in ("HVD_TPU_SCHED_WIRE", "HVD_TPU_SCHED_BARRIERS", "HVD_TPU_ONESTEP"):
        monkeypatch.setenv(knob, "unset")  # restored after the test
    assert window_labels("int8", onestep_pairs=2) == (
        "int8/captured", "int8/eager", "int8/eager", "int8/captured")
    assert window_labels(None, onestep_pairs=3) == window_labels("bf16", onestep_pairs=4)
    assert window_labels(None, overlap_pairs=1) == (
        "bf16/overlapped", "bf16/after", "bf16/after", "bf16/overlapped")
    assert window_labels("int8") == ("int8", "bf16", "off", "off", "bf16", "int8")
    for label, want in (("int8/captured", ("int8", "0", "on")),
                        ("bf16/eager", ("bf16", "0", "off")),
                        ("bf16/captured+barriers", ("bf16", "1", "on")),
                        ("bf16/overlapped", ("bf16", "1", "off")),
                        ("bf16/after", ("bf16", "0", "off")),
                        ("off", ("off", "1", "off"))):
        select_window(label)
        got = tuple(os.environ[k] for k in ("HVD_TPU_SCHED_WIRE",
                                            "HVD_TPU_SCHED_BARRIERS", "HVD_TPU_ONESTEP"))
        assert got == want, label


@pytest.mark.parametrize("label", ["bf16/captured", "bf16/captured+barriers", "bf16/eager"])
def test_timed_window_leaves_the_warm_up_and_the_capture_out(monkeypatch, label):
    """A captured window runs ``CAPTURE_WARMUP`` + 1 untimed steps (the
    warm-up and the capture), any other window one; ``before`` runs
    between them and the timed steps."""
    for knob in ("HVD_TPU_SCHED_WIRE", "HVD_TPU_SCHED_BARRIERS", "HVD_TPU_ONESTEP"):
        monkeypatch.setenv(knob, "unset")
    calls = []

    def step(batch):
        calls.append(os.environ["HVD_TPU_ONESTEP"])
        return torch.tensor(float(len(calls)))

    seconds, last = timed_window(step, None, label, 4, lambda: calls.append("before"))
    untimed = 1 + (dopt.CAPTURE_WARMUP if "captured" in label else 0)
    mode = "on" if "captured" in label else "off"
    assert calls == [mode] * untimed + ["before"] + [mode] * 4
    assert last == float(len(calls)) and seconds >= 0.0


def test_shutdown_drops_a_captured_step(monkeypatch):
    """``shutdown()`` drops every captured step before it leaves the
    process group (a graph that captured NCCL operations holds its
    communicator); the step then warms up and captures anew."""
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    thvd.init("cpu")
    try:
        model, opt = _linear()
        step = thvd.TrainStep(model, opt, _mse)
        graphs = _faked(monkeypatch, step)
        for i in range(dopt.CAPTURE_WARMUP + 2):
            step(_batch(i))
        assert step._graphs and graphs[0].resets == 0
    finally:
        thvd.shutdown()
    assert not step._graphs and graphs[0].resets == 1
