"""Each bucket's exchange launched from the backward, against the
exchange after it.

With ``HVD_TPU_SCHED_BARRIERS`` on (off by default) the port launches each
bucket from the post-accumulate-grad hooks of its members, in schedule
order, from the second step on; with it off, after the backward.  The
buckets compute the same bits either way, so three steps of a small
model from the same weights on the same data must give bitwise-equal
weights (and error-feedback residuals) on the off, bf16 and int8 wires,
at a world of one and in a gloo world of two.  The cases also cover
``backward_passes_per_step=2`` (launches on the second backward only),
a parameter without a gradient (its bucket, and every later one, goes
at ``step()``), ``groups=`` (pinned buckets), an explicit ``synchronize()`` with
gradient clipping under ``skip_synchronize()``, ``skip_synchronize()``
without it (the launched buckets' results, and their error-feedback
residuals, dropped) and a stray backward dropped by ``zero_grad()``
before each step's own.  Every rank must launch every bucket in
schedule order, and (where all gradients arrive) before ``step()`` is
called.  A second backward before ``step()`` raises in both modes.

``ScheduleLauncher`` is also driven with shuffled synthetic readiness
orders: a bucket goes exactly when its members and every earlier
bucket's are ready.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.sched import execute as texecute
from horovod_tpu_torch.sched import plan as tplan
from horovod_tpu_torch.sched.hooks import ScheduleLauncher

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
KNOBS = ("HVD_TPU_SCHED_WIRE", "HVD_TPU_SCHED_BARRIERS")
# (name, wire, options): each runs overlapped and with the barriers off.
CASES = [
    ("off", "off", {}),
    ("bf16", "bf16", {}),
    ("int8", "int8", {}),
    ("passes2", "bf16", {"backward_passes_per_step": 2}),
    ("nograd", "int8", {"nograd": True}),
    ("groups", "bf16", {"groups": True}),
    ("clip", "int8", {"clip": True}),
    ("drop", "int8", {"drop": True}),
    ("stray", "int8", {"stray": True}),
]


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        # Registered first: without its gradient the observed order is
        # incomplete, the plan takes the reversed registration order and
        # its bucket comes last.
        self.unused = torch.nn.Linear(4, 8)
        self.fc0 = torch.nn.Linear(6, 24)
        self.fc1 = torch.nn.Linear(24, 16)
        self.fc2 = torch.nn.Linear(16, 3)

    def forward(self, x, with_unused):
        y = self.fc2(torch.relu(self.fc1(torch.relu(self.fc0(x)))))
        if with_unused:
            y = y + self.unused(x[:, :4]).sum() * 0.25
        return y


def run_case(name, wire, opts, barriers, rank):
    """Three applied steps of ``Net`` with the given options in the
    initialized world; returns the weights, residuals and, per backward
    pass, the launch log read before ``step()``."""
    saved = {k: os.environ.get(k) for k in KNOBS}
    os.environ["HVD_TPU_SCHED_WIRE"] = wire
    os.environ["HVD_TPU_SCHED_BARRIERS"] = "1" if barriers else "0"
    try:
        model = Net()
        groups = None
        if opts.get("groups"):
            groups = [[model.fc0.weight, model.fc2.bias],
                      [model.fc1.weight, model.fc1.bias]]
        k = opts.get("backward_passes_per_step", 1)
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.125, momentum=0.5),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=k, fusion_threshold_bytes=700,
            groups=groups,
        )
        rng = np.random.default_rng(10 + rank)

        def loss_of_batch():
            x = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32))
            y = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
            return ((model(x, not opts.get("nograd")) - y) ** 2).mean()

        logs = []
        with texecute.traced() as chains:
            for step in range(STEPS * k):
                if opts.get("stray"):  # a backward whose gradients are dropped
                    loss_of_batch().backward()
                    opt.zero_grad()
                made = len(chains)
                loss_of_batch().backward()
                # The buckets launched before step(): those of a chain
                # the backward opened.
                logs.append(list(chains[-1].log) if len(chains) > made else [])
                if opts.get("clip"):
                    opt.synchronize()
                    torch.nn.utils.clip_grad_norm_(model.parameters(), 0.5)
                    with opt.skip_synchronize():
                        opt.step()
                elif opts.get("drop") and step == 1:
                    with opt.skip_synchronize():  # local gradients applied
                        opt.step()
                else:
                    opt.step()
                if not opt.accumulating:
                    opt.zero_grad()
        out = {f"w_{n}": p.detach().numpy().copy()
               for n, p in model.named_parameters()}
        if opt.residuals is not None:
            for i, r in enumerate(opt.residuals):
                out[f"r_{i}"] = r.numpy().copy()
        return out, logs, len(opt.schedule)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_all(rank):
    """Every case, overlapped and not: arrays keyed ``<case>.<on|off>.*``."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # GEMMs compared bitwise across runs
    try:
        for name, wire, opts in CASES:
            for barriers in (True, False):
                arrays, logs, nb = run_case(name, wire, opts, barriers, rank)
                tag = f"{name}.{'on' if barriers else 'off'}"
                for key, a in arrays.items():
                    out[f"{tag}.{key}"] = a
                for step, log in enumerate(logs):
                    out[f"{tag}.log{step}"] = np.array(log, np.int64).reshape(-1, 2)
                out[f"{tag}.buckets"] = np.array(nb)
    finally:
        torch.set_num_threads(threads)
    return out


_WORKER = textwrap.dedent("""
    import importlib.util, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    rank, store, out, module = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    spec = importlib.util.spec_from_file_location("overlap_cases", module)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=2,
             timeout_s=100)
    try:
        np.savez(f"{out}/rank{rank}.npz", **cases.run_all(rank))
    finally:
        hvd.shutdown()
""")

_RESULTS = {}


def _world(n, tmp_path_factory):
    """Every case's arrays per rank, run once per world and shared."""
    if n in _RESULTS:
        return _RESULTS[n]
    if n == 1:
        thvd.init("cpu")
        try:
            _RESULTS[1] = [run_all(0)]
        finally:
            thvd.shutdown()
        return _RESULTS[1]
    tmp = tmp_path_factory.mktemp("overlap")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE") + KNOBS:
        env.pop(k, None)
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(tmp / "store"),
                 str(tmp), os.path.abspath(__file__)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text
    _RESULTS[n] = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]
    return _RESULTS[n]


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name,wire,opts", CASES, ids=[c[0] for c in CASES])
def test_overlapped_steps_are_bitwise_with_the_exchange_after_backward(
        world, name, wire, opts, tmp_path_factory):
    ranks = _world(world, tmp_path_factory)
    k = opts.get("backward_passes_per_step", 1)
    for got in ranks:
        on = {key[len(name) + 4:]: a for key, a in got.items()
              if key.startswith(f"{name}.on.")}
        off = {key[len(name) + 5:]: a for key, a in got.items()
               if key.startswith(f"{name}.off.")}
        weights = [key for key in on if key.startswith(("w_", "r_"))]
        assert weights and sorted(weights) == sorted(
            key for key in off if key.startswith(("w_", "r_")))
        for key in weights:
            np.testing.assert_array_equal(on[key], off[key], err_msg=key)
        assert (wire == "int8") == any(key.startswith("r_") for key in weights)
        nb = int(on["buckets"])
        assert nb > 1
        for step in range(STEPS * k):
            log_on, log_off = on[f"log{step}"], off[f"log{step}"]
            if (step + 1) % k:  # an accumulating pass launches nothing
                assert log_on.size == 0
                continue
            # Read before step(): with the barriers off nothing has gone.
            assert log_off.size == 0
            if step < k:  # the first step exchanges after its backward
                assert log_on.size == 0
                continue
            positions, from_hook = log_on[:, 0], log_on[:, 1]
            assert list(positions) == list(range(len(positions)))
            if opts.get("nograd"):
                # The unused layer's bucket never completes: it and every
                # later bucket wait for step().
                assert 0 < len(positions) < nb and from_hook.all()
            else:
                assert len(positions) == nb and from_hook.all()
    if world > 1:
        # Under skip_synchronize() alone each rank applies its own
        # gradients: only the launch logs agree across ranks.
        local = ".r_" if not opts.get("drop") else (".r_", ".w_")
        for key, a in ranks[0].items():
            if key.startswith(f"{name}.") and not any(t in key for t in local):
                np.testing.assert_array_equal(a, ranks[1][key], err_msg=key)


def _launch_trace(buckets, ready):
    """Positions launched after each readiness event."""
    got, trace = [], []
    launcher = ScheduleLauncher(buckets, lambda k, hook: got.append((k, hook)))
    for i in ready:
        launcher.ready(i)
        trace.append(len(got))
    launcher.flush()
    return got, trace


@pytest.mark.parametrize("seed", range(6))
def test_launcher_keeps_schedule_order_under_shuffled_readiness(seed):
    rng = np.random.default_rng(seed)
    n = 25
    sizes = [int(s) * 4 for s in rng.integers(1, 2048, n)]
    sched = tplan.build_schedule(
        sizes, ["float32"] * n, tplan.SchedConfig(bucket_bytes=6000),
        order=[int(i) for i in rng.permutation(n)],
    )
    assert len(sched) > 3
    ready = [int(i) for i in rng.permutation(n)]
    got, trace = _launch_trace(sched.buckets, ready)
    assert [k for k, _ in got] == list(range(len(sched)))
    assert all(hook for _, hook in got)  # every member became ready
    # After each event the launched prefix is the longest one whose
    # buckets are complete.
    seen = set()
    for i, count in zip(ready, trace):
        seen.add(i)
        want = 0
        while want < len(sched) and set(sched.buckets[want].indices) <= seen:
            want += 1
        assert count == want


def test_launcher_flush_launches_the_rest_in_order():
    sched = tplan.build_schedule([400] * 6, ["float32"] * 6,
                                 tplan.SchedConfig(bucket_bytes=800))
    first = sched.buckets[0].indices
    last = sched.buckets[-1].indices
    got, _ = _launch_trace(sched.buckets, list(first) + list(last))
    assert got == [(0, True)] + [(k, False) for k in range(1, len(sched))]


def test_scheduler_off_exchanges_after_the_backward(monkeypatch):
    monkeypatch.setenv("HVD_TPU_SCHED", "off")
    thvd.init("cpu")
    try:
        model = Net()
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            fusion_threshold_bytes=700,
        )
        with texecute.traced() as chains:
            for step in range(2):
                model(torch.ones(2, 6), True).sum().backward()
                assert len(chains) == step  # no chain opened by the backward
                opt.step()
                assert chains[-1].log == [(k, False) for k in range(len(opt.schedule))]
        assert len(opt.schedule) > 1
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("k", [1, 2])
def test_a_second_backward_before_step_raises(k):
    """More backward passes than ``backward_passes_per_step`` before
    ``step()`` raise from the hooks, overlapped and not; ``zero_grad()``
    drops what the backward launched, and the steps after it give the
    same bits either way."""
    saved = os.environ.get("HVD_TPU_SCHED_BARRIERS")
    weights = []
    thvd.init("cpu")
    try:
        for barriers in ("1", "0"):
            os.environ["HVD_TPU_SCHED_BARRIERS"] = barriers
            model = Net()
            opt = thvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.125),
                backward_passes_per_step=k, fusion_threshold_bytes=700,
            )
            x = torch.linspace(-1.0, 1.0, 12).reshape(2, 6)

            def backward(scale):
                (model(x * scale, True) ** 2).mean().backward()

            for s in range(2 * k):  # two applied steps: overlap is on
                backward(1.0 + s)
                opt.step()
                if not opt.accumulating:
                    opt.zero_grad()
            for s in range(k - 1):
                backward(0.5)
                opt.step()
            backward(0.75)
            with pytest.raises(RuntimeError, match="more than backward_passes_per_step"):
                backward(0.25)
            opt.zero_grad()
            for s in range(k):
                backward(1.5 + s)
                opt.step()
            opt.zero_grad()
            weights.append([p.detach().clone() for p in model.parameters()])
    finally:
        thvd.shutdown()
        if saved is None:
            os.environ.pop("HVD_TPU_SCHED_BARRIERS", None)
        else:
            os.environ["HVD_TPU_SCHED_BARRIERS"] = saved
    for a, b in zip(*weights):
        assert torch.equal(a, b)


def test_a_changed_knob_is_planned_at_the_next_step(monkeypatch):
    """The hooks launch from the last step's plan; a wire changed since
    is planned after the next backward, and overlap resumes after."""
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "off")
    monkeypatch.setenv("HVD_TPU_SCHED_BARRIERS", "1")
    thvd.init("cpu")
    try:
        model = Net()
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            fusion_threshold_bytes=700,
        )
        wires, hooked = [], []
        with texecute.traced() as chains:
            for i in range(5):
                if i == 2:
                    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")
                made = len(chains)
                model(torch.ones(2, 6), True).sum().backward()
                hooked.append(len(chains[-1].log) if len(chains) > made else 0)
                opt.step()
                opt.zero_grad()
                wires.append({b.wire for b in opt.schedule.buckets})
        nb = len(opt.schedule)
        assert wires == [{"off"}, {"off"}, {"off"}, {"bf16"}, {"bf16"}]
        assert hooked == [0, nb, nb, 0, nb]
    finally:
        thvd.shutdown()
