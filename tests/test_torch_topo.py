"""The port's topology model and hierarchical collectives against the JAX
package's.

* Pure Python, in this process: ``Topology`` from ``HVD_TPU_TOPO``
  (``_from_spec``: "SxK", "SxK1xK2", JSON, and the malformed ones),
  ``factor_axis``, ``axis_groups``, ``estimate_cost`` (serial and
  pipelined), ``rail_times``, ``lowering_bytes``, ``fused_dispatch_cost``,
  ``rail_occupancy_seconds``, ``cost_coefficients``,
  ``rail_cost_coefficients``, ``choose_lowering`` under every
  ``HVD_TPU_TOPO_LOWER`` and ``sched/plan.py`` ``resolve_lowering``, over
  a grid of shapes, collectives, sizes, axis sizes and lowerings: equal
  to the JAX functions exactly (the same float64 arithmetic; the JAX
  package's measured fit is off, ``HVD_TPU_TOPO_FIT=off``, as the port
  has none).  GPU discovery from each rank's host against
  ``horovod_tpu/backend/gpu_topo.py`` ``discover`` on fake devices with
  ``process_index``, ragged and out-of-order lists included.
* One gloo world of four processes under ``HVD_TPU_TOPO=2x2``: the
  hierarchical allreduce (Sum and Average), reduce-scatter and
  all-gather on the off, bf16, int8 and fp8 wires, against the JAX
  functions in ``shard_map`` on four CPU devices with the same topology.
  On dyadic inputs the dense and bf16 wires are bitwise, and the off
  wire is bitwise with the flat allreduce.  The quantized hop's inputs
  are the domains' sums of grid inputs (``_grid``: every block of a
  rank holds 31.75, so its int8 scale is exactly 1/4 and the sums are
  exact): int8 is bitwise; fp8 is held to 5e-7 of Σ|x| over the ranks
  (the FMA standing divergence's 5e-7 of Σ|q·s|, ROADMAP Queue C, with
  Σ|q·s| within a rounding of Σ|x|).  ``sync_gradients`` over a mesh
  axis and ``hierarchical_all_reduce`` on two mesh axes are bitwise
  with the flat ones.
* In the same world, two SGD steps of ``DistributedOptimizer(
  lowering="hier")`` on a one-weight linear model (dyadic data), on the off, bf16
  and int8 wires, against the JAX ``DistributedOptimizer(
  lowering="hier")``: bitwise on off and bf16, 5e-7 on int8 (the FMA
  divergence; the hier bucket runs without error feedback in both).
* The lifted raises: ``HVD_TPU_TOPO_LOWER=hier`` is a lowering of
  ``sync_gradients``, and ``import horovod_tpu_torch`` still imports no
  JAX.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import types

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
from horovod_tpu.backend import gpu_topo as jgpu
from horovod_tpu.exceptions import HorovodTpuError as JaxHorovodTpuError
from horovod_tpu.exceptions import ProcessSetTilingError as JaxTilingError
from horovod_tpu.ops import traced
from horovod_tpu.runtime import WORLD_AXIS, get_runtime
from horovod_tpu.sched import plan as jplan
from horovod_tpu.topo import hierarchical as jh
from horovod_tpu.topo import model as jmodel
from horovod_tpu_torch.backend import gpu_topo as tgpu
from horovod_tpu_torch.exceptions import HorovodTpuError, ProcessSetTilingError
from horovod_tpu_torch.sched import plan as tplan
from horovod_tpu_torch.topo import model as tmodel

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
BLOCK = 128
WIRES = ("off", "bf16", "int8", "fp8")


@pytest.fixture(autouse=True)
def _static_pricing(monkeypatch):
    """Both models price with the static fields; no override outlives a test."""
    monkeypatch.setenv("HVD_TPU_TOPO_FIT", "off")
    for k in ("HVD_TPU_TOPO", "HVD_TPU_TOPO_LOWER", "HVD_TPU_TOPO_ICI_GBPS",
              "HVD_TPU_TOPO_DCN_GBPS"):
        monkeypatch.delenv(k, raising=False)
    yield
    jmodel.reset()
    tmodel.reset()


def _fields(t):
    return (t.num_slices, t.slice_size, t.ici_shape, t.ici_gbps, t.dcn_gbps,
            t.ici_latency_s, t.dcn_latency_s, t.phase_overhead_s, t.source)


# ------------------------------------------------------------ pure Python

SPECS = ["2x2", "2x4", "4x2", "2x2x2", "1x8", "8x1", "3x2", "2*4", " 2X2 ",
         '{"slices": 2, "ici_shape": [2, 2]}', '{"slices": 4}',
         '{"slices": 2, "slice_size": 4, "dcn_gbps": 40, "ici_lat_us": 3}',
         '{"slices": 2, "phase_overhead_us": 50, "ici_gbps": 7}',
         "2", "x", "2x0", "0x4", "2xa", "{bad json", '{"slices": 3}', "3x3"]


@pytest.mark.parametrize("n", [4, 6, 8, None])
@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_matches_jax(spec, n):
    """The forced shape, or the error and its message."""
    try:
        want = _fields(jmodel._from_spec(spec, n))
    except JaxHorovodTpuError as e:
        with pytest.raises(HorovodTpuError) as got:
            tmodel._from_spec(spec, n)
        assert str(got.value) == str(e)
        return
    assert _fields(tmodel._from_spec(spec, n)) == want


TOPOS = [(1, 8), (2, 2), (2, 4), (4, 2), (3, 2), (8, 1), (2, 8), (3, 4)]


@pytest.mark.parametrize("shape", TOPOS)
def test_factor_axis_and_groups_match_jax(shape):
    jt, tt = jmodel.Topology(*shape), tmodel.Topology(*shape)
    assert (jt.world, jt.multi_slice) == (tt.world, tt.multi_slice)
    for axis in range(1, 2 * jt.world + 1):
        assert tt.factor_axis(axis) == jt.factor_axis(axis), axis
        try:
            want = jt.axis_groups(axis)
        except JaxTilingError as e:
            with pytest.raises(ProcessSetTilingError) as got:
                tt.axis_groups(axis)
            assert str(got.value) == str(e)
            continue
        assert tt.axis_groups(axis) == want


SIZES = [0, 1, 1000, 4096, 1 << 20, 25 * (1 << 20), 3 * (1 << 28)]


@pytest.mark.parametrize("lowering", ["flat", "hier", "hier_adasum"])
@pytest.mark.parametrize("collective", ["all_reduce", "reduce_scatter", "all_gather"])
@pytest.mark.parametrize("shape", TOPOS)
def test_cost_model_matches_jax(shape, collective, lowering):
    """Every pricing entry point, each axis size up to the world's, equal."""
    jt, tt = jmodel.Topology(*shape), tmodel.Topology(*shape)
    for nbytes in SIZES:
        for axis in sorted({1, 2, jt.num_slices, jt.world // 2 or 1, jt.world, None}
                           - {None}) + [None]:
            args = (collective, nbytes, lowering, axis)
            assert tt.estimate_cost(*args) == jt.estimate_cost(*args), args
            assert (tt.estimate_cost(*args, pipelined=True)
                    == jt.estimate_cost(*args, pipelined=True)), args
            assert tt.rail_times(*args) == jt.rail_times(*args), args
            assert tt.lowering_bytes(*args) == jt.lowering_bytes(*args), args
            n = jt.world if axis is None else axis
            assert (tmodel.cost_coefficients(collective, nbytes, lowering, n, tt)
                    == jmodel.cost_coefficients(collective, nbytes, lowering, n, jt))
            assert (tmodel.rail_cost_coefficients(collective, nbytes, lowering, n, tt)
                    == jmodel.rail_cost_coefficients(collective, nbytes, lowering, n, jt))
        sizes = [nbytes, nbytes // 3 + 7, 1]
        assert (tt.fused_dispatch_cost(collective, sizes, lowering)
                == jt.fused_dispatch_cost(collective, sizes, lowering))
    occ = {"ici": 12345, "dcn": 678}
    assert tt.rail_occupancy_seconds(occ) == jt.rail_occupancy_seconds(occ)
    with pytest.raises(ValueError) as got:
        tt.estimate_cost("broadcast", 8)
    with pytest.raises(ValueError) as want:
        jt.estimate_cost("broadcast", 8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["auto", "flat", "off", "hier", "on", "hier_adasum",
                                  "adasum", "bogus"])
def test_lowering_choice_and_resolution_match_jax(monkeypatch, mode):
    """``lower_mode``, ``choose_lowering`` and ``resolve_lowering`` under
    each ``HVD_TPU_TOPO_LOWER``, on forced topologies (the override both
    models take first)."""
    monkeypatch.setenv("HVD_TPU_TOPO_LOWER", mode)
    if mode == "bogus":
        with pytest.raises(JaxHorovodTpuError) as want:
            jmodel.lower_mode()
        with pytest.raises(HorovodTpuError) as got:
            tmodel.lower_mode()
        assert str(got.value) == str(want.value)
        return
    assert tmodel.lower_mode() == jmodel.lower_mode()
    for shape in TOPOS:
        jt, tt = jmodel.Topology(*shape), tmodel.Topology(*shape)
        jmodel.set_topology_override(jt)
        tmodel.set_topology_override(tt)
        for collective in ("all_reduce", "reduce_scatter", "all_gather"):
            for nbytes in SIZES:
                for axis in (None, 2, jt.world):
                    assert (tt.choose_lowering(collective, nbytes, axis)
                            == jt.choose_lowering(collective, nbytes, axis))
        for requested in ("flat", "hier", "hier_adasum", "auto"):
            for nbytes in SIZES:
                for dts in ((), ("float32",), ("int32",), ("float32", "bfloat16")):
                    for axis in (None, 2, jt.world):
                        args = (requested, nbytes, axis, dts)
                        assert (tplan.resolve_lowering(*args)
                                == jplan.resolve_lowering(*args)), (shape, args)


def test_config_lowering_and_rails_match_jax(monkeypatch):
    for raw in ("auto", "off", "on", "hier", "adasum", "hier_adasum", "flat", "FLAT "):
        monkeypatch.setenv("HVD_TPU_TOPO_LOWER", raw)
        assert (tplan.SchedConfig.from_env().lowering
                == jplan.SchedConfig.from_env().lowering), raw
    for bad in ("bogus", "ring"):
        with pytest.raises(ValueError):
            tplan.SchedConfig(lowering=bad)
        with pytest.raises(ValueError):
            jplan.SchedConfig(lowering=bad)
    for tag in ("ici", "NVLink", "nvswitch", "dcn", "ib", "InfiniBand", "roce", "x", None):
        assert tmodel.canon_rail(tag) == jmodel.canon_rail(tag)
    assert tmodel.RAILS == jmodel.RAILS and tmodel.LOWER_CHOICES == jmodel.LOWER_CHOICES
    assert tmodel.rail_labels() == {"ici": "nvlink", "dcn": "ib"}
    assert tmodel.rail_label("dcn") == "ib"


@pytest.mark.parametrize("hosts", [
    [0, 0, 1, 1], [0, 0, 0, 0], [0, 1, 2, 3], [0, 0, 0, 1], [0, 1, 0, 1],
    [0, 0, 1, 1, 2, 2], [1, 1, 0, 0], [0, 0, 1, 1, 1, 1], [3, 3, 3, 5, 5, 5], [0],
    ["a", "a", "b", "b"], ["h1", "h2", "h1", "h2"],
])
@pytest.mark.parametrize("env_knobs", [{}, {"HVD_TPU_TOPO_DCN_GBPS": "50",
                                            "HVD_TPU_TOPO_ICI_LAT_US": "1.5"}])
def test_gpu_discovery_matches_jax(monkeypatch, hosts, env_knobs):
    """One NVLink domain per host; ragged sizes or an order that is not
    host-major collapse to one domain, as the JAX gpu family discovers
    from ``process_index``."""
    for k, v in env_knobs.items():
        monkeypatch.setenv(k, v)
    ids = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    devices = [types.SimpleNamespace(process_index=ids[h]) for h in hosts]
    assert _fields(tgpu.discover(hosts)) == _fields(jgpu.discover(devices))


def test_discover_honours_the_override_first(monkeypatch):
    monkeypatch.setenv("HVD_TPU_TOPO", "2x2")
    assert _fields(tmodel.discover([0, 0, 0, 0])) == _fields(
        jmodel._from_spec("2x2", 4))
    with pytest.raises(HorovodTpuError, match="describes 2x2 devices but 8"):
        tmodel.discover(["h"] * 8)
    monkeypatch.delenv("HVD_TPU_TOPO")
    assert tmodel.discover(["a", "a", "b", "b"]).num_slices == 2
    assert tmodel.current().world == 1  # no runtime: this process alone


# ------------------------------------------------------------ the world of four

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import grad_sync, mesh as tmesh
    from horovod_tpu_torch.topo import hierarchical as th

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60)
    data = dict(np.load(out + "/data.npz"))
    res = {}

    def save(key, t):
        res[key] = t.detach().float().numpy() if t.dtype == torch.bfloat16 else \\
            t.detach().numpy()

    try:
        x = torch.from_numpy(data["xg"][rank].copy())
        d = torch.from_numpy(data["xd"][rank].copy())
        save("flat", hvd.allreduce(x, op=hvd.Sum))
        save("flat_d", hvd.allreduce(d, op=hvd.Sum))
        for w in ("off", "bf16", "int8", "fp8"):
            save(f"ar|{w}", th.hierarchical_all_reduce(x, op=hvd.Sum, wire=w))
            save(f"avg|{w}", th.hierarchical_all_reduce(x, op=hvd.Average, wire=w))
            rs = th.hierarchical_reduce_scatter(x, op=hvd.Sum, wire=w)
            save(f"rs|{w}", rs)
            save(f"ag|{w}", th.hierarchical_all_gather(rs, wire=w))
            save(f"dcn|{w}", th.dcn_all_reduce(x, wire=w))
        for w in ("off", "bf16"):
            save(f"ar_d|{w}", th.hierarchical_all_reduce(d, op=hvd.Sum, wire=w))
        mesh = tmesh.make_mesh(dp=2, tp=2)
        save("axes", th.hierarchical_all_reduce(d, ("dp", "tp"), op=hvd.Sum, mesh=mesh))
        mesh4 = tmesh.make_mesh(dp=4)
        grads = {"a": d.clone(), "b": x[:50].clone()}
        for lo in ("flat", "hier"):
            os.environ["HVD_TPU_TOPO_LOWER"] = lo
            synced = grad_sync.sync_gradients(grads, mesh=mesh4, scheduled=True)
            save(f"sync|{lo}|a", synced["a"])
            save(f"sync|{lo}|b", synced["b"])
        res["sync_lowering"] = np.array(grad_sync.lowering())
        os.environ.pop("HVD_TPU_TOPO_LOWER")
        for wire in ("off", "bf16", "int8"):
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            w_ = torch.nn.Parameter(torch.from_numpy(data["sw"].copy()))
            opt = hvd.DistributedOptimizer(torch.optim.SGD([w_], lr=1.0),
                                           lowering="hier")
            for i in range(2):
                xs = torch.from_numpy(data["sx"][i, 4 * rank:4 * rank + 4])
                ys = torch.from_numpy(data["sy"][i, 4 * rank:4 * rank + 4])
                loss = torch.mean((xs @ w_ - ys) ** 2)
                loss.backward()
                opt.step()
                opt.zero_grad()
            res[f"step|{wire}|lowerings"] = np.array([b.lowering for b in opt.schedule.buckets])
            save(f"step|{wire}|w", w_)
            if opt.residuals is not None:
                save(f"step|{wire}|res_w", opt.residuals[0])
        os.environ.pop("HVD_TPU_SCHED_WIRE")
        np.savez(out + f"/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""")


def _grid(rng, rows, cols):
    """float32 multiples of 1/4 in [-10, 10] with 31.75 (= 127/4) once in
    every ``BLOCK``-block (``tests/test_torch_process_sets.py``)."""
    x = rng.integers(-40, 41, (rows, cols)).astype(np.float32) / 4
    x.reshape(rows, -1, BLOCK)[:, :, 5] = 31.75
    return x


def _data():
    rng = np.random.default_rng(21)
    return {
        "xg": _grid(rng, N, 7 * BLOCK),
        "xd": (rng.integers(-8, 9, (N, 37)) / 8).astype(np.float32),
        "sx": (rng.integers(-2, 3, (2, 16, 6)) / 2).astype(np.float32),
        "sy": (rng.integers(-3, 4, (2, 16, 1)) / 4).astype(np.float32),
        "sw": (rng.integers(-2, 3, (6, 1)) / 8).astype(np.float32),
    }


def _spawn(tmp, source, n, env_extra):
    script = tmp / "worker.py"
    script.write_text(source)
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_SCHED_WIRE", "HVD_TPU_ONESTEP",
              "HVD_TPU_TOPO_LOWER", "HVD_TPU_QUANT_BACKEND"):
        if k not in env_extra:
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


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _traced(fn, *xs):
    spec = P(WORLD_AXIS)
    f = shard_map(lambda *vs: jax.tree.map(lambda a: a[None], fn(*[v[0] for v in vs])),
                  mesh=get_runtime().mesh, in_specs=(spec,) * len(xs), out_specs=spec,
                  check_vma=False)
    return jax.tree.map(_np, jax.jit(f)(*xs))


def _jax_step(data, wire, monkeypatch):
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)
    opt = hvd.DistributedOptimizer(optax.sgd(1.0), lowering="hier")

    def body(w, xs, ys):
        params = {"w": w}
        state = opt.init(params)
        for i in range(2):
            def loss(p):
                return jnp.mean((xs[i] @ p["w"] - ys[i]) ** 2)
            updates, state = opt.update(jax.grad(loss)(params), state, params)
            params = optax.apply_updates(params, updates)
        return params["w"]

    stack = lambda a: jnp.asarray(np.stack([a] * N))  # noqa: E731
    xs = jnp.asarray(data["sx"].reshape(2, N, 4, 6).transpose(1, 0, 2, 3))
    ys = jnp.asarray(data["sy"].reshape(2, N, 4, 1).transpose(1, 0, 2, 3))
    return {"w": _traced(body, stack(data["sw"]), xs, ys)}


def _jax_world(data, monkeypatch):
    want = {}
    monkeypatch.setenv("HVD_TPU_TOPO", "2x2")
    monkeypatch.setenv("HVD_TPU_TOPO_FIT", "off")
    monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", str(BLOCK))
    hvd.init(devices=jax.devices()[:N])
    jmodel.reset()
    topo = jmodel.current()
    assert (topo.num_slices, topo.slice_size) == (2, 2)
    xg, xd = jnp.asarray(data["xg"]), jnp.asarray(data["xd"])

    def body(x, d):
        out = {"flat": traced.allreduce(x, op=traced.Sum)}
        for w in WIRES:
            out[f"ar|{w}"] = jh.hierarchical_all_reduce(x, op=traced.Sum, wire=w)
            out[f"avg|{w}"] = jh.hierarchical_all_reduce(x, op=traced.Average, wire=w)
            rs = jh.hierarchical_reduce_scatter(x, op=traced.Sum, wire=w)
            out[f"rs|{w}"] = rs
            out[f"ag|{w}"] = jh.hierarchical_all_gather(rs, wire=w)
            out[f"dcn|{w}"] = jh.dcn_all_reduce(x, wire=w)
        for w in ("off", "bf16"):
            out[f"ar_d|{w}"] = jh.hierarchical_all_reduce(d, op=traced.Sum, wire=w)
        return out

    want.update(_traced(body, xg, xd))
    for wire in ("off", "bf16", "int8"):
        for k, v in _jax_step(data, wire, monkeypatch).items():
            want[f"step|{wire}|{k}"] = v
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's gloo world of four under ``HVD_TPU_TOPO=2x2``, run once,
    beside the JAX package's results; shared across xdist workers behind
    a lock (``tests/test_torch_process_sets.py``)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_topo_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        tmp = tmp_path_factory.mktemp("topo")
        data = _data()
        np.savez(tmp / "data.npz", **data)
        procs = _spawn(tmp, _WORKER, N, {"HVD_TPU_TOPO": "2x2",
                                         "HVD_TPU_QUANT_BLOCK": str(BLOCK)})
        hvd.shutdown()
        mp = pytest.MonkeyPatch()
        try:
            want = _jax_world(data, mp)
        finally:
            mp.undo()
            hvd.shutdown()
            jmodel.reset()
        ranks = _collect(procs, tmp, N)
        with open(path, "wb") as f:
            pickle.dump((data, ranks, want), f)
    return data, ranks, want


def _bitwise(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)


@pytest.mark.parametrize("what", ["ar", "avg", "rs", "ag", "dcn"])
@pytest.mark.parametrize("wire", WIRES)
def test_hierarchical_collectives_match_jax(world, wire, what):
    """Rank r against row r of the JAX function: bitwise but on fp8,
    which is held to 5e-7 of Σ|x| (module docstring), plus, after the
    cross-domain hop's re-quantizing gather (all but ``rs``), one fp8
    step where a sum's last bit rounds the other way: 2^-3 of the
    element plus 2^-9 of the largest element / 448
    (``tests/test_torch_process_sets.py`` ``_q_bound``)."""
    data, ranks, want = world
    key = f"{what}|{wire}"
    bound = 5e-7 * (np.abs(data["xg"]).sum(0) * 1.125).max()
    for r in range(N):
        got, exp = ranks[r][key], want[key][r]
        if wire == "fp8":
            assert got.shape == exp.shape
            step = 0.0
            if what != "rs":
                a = np.abs(exp)
                step = a * 2.0 ** -3 + a.max() / 448 * 2.0 ** -9
            assert (np.abs(got - exp) <= bound + step).all(), (key, r)
        else:
            _bitwise(got, exp, f"{key} rank {r}")


@pytest.mark.parametrize("wire", ["off", "bf16"])
def test_hierarchical_allreduce_pads_a_ragged_buffer(world, wire):
    _, ranks, want = world
    for r in range(N):
        _bitwise(ranks[r][f"ar_d|{wire}"], want[f"ar_d|{wire}"][r], f"ragged {wire} {r}")


def test_dense_hierarchy_is_bitwise_with_the_flat_allreduce(world):
    _, ranks, want = world
    for r in range(N):
        _bitwise(ranks[r]["ar|off"], ranks[r]["flat"], f"hier {r}")
        _bitwise(ranks[r]["flat"], want["flat"][r], f"flat {r}")
        _bitwise(ranks[r]["ar_d|off"], ranks[r]["flat_d"], f"ragged {r}")
        _bitwise(ranks[r]["axes"], ranks[r]["flat_d"], f"two mesh axes {r}")
        for name in ("a", "b"):
            _bitwise(ranks[r][f"sync|hier|{name}"], ranks[r][f"sync|flat|{name}"],
                     f"sync_gradients {name} {r}")
        assert str(ranks[r]["sync_lowering"]) == "hier"


@pytest.mark.parametrize("wire", ["off", "bf16", "int8"])
def test_the_hier_step_matches_jax(world, wire):
    """Two SGD steps with every bucket ``hier``; every rank the same.  One
    weight, so both packages lay the bucket out alike (ROADMAP Queue C,
    block layout) and int8 quantizes the same blocks; its sums of q·s
    differ by the FMA standing divergence (Queue C), 5e-7 here (the
    gradients' Σ|q·s| is below 1)."""
    _, ranks, want = world
    for r in range(N):
        assert list(ranks[r][f"step|{wire}|lowerings"]) == ["hier"]
        got, exp = ranks[r][f"step|{wire}|w"], want[f"step|{wire}|w"][r]
        if wire == "int8":
            np.testing.assert_allclose(got, exp, rtol=0, atol=5e-7)
        else:
            _bitwise(got, exp, f"step {wire} rank {r}")
        _bitwise(got, ranks[0][f"step|{wire}|w"], f"replicas {wire}")
        if wire == "int8":  # the hier bucket leaves the residuals at zero
            assert not ranks[r]["step|int8|res_w"].any()


# ------------------------------------------------------------ raises lifted


def test_hier_lowerings_are_lowerings_of_sync_gradients(monkeypatch):
    from horovod_tpu_torch.parallel import grad_sync

    for raw, want in (("hier", "hier"), ("on", "hier"), ("adasum", "hier_adasum"),
                      ("auto", "auto"), ("off", "flat")):
        monkeypatch.setenv("HVD_TPU_TOPO_LOWER", raw)
        assert grad_sync.lowering() == want


def test_import_still_pulls_in_no_jax():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.topo, "
            "horovod_tpu_torch.ops.adasum, horovod_tpu_torch.ops.sparse, "
            "horovod_tpu_torch.sync_batch_norm, horovod_tpu_torch.optim.adasum_optimizer\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
            "print(json.dumps(bad))")
    out = subprocess.run([sys.executable, "-c", "import json\n" + code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
