"""The port's process sets against the JAX package's.

* Registry, in this process and pure Python: ``tiling_groups``,
  ``ProcessSet`` and ``ProcessSetTable`` of ``horovod_tpu_torch`` (a
  copy, with ``torch.distributed`` groups besides) against
  ``horovod_tpu.process_sets``: the tiles or the
  ``ProcessSetTilingError`` and its fields and message, the ids,
  re-adding the same ranks, the dynamic gate, removing the global or an
  unknown set, out-of-range ranks; and ``init(process_sets=...)`` /
  ``HVD_TPU_PROCESS_SETS`` at a world of one.
* One gloo world of four processes joined through a ``FileStore``,
  with the sets {0,1} (which tiles the world with {2,3}), {1,3} (with
  {0,2}) and {0,1,2} (which does not tile) registered at ``init``, in
  that order on both sides.  Every rank runs every eager op on each set
  and on the global set, on dyadic float32, bf16 and int32 inputs made
  with numpy from a seed; rank r must equal row r of the JAX eager op on
  ``jax.devices()[:4]`` with the same sets registered, bitwise: for
  members, and for non-members where the JAX package states their row
  (their own input for allreduce, grouped allreduce and broadcast;
  zeros for allgather, reducescatter and alltoall on a tiling set, and
  for alltoall on any set).  Pinned, with both values, as standing
  divergences (ROADMAP Queue C): on {0,1,2}, below the JAX package's
  ``HVD_TPU_SET_RING_THRESHOLD``, its non-member rows of allgather and
  reducescatter come out of a masked whole-world sum, where the port's
  non-member, which enters no collective, gets zeros; its non-member row
  of an allreduce with a prescale is the prescaled input, where the
  port's is the input (no kernel launched); its ``allgather_v`` hands
  every rank the members' rows (one single-controller array), where a
  non-member of the port's gets none.
* In the same world, the quantized wire on {0,1} and {1,3} (and the
  explicit ``groups=[[0,1],[2,3]]``): ``quantized_reduce_scatter``,
  ``quantized_all_gather``, ``quantized_allreduce`` and
  ``quantized_allreduce_ef``, int8 and fp8, every rank reducing within
  its tile, against the JAX functions under ``shard_map`` with the same
  sets.  int8 on grid inputs (every block's scale exactly 1/4) is
  bitwise; fp8 is held to 5e-7 of Σ|q·s| (``tests/test_torch_quant.py``'s
  tolerance for the FMA divergence).  The Average is by the tile's
  size, so a division by the world's size fails.  {0,1,2} raises
  ``ProcessSetTilingError`` in both packages.
* The step on a set: a linear model on dyadic data, SGD at lr 1, two
  steps of ``DistributedOptimizer(process_set={0,1})`` on the bf16 wire
  and on int8 with error feedback, against the JAX
  ``DistributedOptimizer(process_set=...)`` on the same weights and
  data, to the tolerances of ``tests/test_torch_train_step.py``: bf16
  bitwise (members equal, non-members keep their own gradient), int8
  to 5e-7 (each tile reduces: ranks 2 and 3 equal); a set that does not
  tile raises ``ProcessSetTilingError`` (a ``QuantizedWireError``) in
  both packages on the int8 wire of ``HVD_TPU_SCHED_WIRE``, and
  ``QuantizedWireError`` under ``Compression.int8``.
* Capture logic (the card and the graph faked, as in
  ``tests/test_torch_onestep.py``): ``TrainStep``'s key holds the set's
  id and ranks, ``remove_process_set`` drops the steps that hold the
  set, and the set added again is captured anew under its new id.
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
from horovod_tpu import process_sets as jps
from horovod_tpu.exceptions import HorovodTpuError as JaxHorovodTpuError
from horovod_tpu.exceptions import ProcessSetTilingError as JaxTilingError
from horovod_tpu.exceptions import QuantizedWireError as JaxQuantizedWireError
from horovod_tpu.interop import _grads
from horovod_tpu.ops import eager as je
from horovod_tpu.ops import quantized as jq
from horovod_tpu.ops import traced
from horovod_tpu.runtime import WORLD_AXIS, get_runtime
import horovod_tpu_torch as thvd
from horovod_tpu_torch import process_sets as tps
from horovod_tpu_torch.exceptions import HorovodTpuError, ProcessSetTilingError

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
SETS = {"s01": [0, 1], "s13": [1, 3], "s012": [0, 1, 2]}
TILING = ("s01", "s13")
DTYPES = ("float32", "bfloat16", "int32")
OPS = {"avg": 0, "sum": 1, "min": 3, "max": 4, "prod": 5}
BLOCK = 128


# ------------------------------------------------------------ registry


@pytest.mark.parametrize("ranks,world", [
    ([0, 1], 4), ([1, 3], 4), ([2], 4), ([0, 1, 2], 4), ([0, 1, 2, 3], 4),
    ([3, 0], 6), ([0, 2, 4], 6), ([0, 1, 2, 3], 6), ([], 4), ([1, 1], 4),
    ([-1, 0], 4), ([3, 4], 4), ([5], 8), ([0, 7], 8),
])
def test_tiling_groups_match_jax(ranks, world):
    """The tiles, or the error with its fields and message."""
    try:
        want = jps.tiling_groups(ranks, world, context="ctx")
    except JaxTilingError as e:
        with pytest.raises(ProcessSetTilingError) as got:
            tps.tiling_groups(ranks, world, context="ctx")
        assert (got.value.ranks, got.value.world_size, got.value.context) == (
            e.ranks, e.world_size, e.context)
        assert str(got.value) == str(e)
        assert isinstance(got.value, thvd.exceptions.QuantizedWireError)
        return
    assert tps.tiling_groups(ranks, world, context="ctx") == want


def _table_story(mod, table, ps_cls, errors, env_on):
    """One sequence of registry calls; what each returned or raised."""
    out = []

    def call(fn):
        try:
            r = fn()
        except errors as e:
            return ("raise", type(e).__name__)
        if isinstance(r, ps_cls):
            return ("set", r.process_set_id, r.ranks)
        return ("value", r)

    a = ps_cls([3, 1])
    out.append(call(lambda: table.add(a)))               # gated
    env_on()
    out.append(call(lambda: table.add(a)))
    out.append(call(lambda: (a.process_set_id, a.ranks, a.size())))
    out.append(call(lambda: table.add(ps_cls([1, 3]))))  # the same ranks
    out.append(call(lambda: table.add(ps_cls([0, 1, 2, 3]))))  # the global set's
    out.append(call(lambda: table.add(ps_cls([0, 9]))))  # out of range
    out.append(call(lambda: table.add(ps_cls([2]))))
    out.append(call(table.ids))
    out.append(call(lambda: table.remove(table.global_set)))
    out.append(call(lambda: table.remove(ps_cls([0, 2]))))  # never registered
    out.append(call(lambda: table.remove(a)))
    out.append(call(lambda: table.remove(a)))  # twice
    out.append(call(table.ids))
    out.append(call(lambda: table.add(a)))  # a new id
    out.append(call(lambda: table.get(a.process_set_id).ranks))
    out.append(call(lambda: table.partition_groups(a)))
    out.append(call(lambda: table.partition_groups(ps_cls([0, 1, 2]))))
    out.append(call(lambda: table.partition_groups(table.global_set)))
    out.append(call(lambda: (ps_cls([1, 2]) == ps_cls([2, 1]), repr(ps_cls([2, 1])))))
    out.append(call(lambda: ps_cls([1, 1])))
    return out


def test_process_set_table_matches_jax(monkeypatch):
    """Ids in registration order, re-adding, the dynamic gate, removing
    the global or an unknown set, out-of-range ranks, tiles: the same
    story on both tables."""
    monkeypatch.delenv("HVD_TPU_DYNAMIC_PROCESS_SETS", raising=False)
    monkeypatch.delenv("HOROVOD_DYNAMIC_PROCESS_SETS", raising=False)
    on = lambda: monkeypatch.setenv("HVD_TPU_DYNAMIC_PROCESS_SETS", "1")  # noqa: E731
    want = _table_story(jps, jps.ProcessSetTable(4), jps.ProcessSet,
                        (JaxHorovodTpuError, ValueError), on)
    monkeypatch.delenv("HVD_TPU_DYNAMIC_PROCESS_SETS")
    got = _table_story(tps, tps.ProcessSetTable(4), tps.ProcessSet,
                       (HorovodTpuError, ValueError), on)
    assert got == want
    assert ("raise", "HorovodTpuError") in got  # the gate and the removals did raise


@pytest.mark.parametrize("how", ["init", "env", "dynamic"])
def test_registration_at_world_one_matches_jax(monkeypatch, how):
    """``init(process_sets=...)``, ``HVD_TPU_PROCESS_SETS`` and
    ``init(process_sets="dynamic")`` at a world of one: the ids, the
    global set, and the errors of the API functions.  ``"dynamic"`` sets
    ``HVD_TPU_DYNAMIC_PROCESS_SETS`` in both packages; the variable is
    set through ``monkeypatch`` first, so it is restored afterwards."""
    monkeypatch.setenv("HVD_TPU_DYNAMIC_PROCESS_SETS", "0")
    if how == "env":
        monkeypatch.setenv("HVD_TPU_PROCESS_SETS", "0")
    sets = {"init": lambda m: [m.ProcessSet([0])], "env": lambda m: None,
            "dynamic": lambda m: "dynamic"}[how]

    def story(m, errors, init):
        out = []
        init(sets(m))
        try:
            out.append(m.get_process_set_ids())
            out.append(m.global_process_set().ranks)
            for fn in (lambda: m.remove_process_set(m.global_process_set()),
                       lambda: m.add_process_set([0]).process_set_id,
                       lambda: m.add_process_set([5])):
                try:
                    out.append(fn())
                except errors as e:
                    out.append(type(e).__name__)
            out.append(os.environ.get("HVD_TPU_DYNAMIC_PROCESS_SETS") == "1")
        finally:
            m.shutdown()
        return out

    hvd.shutdown()
    want = story(hvd, JaxHorovodTpuError,
                 lambda s: hvd.init(process_sets=s, devices=jax.devices()[:1]))
    monkeypatch.setenv("HVD_TPU_DYNAMIC_PROCESS_SETS", "0")
    got = story(thvd, HorovodTpuError, lambda s: thvd.init("cpu", process_sets=s))
    assert got == want
    with pytest.raises(ValueError, match="only 'dynamic'"):
        thvd.init("cpu", process_sets="static")
    assert not thvd.is_initialized()


def test_capability_flags_answer_from_torch():
    assert thvd.gloo_built() == torch.distributed.is_gloo_available()
    assert thvd.nccl_built() == torch.distributed.is_nccl_available()
    assert thvd.cuda_built() == (torch.version.cuda is not None)
    assert not (thvd.mpi_built() or thvd.mpi_enabled() or thvd.ddl_built()
                or thvd.ccl_built() or thvd.xla_built() or thvd.tpu_enabled())
    thvd.init("cpu")
    try:
        assert thvd.is_homogeneous() and thvd.gloo_enabled()
    finally:
        thvd.shutdown()
    assert not thvd.gloo_enabled()


# ------------------------------------------------------------ the world of four

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, runtime
    from horovod_tpu_torch.exceptions import (HorovodTpuError, ProcessSetTilingError,
                                              QuantizedWireError)
    from horovod_tpu_torch.ops import quantized as tq
    from horovod_tpu_torch.optim import distributed_optimizer as dopt

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    SETS = SETS_LITERAL
    registered = [hvd.ProcessSet(r) for r in SETS.values()]
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=300,
             process_sets=registered)
    sets = dict(zip(SETS, registered))
    sets["g"] = hvd.global_process_set()
    data = dict(np.load(out + "/data.npz"))
    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}
    OPS = {"avg": hvd.Average, "sum": hvd.Sum, "min": hvd.Min, "max": hvd.Max,
           "prod": hvd.Product}
    res = {}

    def mine(key, dt=None):
        t = torch.from_numpy(data[key][rank].copy())
        return t.to(DT[dt]) if dt else t

    def save(key, t):
        res[key] = (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()

    def raises(exc, fn):
        try:
            fn()
        except exc as e:
            return np.array([type(e).__name__, str(e)])
        raise SystemExit(f"rank {rank}: expected {exc.__name__}")

    try:
        res["ids"] = np.array([ps.process_set_id for ps in sets.values()])
        for s, ps in sets.items():
            k = len(ps.ranks)
            for dt in DT:
                x = mine("x_" + dt, dt)
                before = x.clone()
                for name, op in OPS.items():
                    save(f"{s}|ar_{name}|{dt}", hvd.allreduce(x, op=op, process_set=ps))
                save(f"{s}|ar_scaled|{dt}", hvd.allreduce(
                    x, op=hvd.Average, prescale_factor=0.5, postscale_factor=3.0,
                    process_set=ps))
                save(f"{s}|allgather|{dt}", hvd.allgather(x, process_set=ps))
                save(f"{s}|broadcast|{dt}", hvd.broadcast(x, 1, process_set=ps))
                save(f"{s}|rs_sum|{dt}", hvd.reducescatter(x, process_set=ps))
                save(f"{s}|rs_avg|{dt}", hvd.reducescatter(x, op=hvd.Average,
                                                            process_set=ps))
                save(f"{s}|a2a|{dt}", hvd.alltoall(x, process_set=ps))
                assert torch.equal(x, before)  # out of place
                y = x.clone()
                assert hvd.allreduce_(y, op=hvd.Max, process_set=ps) is y
                save(f"{s}|ar_inplace|{dt}", y)
                y = x.clone()
                assert hvd.broadcast_(y, 1, process_set=ps) is y
                save(f"{s}|broadcast_inplace|{dt}", y)
            group = [mine("x_float32", "float32"), mine("x_bfloat16", "bfloat16"),
                     mine("x_int32", "int32"), mine("y_float32", "float32")]
            for tag, fuse in (("fused", "0"), ("unfused", "1")):
                os.environ["HVD_TPU_DISABLE_GROUP_FUSION"] = fuse
                for i, o in enumerate(hvd.grouped_allreduce(group, process_set=ps)):
                    save(f"{s}|grouped_{tag}_{i}", o)
            os.environ.pop("HVD_TPU_DISABLE_GROUP_FUSION")
            save(f"{s}|allgather_v", hvd.allgather_v(
                torch.from_numpy(data[f"v_{rank}"]), process_set=ps))
            members = list(ps.ranks)
            if rank in members:
                m = members.index(rank)
                xu = torch.from_numpy(data[f"u_{s}_{m}"])
                splits = data[f"splits_{s}"][m].tolist()
            else:
                xu, splits = torch.zeros(0, 2), [0] * k
            out_u, recv = hvd.alltoall(xu, splits=splits, process_set=ps)
            save(f"{s}|a2a_uneven", out_u)
            save(f"{s}|a2a_uneven_recv", recv)
            # The async forms keep their handles on a set.
            x = mine("x_float32", "float32")
            save(f"{s}|async_ar", hvd.synchronize(hvd.allreduce_async(
                x, op=hvd.Sum, process_set=ps)))
            save(f"{s}|async_allgather", hvd.synchronize(hvd.allgather_async(
                x, process_set=ps)))
            y = x.clone()
            assert hvd.synchronize(hvd.broadcast_async_(y, 1, process_set=ps)) is y
            save(f"{s}|async_broadcast_inplace", y)
            save(f"{s}|async_rs", hvd.synchronize(hvd.reducescatter_async(
                x, op=hvd.Average, process_set=ps)))
            save(f"{s}|async_a2a", hvd.synchronize(hvd.alltoall_async(x, process_set=ps)))
            ys = [t.clone() for t in group]
            h = hvd.grouped_allreduce_async_(ys, process_set=ps)
            assert all(a is b for a, b in zip(hvd.synchronize(h), ys))
            for i, o in enumerate(ys):
                save(f"{s}|async_grouped_{i}", o)
            # Gradients on the set (interop/_grads.py).
            w = mine("w_float32", "float32")
            x = mine("x_float32", "float32").requires_grad_()
            (hvd.allreduce(x, op=hvd.Average, postscale_factor=3.0, process_set=ps)
             * w).sum().backward()
            save(f"{s}|grad_allreduce", x.grad)
            x.grad = None
            ys = hvd.grouped_allreduce([x, 2 * x], op=hvd.Sum, process_set=ps)
            (ys[0] * w + ys[1] * w * w).sum().backward()
            save(f"{s}|grad_grouped", x.grad)
            x.grad = None
            (hvd.allgather(x, process_set=ps) * mine(f"wg{k}_float32")).sum().backward()
            save(f"{s}|grad_allgather", x.grad)
            x.grad = None
            (hvd.broadcast(x, 1, process_set=ps) * w).sum().backward()
            save(f"{s}|grad_broadcast", x.grad)
            x.grad = None
            (hvd.alltoall(x, process_set=ps) * w).sum().backward()
            save(f"{s}|grad_alltoall", x.grad)
            hvd.barrier(process_set=ps)

        # Objects: validated, served to every rank of the world.
        res["obj_bcast"] = np.array(hvd.broadcast_object(
            {"r": rank}, root_rank=1, process_set=sets["s13"])["r"])
        res["obj_gather"] = np.array(hvd.allgather_object(rank, process_set=sets["s01"]))

        # The quantized wire on the tiling sets, every rank in its tile.
        xq = mine("xq")
        r0 = mine("rq")
        for s in TILING:
            ps = sets[s]
            for wire in ("int8", "fp8"):
                key = f"{s}|q|{wire}"
                shard = tq.quantized_reduce_scatter(xq, hvd.Sum, ps, wire=wire,
                                                    block=BLOCK)
                save(key + "|rs_sum", shard)
                save(key + "|rs_avg", tq.quantized_reduce_scatter(
                    xq, hvd.Average, ps, wire=wire, block=BLOCK))
                save(key + "|ag", tq.quantized_all_gather(shard, ps, wire=wire,
                                                          block=BLOCK))
                save(key + "|ar", tq.quantized_allreduce(xq, hvd.Average, ps, wire=wire,
                                                         block=BLOCK))
                out_ef, r_new = tq.quantized_allreduce_ef(xq, r0, hvd.Average, ps,
                                                          wire=wire, block=BLOCK)
                save(key + "|ar_ef", out_ef)
                save(key + "|ar_ef_res", r_new)
            save(f"{s}|q|int8|ar_phase", tq.quantized_allreduce(
                xq, hvd.Average, ps, wire="int8", block=BLOCK, backend="phase"))
        save("groups|q|int8|ar", tq.quantized_allreduce(
            xq, hvd.Average, wire="int8", block=BLOCK, groups=[[0, 1], [2, 3]]))
        try:
            tq.quantized_allreduce(xq, hvd.Average, sets["s012"], block=BLOCK)
            raise SystemExit(f"rank {rank}: a set that does not tile was served")
        except ProcessSetTilingError as e:
            res["q_err_s012"] = np.array([type(e).__name__, str(e)])
            res["q_err_fields"] = np.array(list(e.ranks) + [e.world_size])

        # The step on a set: SGD at lr 1, two steps on each wire.
        def train(wire, ps, compression=hvd.Compression.none):
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            wt = torch.nn.Parameter(torch.from_numpy(data["sw"].copy()))
            bt = torch.nn.Parameter(torch.from_numpy(data["sb"].copy()))
            opt = hvd.DistributedOptimizer(torch.optim.SGD([wt, bt], lr=1.0),
                                           process_set=ps, compression=compression)
            rows = slice(4 * rank, 4 * rank + 4)
            for x, y in zip(data["sx"], data["sy"]):
                x, y = torch.from_numpy(x[rows]), torch.from_numpy(y[rows])
                opt.zero_grad()
                ((x @ wt + bt - y) ** 2).mean().backward()
                opt.step()
            out = {"w": wt.detach().numpy().copy(), "b": bt.detach().numpy().copy()}
            if opt.residuals is not None:
                out.update(res_w=opt.residuals[0].numpy().copy(),
                           res_b=opt.residuals[1].numpy().copy())
            return out

        for wire in ("bf16", "int8"):
            for k, v in train(wire, sets["s01"]).items():
                res[f"step|{wire}|{k}"] = v
        res["step_err_s012"] = raises(QuantizedWireError,
                                      lambda: train("int8", sets["s012"]))
        res["step_err_s012_c"] = raises(QuantizedWireError, lambda: train(
            "off", sets["s012"], hvd.Compression.int8))
        os.environ["HVD_TPU_SCHED_WIRE"] = "off"

        # Consistency check on a set: a matching call runs; rank 0 on
        # another set than the others raises on every rank.
        os.environ["HVD_TPU_CONSISTENCY_CHECK"] = "1"
        save("checked", hvd.allreduce(torch.ones(3), op=hvd.Sum, name="ok",
                                      process_set=sets["s01"]))
        res["err_check_set"] = raises(HorovodTpuError, lambda: hvd.allreduce(
            torch.ones(3), name="t", process_set=sets["s13" if rank == 0 else "s01"]))
        os.environ.pop("HVD_TPU_CONSISTENCY_CHECK")

        # Registration errors and the dynamic gate, on every rank alike.
        res["err_unregistered"] = raises(HorovodTpuError, lambda: hvd.allreduce(
            torch.ones(2), process_set=hvd.ProcessSet([0, 2])))
        res["err_gate"] = raises(HorovodTpuError, lambda: hvd.add_process_set([2, 3]))
        os.environ["HVD_TPU_DYNAMIC_PROCESS_SETS"] = "1"
        p23 = hvd.add_process_set([2, 3])
        save("dyn_ar", hvd.allreduce(torch.full((2,), float(rank)), op=hvd.Sum,
                                     process_set=p23))
        ids = [hvd.get_process_set_ids()]
        hvd.remove_process_set(p23)
        ids.append(hvd.get_process_set_ids())
        res["dyn_ids"] = np.array([len(i) for i in ids] + ids[0] + ids[1] + [-1])
        res["err_removed"] = raises(HorovodTpuError, lambda: hvd.allreduce(
            torch.ones(2), process_set=p23))
        res["err_remove_global"] = raises(HorovodTpuError,
                                          lambda: hvd.remove_process_set(sets["g"]))

        # Capture logic, the card and the graph faked: the set is in the
        # key; removing it drops the step's graphs; added again, the set
        # is captured anew under its new id.
        class Graph:
            def __init__(self, fn):
                self.fn, self.replays, self.resets = fn, 0, 0

            def replay(self):
                self.replays += 1
                self.fn()

            def reset(self):
                self.resets += 1

        os.environ["HVD_TPU_ONESTEP"] = "on"
        rt = runtime.get_runtime()
        rt.backend = "nccl"
        model = torch.nn.Linear(6, 1)
        torch.nn.init.zeros_(model.weight)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.5),
                                       process_set=sets["s01"])
        step = hvd.TrainStep(model, opt, lambda m, b: ((m(b[0]) - b[1]) ** 2).mean())
        graphs = []

        def capture(leaves, spec):
            static = [t.clone() for t in leaves]
            loss = torch.zeros(())

            def run():
                loss.copy_(step._step(tuple(static)))
            graphs.append(Graph(run))
            return dopt._Captured(graphs[-1], static, loss, {})

        step._device = lambda: torch.device("cuda")
        step._side_stream_step = lambda batch, mode, device: step._eager(batch, mode)
        step._capture = capture
        batch = (torch.from_numpy(data["sx"][0][4 * rank:4 * rank + 4]),
                 torch.from_numpy(data["sy"][0][4 * rank:4 * rank + 4]))
        keys = []
        for _ in range(4):
            step(batch)
        keys.append(step._key[3])
        ps01 = sets["s01"]
        hvd.remove_process_set(ps01)
        dropped = [len(step._graphs), graphs[0].resets, int(step.holds_set(1))]
        hvd.add_process_set(ps01)
        for _ in range(4):
            step(batch)
        keys.append(step._key[3])
        res["capture"] = np.array([len(graphs), graphs[0].replays, graphs[1].replays]
                                  + dropped + [int(step.holds_set(ps01.process_set_id))])
        res["capture_keys"] = np.array([[k[0]] + list(k[1]) for k in keys])
        rt.backend = "gloo"
        os.environ.pop("HVD_TPU_ONESTEP")
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""").replace("SETS_LITERAL", repr(SETS)).replace("TILING", repr(TILING)).replace(
    "BLOCK", str(BLOCK))


def _grid(rng, rows, cols):
    """float32 multiples of 1/4 in [-10, 10] with 31.75 (= 127/4) once in
    every ``BLOCK``-block: every int8 block scale is exactly 1/4, so every
    q·s and every sum of a few of them is exact."""
    x = rng.integers(-40, 41, (rows, cols)).astype(np.float32) / 4
    x.reshape(rows, -1, BLOCK)[:, :, 5] = 31.75
    return x


def _data():
    rng = np.random.default_rng(12)
    dyadic = lambda *s: (rng.integers(-8, 9, (N,) + s) / 4).astype(np.float32)  # noqa: E731
    # 12 rows: the sizes 2, 3 and 4 divide them.
    d = {"x_float32": dyadic(12, 4), "x_bfloat16": dyadic(12, 4),
         "x_int32": rng.integers(-50, 51, (N, 12, 4)).astype(np.int32),
         "y_float32": dyadic(5), "w_float32": dyadic(12, 4)}
    for k in (2, 3, 4):
        d[f"wg{k}_float32"] = dyadic(12 * k, 4)
    for r in range(N):
        d[f"v_{r}"] = dyadic(r + 1, 3)[0]
    for s, members in list(SETS.items()) + [("g", list(range(N)))]:
        k = len(members)
        splits = rng.integers(0, 4, (k, k))
        d[f"splits_{s}"] = splits
        for m in range(k):
            d[f"u_{s}_{m}"] = dyadic(int(splits[m].sum()), 2)[0]
    # The quantized wire: 4 chunks' worth of grid rows per rank (block 128).
    d["xq"] = _grid(rng, N, 7 * BLOCK)
    d["rq"] = (rng.integers(-2, 3, (N, 7 * BLOCK)) / 8).astype(np.float32)
    # The step: 16 rows of 6 features, rank r's rows 4r..4r+3, two steps.
    d["sx"] = (rng.integers(-2, 3, (2, 16, 6)) / 2).astype(np.float32)
    d["sy"] = (rng.integers(-3, 4, (2, 16, 1)) / 4).astype(np.float32)
    d["sw"] = (rng.integers(-2, 3, (6, 1)) / 8).astype(np.float32)
    d["sb"] = np.array([0.25], np.float32)
    return d


# Every process of the world (the four ranks, and the JAX side in its own
# interpreter) ends in about 30 s unloaded; the bounds below hold under
# the test suite's six loaded workers, and name the process that broke one.
WORLD_TIMEOUT = 600

_JAX_SIDE = textwrap.dedent("""
    import pickle, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import pytest
    sys.path.insert(0, sys.argv[1])
    import test_torch_process_sets as t
    data = dict(np.load(sys.argv[2] + "/data.npz"))
    mp = pytest.MonkeyPatch()
    try:
        want = t._jax_world(data, mp)
    finally:
        mp.undo()
        t.hvd.shutdown()
    with open(sys.argv[2] + "/jax.pkl", "wb") as f:
        pickle.dump(want, f)
""")


def _clean_env(**extra):
    """The environment of a child of the world: this process's, less every
    knob of either package and the launcher's rank variables, which a test
    that ran before in this worker may have left set."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVD_TPU_", "HOROVOD_"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "XLA_FLAGS")}
    env.update(extra, PYTHONPATH=ROOT)
    return env


def _run_world(tmp):
    """The port's four ranks and the JAX package's results, each process
    fresh: the JAX side runs :func:`_jax_world` in its own interpreter (as
    the suite's ``conftest.py`` sets it up: eight CPU devices), so nothing
    an earlier test left in this worker's JAX runtime, registry or
    environment reaches it."""
    data = _data()
    np.savez(tmp / "data.npz", **data)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    (tmp / "jax_side.py").write_text(_JAX_SIDE)
    cmds = [[sys.executable, str(script), str(r), str(N), str(tmp / "store"), str(tmp)]
            for r in range(N)]
    cmds.append([sys.executable, str(tmp / "jax_side.py"), os.path.dirname(__file__),
                 str(tmp)])
    names = [f"rank {r}" for r in range(N)] + ["the JAX side"]
    envs = [_clean_env()] * N + [_clean_env(
        JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8")]
    procs, outs = [], []
    try:
        for cmd, env in zip(cmds, envs):
            procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        for name, p in zip(names, procs):
            try:
                outs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                raise AssertionError(f"{name} did not finish within {WORLD_TIMEOUT} s:\n"
                                     f"{p.communicate()[0]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p, out in zip(names, procs, outs):
        assert p.returncode == 0, f"{name} exited with {p.returncode}:\n{out}"
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    return data, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)], want


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _jax_in(data, key, dt=None):
    x = jnp.asarray(data[key])
    return x.astype(dt) if dt else x


def _traced(fn, *xs):
    spec = P(WORLD_AXIS)
    f = shard_map(lambda *vs: jax.tree.map(lambda a: a[None], fn(*[v[0] for v in vs])),
                  mesh=get_runtime().mesh, in_specs=(spec,) * len(xs), out_specs=spec,
                  check_vma=False)
    return jax.tree.map(_np, jax.jit(f)(*xs))


def _uneven(data, s, members, jset):
    """The JAX uneven alltoall on the set, each member's rows padded to
    the largest count (the padding at the end of its last chunk), the
    padding removed: each rank's output and received counts (a
    non-member's row of the JAX op is zeros)."""
    k = len(members)
    splits = data[f"splits_{s}"]
    rows = max(int(r.sum()) for r in splits)
    x = np.zeros((N, rows, 2), np.float32)
    for m, r in enumerate(members):
        x[r, :splits[m].sum()] = data[f"u_{s}_{m}"]
    padded = splits.copy()
    padded[:, -1] += rows - splits.sum(1)
    out, recv = je.alltoall(jnp.asarray(x), splits=padded, process_set=jset)
    out, recv = _np(out), _np(recv).copy()
    chunk = int(padded.max())
    got, counts = [], []
    for r in range(N):
        if r not in members:
            got.append(None)
            counts.append(recv[r])
            continue
        m = members.index(r)
        got.append(np.concatenate([out[r, j * chunk:j * chunk + splits[j, m]]
                                   for j in range(k)]))
        counts.append(splits[:, m])
    return got, counts


def _jax_step(data, wire, jset, monkeypatch, compression=None):
    """Two steps of the JAX ``DistributedOptimizer(optax.sgd(1.0),
    process_set=jset)`` with each rank's own copy of the weights (they
    differ off the set), in one ``shard_map`` on the world of four."""
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)
    monkeypatch.delenv("HVD_TPU_SCHED_WIRE_EF", raising=False)
    opt = hvd.DistributedOptimizer(optax.sgd(1.0), process_set=jset,
                                   compression=compression or hvd.Compression.none)

    def body(w, b, xs, ys):
        params = {"w": w, "b": b}
        state = opt.init(params)
        for i in range(2):
            def loss(p):
                return jnp.mean((xs[i] @ p["w"] + p["b"] - ys[i]) ** 2)
            grads = jax.grad(loss)(params)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        res = state.residual if state.residual is not None else params
        return params["w"], params["b"], res["w"], res["b"]

    stack = lambda a: jnp.asarray(np.stack([a] * N))  # noqa: E731
    xs = jnp.asarray(data["sx"].reshape(2, N, 4, 6).transpose(1, 0, 2, 3))
    ys = jnp.asarray(data["sy"].reshape(2, N, 4, 1).transpose(1, 0, 2, 3))
    w, b, rw, rb = _traced(body, stack(data["sw"]), stack(data["sb"]), xs, ys)
    return {"w": w, "b": b, "res_w": rw, "res_b": rb}


def _jax_world(data, monkeypatch):
    """The JAX package's results on the same inputs, row r for rank r."""
    want = {}
    jsets = {s: hvd.ProcessSet(r) for s, r in SETS.items()}
    hvd.init(devices=jax.devices()[:N], process_sets=list(jsets.values()))
    jsets["g"] = hvd.global_process_set()
    want["ids"] = np.array([ps.process_set_id for ps in jsets.values()])
    for s, jset in jsets.items():
        members = list(jset.ranks)
        k = len(members)
        # Every op of the JAX eager API is its traced op in a jitted
        # shard_map (``eager.py`` ``_jitted_build``): one program per set
        # here, the same values, a fraction of the compile time.
        xs = [_jax_in(data, "x_float32"), _jax_in(data, "x_bfloat16", jnp.bfloat16),
              _jax_in(data, "x_int32")]
        extra = [_jax_in(data, "y_float32"), _jax_in(data, "w_float32")]

        def body(x32, x16, xi, y, w, jset=jset):
            out = {}
            kw = dict(axis=WORLD_AXIS, process_set=jset)
            for dt, x in zip(DTYPES, (x32, x16, xi)):
                for name, op in OPS.items():
                    try:
                        out[f"ar_{name}|{dt}"] = traced.allreduce(x, op=op, **kw)
                    except OverflowError:  # int32 Min/Max on a set (pinned)
                        pass
                out[f"ar_scaled|{dt}"] = traced.allreduce(
                    x, op=je.Average, prescale_factor=0.5, postscale_factor=3.0, **kw)
                out[f"allgather|{dt}"] = traced.allgather(x, **kw)
                out[f"broadcast|{dt}"] = traced.broadcast(x, 1, **kw)
                out[f"rs_sum|{dt}"] = traced.reducescatter(x, **kw)
                out[f"rs_avg|{dt}"] = traced.reducescatter(x, op=je.Average, **kw)
                out[f"a2a|{dt}"] = traced.alltoall(x, **kw)
            for i, o in enumerate(traced.grouped_allreduce([x32, x16, xi, y], **kw)):
                out[f"grouped_{i}"] = o
            out["grad_allreduce"] = traced.allreduce(w, op=je.Average,
                                                     postscale_factor=3.0, **kw)
            out["grad_grouped"] = (traced.allreduce(w, op=je.Sum, **kw)
                                   + 2 * traced.allreduce(w * w, op=je.Sum, **kw))
            out["grad_alltoall"] = traced.alltoall(w, **kw)
            return out

        got = _traced(body, *xs, *extra)
        for dt in DTYPES:
            for key in PER_DTYPE:
                base = "ar_max" if key == "ar_inplace" else (
                    "broadcast" if key == "broadcast_inplace" else key)
                want[f"{s}|{key}|{dt}"] = got.get(f"{base}|{dt}", OverflowError())
        for i in range(4):
            for tag in ("fused", "unfused"):
                want[f"{s}|grouped_{tag}_{i}"] = got[f"grouped_{i}"]
            want[f"{s}|async_grouped_{i}"] = got[f"grouped_{i}"]
        v = _np(je.allgather_v([jnp.asarray(data[f"v_{r}"]) for r in range(N)],
                               process_set=jset))
        want[f"{s}|allgather_v"] = [v if r in members else None for r in range(N)]
        want[f"{s}|allgather_v_jax_all"] = v
        want[f"{s}|a2a_uneven"], want[f"{s}|a2a_uneven_recv"] = _uneven(
            data, s, members, jset)
        x = _jax_in(data, "x_float32")
        want[f"{s}|async_ar"] = _np(je.allreduce(x, op=je.Sum, process_set=jset))
        want[f"{s}|async_allgather"] = want[f"{s}|allgather|float32"]
        want[f"{s}|async_broadcast_inplace"] = want[f"{s}|broadcast|float32"]
        want[f"{s}|async_rs"] = want[f"{s}|rs_avg|float32"]
        want[f"{s}|async_a2a"] = want[f"{s}|a2a|float32"]
        # The gradient rules of ``interop/_grads.py``: allreduce's and
        # grouped allreduce's are the same allreduce and alltoall's the
        # alltoall (in the program above); allgather's and broadcast's
        # are the JAX package's own functions.
        w = data["w_float32"]
        for key in ("grad_allreduce", "grad_grouped", "grad_alltoall"):
            want[f"{s}|{key}"] = got[key]
        want[f"{s}|grad_allgather"] = _np(_grads.allgather_grad(
            data[f"wg{k}_float32"], process_set=jset))
        want[f"{s}|grad_broadcast"] = _np(_grads.broadcast_grad(w, 1, process_set=jset))
    # The quantized wire under shard_map with the same sets.
    xq, rq = jnp.asarray(data["xq"]), jnp.asarray(data["rq"])
    for s in TILING:
        jset = jsets[s]
        for wire in ("int8", "fp8"):
            key = f"{s}|q|{wire}"
            kw = dict(process_set=jset, wire=wire, block=BLOCK)

            def body(v, r, kw=kw):
                shard = jq.quantized_reduce_scatter(v, WORLD_AXIS, op=je.Sum, **kw)
                avg = jq.quantized_reduce_scatter(v, WORLD_AXIS, op=je.Average, **kw)
                ag = jq.quantized_all_gather(shard, WORLD_AXIS, **kw)
                ar = jq.quantized_allreduce(v, WORLD_AXIS, op=je.Average, **kw)
                ef, res = jq.quantized_allreduce_ef(v, r, WORLD_AXIS, op=je.Average, **kw)
                return shard, avg, ag, ar, ef, res

            outs = _traced(body, xq, rq)
            for name, o in zip(("rs_sum", "rs_avg", "ag", "ar", "ar_ef", "ar_ef_res"), outs):
                want[f"{key}|{name}"] = o
        want[f"{s}|q|int8|ar_phase"] = want[f"{s}|q|int8|ar"]
    want["groups|q|int8|ar"] = _traced(lambda v: jq.quantized_allreduce(
        v, WORLD_AXIS, op=je.Average, wire="int8", block=BLOCK,
        groups=[[0, 1], [2, 3]]), xq)
    want["s01|q|int8|sizes"] = 2
    try:
        _traced(lambda v: jq.quantized_allreduce(v, WORLD_AXIS, op=je.Average,
                                                  process_set=jsets["s012"], block=BLOCK), xq)
    except JaxTilingError as e:
        want["q_err_s012"] = (list(e.ranks), e.world_size, str(e))
    for wire in ("bf16", "int8"):
        for k, v in _jax_step(data, wire, jsets["s01"], monkeypatch).items():
            want[f"step|{wire}|{k}"] = v
    try:
        _jax_step(data, "int8", jsets["s012"], monkeypatch)
    except JaxQuantizedWireError as e:
        want["step_err_s012"] = type(e).__name__
    try:
        _jax_step(data, "off", jsets["s012"], monkeypatch, hvd.Compression.int8)
    except JaxQuantizedWireError as e:
        want["step_err_s012_c"] = type(e).__name__
    # The dynamic story's ids on the JAX runtime.
    monkeypatch.setenv("HVD_TPU_DYNAMIC_PROCESS_SETS", "1")
    p23 = hvd.add_process_set([2, 3])
    ids = [hvd.get_process_set_ids()]
    hvd.remove_process_set(p23)
    ids.append(hvd.get_process_set_ids())
    want["dyn_ids"] = np.array([len(i) for i in ids] + ids[0] + ids[1] + [-1])
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's gloo world of four, run once, beside the JAX package's
    results on ``jax.devices()[:4]`` with the same sets, computed while
    the ranks run (:func:`_run_world`).  Under xdist the first worker to
    need them computes them and the others load them (one file under the
    session's shared temporary root, behind a lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_process_sets_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        data, ranks, want = _run_world(tmp_path_factory.mktemp("sets"))
        with open(path, "wb") as f:
            pickle.dump((data, ranks, want), f)
    return data, ranks, want


def _bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.astype(np.float32).view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _members(s):
    return SETS.get(s, list(range(N)))


ALL_SETS = list(SETS) + ["g"]
PER_DTYPE = ["ar_avg", "ar_sum", "ar_min", "ar_max", "ar_prod", "allgather", "broadcast",
             "rs_sum", "rs_avg", "a2a", "ar_inplace", "broadcast_inplace", "ar_scaled"]
PER_SET = ([f"grouped_{t}_{i}" for t in ("fused", "unfused") for i in range(4)]
           + ["async_ar", "async_allgather", "async_broadcast_inplace", "async_rs",
              "async_a2a"] + [f"async_grouped_{i}" for i in range(4)]
           + ["grad_allreduce", "grad_grouped", "grad_allgather", "grad_broadcast",
              "grad_alltoall"])
# Non-member rows where the port and the JAX package part (module docstring).
DIVERGENT = {("s012", "allgather"), ("s012", "rs_sum"), ("s012", "rs_avg"),
             ("s012", "async_allgather"), ("s012", "async_rs")}


def _rows(s, key, dt=None):
    return [r for r in range(N)
            if r in _members(s) or ((s, key) not in DIVERGENT and key != "ar_scaled")]


def _int_min_max_on_a_set(data, s, key, dt):
    """The JAX package's masked Min/Max builds its identity as
    ``jnp.array(±inf, dtype)`` (``traced.py:377-383``), which raises
    ``OverflowError`` for an integer dtype on any set but the global
    one; the port's members reduce over the set's group (pinned, ROADMAP
    Queue C): numpy's minimum or maximum over the members."""
    x = data["x_" + dt]
    red = np.min if key == "ar_min" else np.max
    return [red(x[_members(s)], axis=0) if r in _members(s) else x[r] for r in range(N)]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("key", PER_DTYPE)
@pytest.mark.parametrize("s", ALL_SETS)
def test_rank_r_is_row_r_of_the_jax_op_bitwise(world, s, key, dt):
    """Members always; non-members where the JAX package states their row."""
    data, ranks, want = world
    exp = want[f"{s}|{key}|{dt}"]
    if isinstance(exp, OverflowError):
        with pytest.raises(OverflowError):  # the JAX package raises there
            jnp.array(np.inf, dtype=jnp.int32)
        assert dt == "int32" and s != "g" and key in ("ar_min", "ar_max", "ar_inplace")
        exp = _int_min_max_on_a_set(data, s, "ar_min" if key == "ar_min" else "ar_max", dt)
    for r in _rows(s, key, dt):
        _bitwise(ranks[r][f"{s}|{key}|{dt}"], exp[r], f"{s} {key} {dt}, rank {r}")


@pytest.mark.parametrize("key", PER_SET)
@pytest.mark.parametrize("s", ALL_SETS)
def test_grouped_async_and_gradients_are_row_r_bitwise(world, s, key):
    _, ranks, want = world
    for r in _rows(s, key):
        _bitwise(ranks[r][f"{s}|{key}"], want[f"{s}|{key}"][r], f"{s} {key}, rank {r}")


@pytest.mark.parametrize("s", ALL_SETS)
def test_allgather_v_and_uneven_alltoall_within_the_set(world, s):
    """Counts exchanged within the set: members get the members' rows
    (allgather_v) and their received chunks and counts (the JAX uneven
    op's, its padding removed); a non-member gets no rows and zero
    counts, where the JAX single-controller ``allgather_v`` hands every
    rank the members' rows (pinned)."""
    _, ranks, want = world
    for r in range(N):
        got_v = ranks[r][f"{s}|allgather_v"]
        got_u, got_recv = ranks[r][f"{s}|a2a_uneven"], ranks[r][f"{s}|a2a_uneven_recv"]
        if r in _members(s):
            _bitwise(got_v, want[f"{s}|allgather_v"][r], f"{s} allgather_v {r}")
            _bitwise(got_u, want[f"{s}|a2a_uneven"][r], f"{s} uneven {r}")
            np.testing.assert_array_equal(got_recv, want[f"{s}|a2a_uneven_recv"][r])
        else:
            assert got_v.shape == (0, 3) and got_u.shape == (0, 2)
            np.testing.assert_array_equal(got_recv, want[f"{s}|a2a_uneven_recv"][r])
            assert not np.any(want[f"{s}|a2a_uneven_recv"][r])
            assert want[f"{s}|allgather_v_jax_all"].shape[0] == sum(
                m + 1 for m in _members(s))


def test_non_member_divergences_are_pinned(world):
    """Standing divergences (ROADMAP Queue C), both values each: on
    {0,1,2}, rank 3's allgather and reducescatter rows come out of the
    JAX package's masked whole-world sum (the members' gather; its own
    first rows, scaled), where the port's are zeros; with a prescale,
    the JAX package's non-member allreduce row is the prescaled input,
    the port's the input."""
    data, ranks, want = world
    for dt in DTYPES:
        x = data["x_" + dt]
        if dt == "bfloat16":
            x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        got = ranks[3]
        np.testing.assert_array_equal(want[f"s012|allgather|{dt}"][3],
                                      want[f"s012|allgather|{dt}"][0])
        assert not np.any(got[f"s012|allgather|{dt}"])
        np.testing.assert_array_equal(want[f"s012|rs_sum|{dt}"][3], x[3][:4])
        assert not np.any(got[f"s012|rs_sum|{dt}"])
        assert not np.any(got[f"s012|rs_avg|{dt}"])
        for s in SETS:
            for r in range(N):
                if r in SETS[s]:
                    continue
                _bitwise(ranks[r][f"{s}|ar_scaled|{dt}"], x[r], f"{s} {dt} port {r}")
                if dt != "int32":
                    _bitwise(want[f"{s}|ar_scaled|{dt}"][r], x[r] * np.float32(0.5),
                             f"{s} {dt} jax {r}")


def _q_bound(data, s, r, what, wire, exp):
    """5e-7 of Σ|q·s| over the rank's tile (each q·s within 1/8 of x);
    after the re-quantizing all-gather (``ag``, ``ar``, ``ar_ef``) one
    quantization step more, where the sums' last bits round the other
    way (ROADMAP Queue C, FMA contraction): the gathered block's maximum
    / 127 for int8, 2^-3 of the element plus 2^-9 of the block maximum /
    448 for fp8 (``tests/test_torch_train_step.py``)."""
    tiles = jps.tiling_groups(SETS[s], N)
    tile = [t for t in tiles if r in t][0]
    x = np.abs(data["xq"][tile])
    if what.startswith("ar_ef"):
        x = x + np.abs(data["rq"][tile])
    bound = 5e-7 * (x.sum(0) * 1.125).max() + 1e-30
    if what in ("ag", "ar", "ar_ef"):
        a = np.abs(exp)
        pad = np.zeros(-(-a.size // BLOCK) * BLOCK, np.float32)
        pad[:a.size] = a
        bmax = np.repeat(pad.reshape(-1, BLOCK).max(1), BLOCK)[:a.size] * 1.01
        step = bmax / 127 if wire == "int8" else a * 2.0 ** -3 + bmax / 448 * 2.0 ** -9
        bound = bound + step
    return bound


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("what", ["rs_sum", "rs_avg", "ag", "ar", "ar_ef", "ar_ef_res"])
@pytest.mark.parametrize("s", TILING)
def test_quantized_wire_on_a_tiling_set_matches_jax(world, s, what, wire):
    """Every rank reduces within its tile; int8 bitwise on grid inputs,
    fp8 to 5e-7 of Σ|q·s|; the ranks of a tile agree bitwise."""
    data, ranks, want = world
    key = f"{s}|q|{wire}|{what}"
    for r in range(N):
        got, exp = ranks[r][key], want[key][r]
        if wire == "int8" and not what.startswith("ar_ef"):
            _bitwise(got, exp, f"{key} rank {r}")
        else:
            err = np.abs(got - exp)
            assert (err <= _q_bound(data, s, r, what, wire, exp)).all(), (key, r, err.max())
    if what in ("ag", "ar", "ar_ef"):
        for tile in jps.tiling_groups(SETS[s], N):
            for r in tile:
                _bitwise(ranks[r][key], ranks[tile[0]][key], f"{key} tile {tile}")


def test_quantized_average_is_by_the_tile_not_the_world(world):
    """The phase lowering and explicit ``groups=`` give the same bits;
    the Average is half the Sum's all-gather (a tile of two), not a
    quarter (a division by the world's size would show here)."""
    data, ranks, want = world
    for r in range(N):
        _bitwise(ranks[r]["s01|q|int8|ar_phase"], want["s01|q|int8|ar"][r], f"phase {r}")
        _bitwise(ranks[r]["groups|q|int8|ar"], want["groups|q|int8|ar"][r], f"groups {r}")
        _bitwise(ranks[r]["groups|q|int8|ar"], ranks[r]["s01|q|int8|ar"], f"same {r}")
        half = ranks[r]["s01|q|int8|ag"][:data["xq"].shape[1]] * np.float32(0.5)
        _bitwise(ranks[r]["s01|q|int8|ar"], half, f"average {r}")
        # The reduce-scatter's sums are exact on the grid: the tile's.
        tile = [0, 1] if r < 2 else [2, 3]
        c = ranks[r]["s01|q|int8|rs_sum"].shape[0]
        pos = tile.index(r)
        flat = np.zeros((2, 2 * c), np.float32)
        flat[:, :data["xq"].shape[1]] = data["xq"][tile]
        _bitwise(ranks[r]["s01|q|int8|rs_sum"], flat.sum(0)[pos * c:(pos + 1) * c],
                 f"exact sum {r}")


def test_a_set_that_does_not_tile_raises_on_the_quantized_wire(world):
    _, ranks, want = world
    jranks, jworld, jmsg = want["q_err_s012"]
    for r in range(N):
        name, msg = ranks[r]["q_err_s012"]
        assert name == "ProcessSetTilingError"
        np.testing.assert_array_equal(ranks[r]["q_err_fields"], jranks + [jworld])
        assert "do not tile the axis of size 4" in msg and "do not tile" in jmsg
        name, msg = ranks[r]["step_err_s012"]
        assert name == want["step_err_s012"] == "ProcessSetTilingError", name
        name, msg = ranks[r]["step_err_s012_c"]  # Compression.int8: the optimizer's check
        assert name == want["step_err_s012_c"] == "QuantizedWireError", name


def _solo(data, r, round_bf16):
    """Rank r's two SGD steps (lr 1) on its own rows alone, its float32
    gradient rounded to bf16 and back when ``round_bf16``."""
    w = torch.from_numpy(data["sw"].copy()).requires_grad_()
    b = torch.from_numpy(data["sb"].copy()).requires_grad_()
    for x, y in zip(data["sx"], data["sy"]):
        x, y = torch.from_numpy(x[4 * r:4 * r + 4]), torch.from_numpy(y[4 * r:4 * r + 4])
        gw, gb = torch.autograd.grad(((x @ w + b - y) ** 2).mean(), (w, b))
        if round_bf16:
            gw, gb = gw.bfloat16().float(), gb.bfloat16().float()
        with torch.no_grad():
            w -= gw
            b -= gb
    return w.detach().numpy()


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_the_step_on_a_set_matches_jax(world, wire):
    """bf16 bitwise, int8 with error feedback to 5e-7 (the FMA
    divergence of ``tests/test_torch_train_step.py``): members equal,
    each tile reduces on int8.  On bf16 a non-member keeps its own
    float32 gradient, launching nothing: its weights are bitwise its
    solo step's.  The JAX package's non-member row passes through the
    bf16 wire's two casts around its masked collective
    (``sched/execute.py:665-681``), so its gradient is rounded to bf16
    first (pinned with both values, ROADMAP Queue C)."""
    data, ranks, want = world
    for r in range(N):
        if wire == "bf16" and r not in SETS["s01"]:
            _bitwise(ranks[r][f"step|{wire}|w"], _solo(data, r, False), f"solo {r}")
            _bitwise(want[f"step|{wire}|w"][r], _solo(data, r, True), f"jax solo {r}")
            continue
        for k in ("w", "b") + (("res_w", "res_b") if wire == "int8" else ()):
            got, exp = ranks[r][f"step|{wire}|{k}"], want[f"step|{wire}|{k}"][r]
            if wire == "bf16":
                _bitwise(got, exp, f"{wire} {k} rank {r}")
            else:
                np.testing.assert_allclose(got, exp, rtol=0, atol=5e-7,
                                           err_msg=f"{wire} {k} rank {r}")
    w = {r: ranks[r][f"step|{wire}|w"] for r in range(N)}
    _bitwise(w[0], w[1], "members")
    if wire == "int8":
        _bitwise(w[2], w[3], "the tile {2, 3}")
    else:
        assert not np.array_equal(w[2], w[3])  # each keeps its own gradient
    assert not np.array_equal(w[0], w[2])
    assert not np.array_equal(w[0], data["sw"])


def test_objects_consistency_check_and_registration_in_the_world(world):
    data, ranks, want = world
    for r in range(N):
        got = ranks[r]
        np.testing.assert_array_equal(got["ids"], want["ids"])
        assert int(got["obj_bcast"]) == 1
        np.testing.assert_array_equal(got["obj_gather"], list(range(N)))
        np.testing.assert_array_equal(got["checked"], [2, 2, 2] if r < 2 else [1, 1, 1])
        assert got["err_check_set"][1].startswith("collective consistency check failed")
        assert "not registered" in got["err_unregistered"][1]
        assert "dynamic process sets" in got["err_gate"][1]
        np.testing.assert_array_equal(got["dyn_ar"], [5.0, 5.0] if r >= 2 else [r, r])
        np.testing.assert_array_equal(got["dyn_ids"], want["dyn_ids"])
        assert "not registered" in got["err_removed"][1]
        assert "global process set" in got["err_remove_global"][1]


def test_remove_process_set_drops_the_captured_steps_that_hold_it(world):
    """Faked capture: one graph on {0,1} (id 1) after two warm-up
    steps, replayed once more; removing the set drops it (reset, none
    kept, the step no longer holds id 1); the set added again (id 5:
    ids are never reused) warms up and captures anew."""
    _, ranks, _ = world
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["capture"], [2, 2, 2, 0, 1, 0, 1])
        np.testing.assert_array_equal(ranks[r]["capture_keys"], [[1, 0, 1], [5, 0, 1]])
