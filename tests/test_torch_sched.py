"""The port's bucket plan and schedule against the JAX package's.

Same sizes, dtypes, thresholds, orders and wire requests go through
``horovod_tpu.sched.plan.build_schedule`` / ``ops.fusion.bucket_plan``
and their ``horovod_tpu_torch`` counterparts; bucket indices, byte
counts, dtypes and per-bucket wires must be identical (the plan is
exact integer bookkeeping: no tolerance).
"""

import numpy as np
import pytest
import torch

from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.sched import plan as jplan
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.sched import execute as texecute
from horovod_tpu_torch.sched import plan as tplan

torch.set_num_threads(2)


def _leaves(seed: int, n: int, dtypes):
    rng = np.random.default_rng(seed)
    sizes = [int(s) * 4 for s in rng.integers(1, 4096, n)]
    dts = [dtypes[i] for i in rng.integers(0, len(dtypes), n)]
    return sizes, dts


CASES = [
    # (seed, n, dtypes, threshold, look_ahead, wire, order)
    (0, 20, ["float32"], 16384, 3, "off", None),
    (1, 30, ["float32"], 16384, 3, "bf16", None),
    (2, 40, ["float32", "bfloat16"], 8192, 3, "bf16", None),
    (3, 40, ["float32", "float16", "int32"], 12000, 3, "bf16", None),
    (4, 25, ["float32", "bfloat16"], 8192, -1, "off", None),
    (5, 25, ["float32"], 0, 3, "bf16", None),
    (6, 33, ["float32", "int32"], 1 << 20, 3, "bf16", "shuffle"),
    (7, 10, ["float32"], 4096, 1, "bf16", "forward"),
    (8, 30, ["float32", "bfloat16"], 8192, 3, "int8", None),
    (9, 25, ["float32", "int32"], 12000, 3, "fp8", "shuffle"),
]


def _order(kind, n, seed):
    if kind is None:
        return None
    if kind == "forward":
        return list(range(n))
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


def _same(js, ts):
    assert len(js.buckets) == len(ts.buckets)
    for jb, tb in zip(js.buckets, ts.buckets):
        assert tuple(jb.indices) == tb.indices
        assert jb.nbytes == tb.nbytes
        assert tuple(jb.wire_dtypes) == tb.wire_dtypes
        assert jb.wire == tb.wire
        assert jplan.wire_bytes(jb) == tplan.wire_bytes(tb)
    assert js.total_bytes == ts.total_bytes


@pytest.mark.parametrize("seed,n,dtypes,threshold,look_ahead,wire,order", CASES)
def test_build_schedule_matches_jax(seed, n, dtypes, threshold, look_ahead,
                                    wire, order):
    sizes, dts = _leaves(seed, n, dtypes)
    od = _order(order, n, seed)
    js = jplan.build_schedule(
        sizes, dts,
        jplan.SchedConfig(bucket_bytes=threshold, look_ahead=look_ahead,
                          wire=wire, lowering="flat"),
        order=od,
    )
    ts = tplan.build_schedule(
        sizes, dts,
        tplan.SchedConfig(bucket_bytes=threshold, look_ahead=look_ahead,
                          wire=wire),
        order=od,
    )
    _same(js, ts)


@pytest.mark.parametrize("seed,n,dtypes,threshold,look_ahead,wire,order", CASES)
def test_bucket_plan_matches_jax(seed, n, dtypes, threshold, look_ahead,
                                 wire, order):
    sizes, dts = _leaves(seed, n, dtypes)
    assert tfusion.bucket_plan(sizes, dts, threshold, look_ahead) == \
        jfusion.bucket_plan(sizes, dts, threshold, look_ahead)


@pytest.mark.parametrize("pinned", [[[0, 1]], [[3, 7], [10]]])
def test_pinned_groups_match_jax(pinned):
    sizes, dts = _leaves(11, 12, ["float32"])
    js = jplan.build_schedule(
        sizes, dts, jplan.SchedConfig(bucket_bytes=8192, lowering="flat"),
        pinned=pinned, wire="bf16",
    )
    ts = tplan.build_schedule(
        sizes, dts, tplan.SchedConfig(bucket_bytes=8192), pinned=pinned,
        wire="bf16",
    )
    _same(js, ts)


def test_incomplete_order_falls_back_to_reverse():
    sizes, dts = _leaves(12, 8, ["float32"])
    cfg = tplan.SchedConfig(bucket_bytes=8192)
    want = tplan.build_schedule(sizes, dts, cfg).signature()
    assert tplan.build_schedule(sizes, dts, cfg, order=[0, 1, 1]).signature() == want


def test_config_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16")
    monkeypatch.setenv("HVD_TPU_SCHED_BUCKET_BYTES", "1234")
    monkeypatch.setenv("HVD_TPU_SCHED_LOOK_AHEAD", "5")
    monkeypatch.setenv("HVD_TPU_SCHED_CAPTURE_ORDER", "0")
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE_EF", "off")
    for barriers in ("1", "0"):
        monkeypatch.setenv("HVD_TPU_SCHED_BARRIERS", barriers)
        j, t = jplan.SchedConfig.from_env(), tplan.SchedConfig.from_env()
        for f in ("enabled", "bucket_bytes", "look_ahead", "barriers",
                  "capture_order", "wire", "wire_ef"):
            assert getattr(j, f) == getattr(t, f), f
    # Unset, the port exchanges after the backward (the JAX package
    # sequences its buckets): the overlapped step measured slower.
    monkeypatch.delenv("HVD_TPU_SCHED_BARRIERS")
    assert jplan.SchedConfig.from_env().barriers
    assert not tplan.SchedConfig.from_env().barriers


def test_quantized_wire_is_not_ported():
    """Kept under its first name; the quantized wires are ported now:
    they parse as in the JAX package (``e4m3`` is ``fp8``), and an
    unknown wire is still refused."""
    for wire in ("int8", "fp8", "e4m3", "off", "bf16"):
        assert tplan.SchedConfig(wire=wire).wire == \
            jplan.SchedConfig(wire=wire).wire
    with pytest.raises(ValueError):
        tplan.SchedConfig(wire="int4")


def test_exchange_records_wire_metrics():
    """Bucketed exchange with an identity reducer returns the leaves
    unchanged and publishes the JAX package's ``sched.*`` metrics."""
    leaves = [torch.arange(n, dtype=torch.float32) for n in (5, 300, 17)]
    sizes = [t.numel() * 4 for t in leaves]
    sched = tplan.build_schedule(
        sizes, ["float32"] * 3, tplan.SchedConfig(bucket_bytes=1300),
        wire="bf16",
    )
    tmetrics.reset("sched.")
    chain = texecute.BucketChain(sched, lambda f, b: f)
    for k, b in enumerate(sched.buckets):
        chain.launch(k, lambda b=b: [leaves[i] for i in b.indices])
    out = chain.finish()
    for a, b in zip(out, leaves):
        assert torch.equal(a, b)
    assert tmetrics.get_counter("sched.buckets") == len(sched)
    assert tmetrics.get_gauge("sched.bytes_per_step") == sum(sizes)
    assert tmetrics.get_gauge("sched.wire_bytes", {"wire": "bf16"}) == \
        sum(sizes) // 2
