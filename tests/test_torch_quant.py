"""Kernels B3, B4, B5 and the quantized wire: the port against the JAX
package.

The port's wrappers on CPU tensors compute the kernels' plain versions;
they are held against ``horovod_tpu.ops.pallas_quant``'s Pallas kernels
run in interpret mode under ``jax.jit`` (the main path always runs them
jitted, and XLA's jit turns ``amax / qmax`` into ``amax * (1/qmax)``: an
eager reference differs from both in the last bit of the scale).  The
CUDA kernels are held bitwise against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The contract, and the two properties of XLA's CPU backend outside it:

* B3: the float32 scale is bitwise on every block, NaN positions
  included; q and the dequant are bitwise on every finite block, and the
  dequant is NaN on the same blocks.  A block whose amax is a float32
  subnormal is left out: XLA:CPU flushes it to zero (scale 1.0), the
  port keeps it (scale ``amax·(1/qmax)``), as the card does.
* B4: bitwise for one arrival.  For more, XLA:CPU contracts ``acc +
  q·s`` into a fused multiply-add (one rounding where the port, like the
  CUDA kernel, rounds the product and the sum), so each output agrees
  to ``2·n·2^-24·Σ|q_i·s_i|``: one float32 rounding of every product
  and every partial sum.
* B5 and the pack layout: bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.experimental import pallas as pl
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops import pallas_quant as jpq
from horovod_tpu.sched import plan as jplan
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.exceptions import QuantizedWireError
from horovod_tpu_torch.ops import quant_kernels as qk
from horovod_tpu_torch.ops import quantized as tq
from horovod_tpu_torch.sched import execute as texecute
from horovod_tpu_torch.sched import plan as tplan

torch.set_num_threads(2)

BLOCKS = [64, 128, 512, 96]


def _blocks(m, nb, block, seed, specials=True):
    """(m, nb, block) float32, magnitudes 1e-3 to 1e3 per block; with
    ``specials`` the first blocks are all zero, hold an infinity, a
    NaN, only subnormals, and subnormals beside normals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, nb, block)).astype(np.float32)
    x *= (10.0 ** rng.integers(-3, 4, (m, nb, 1))).astype(np.float32)
    if specials:
        flat = x.reshape(-1, block)
        flat[0] = 0.0
        flat[1, 3] = np.inf
        flat[2, 5] = np.nan
        flat[3] = np.linspace(-1e-39, 1e-39, block, dtype=np.float32)
        flat[4, :3] = [1e-40, -3e-39, 1.2e-38]
    return x


def _jax_quant(x, wire, want_deq):
    fn = jax.jit(functools.partial(jpq._quant_packed, wire=wire,
                                   want_deq=want_deq))
    p, d = fn(jnp.asarray(x))
    return np.array(p), (None if d is None else np.array(d))


@pytest.mark.parametrize("want_deq", [False, True])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quant_packed_matches_jax(wire, block, want_deq):
    x = _blocks(3, 9, block, block)
    jp, jd = _jax_quant(x, wire, want_deq)
    tp, td = qk.quant_packed(torch.from_numpy(x), wire, want_deq)
    assert tp.dtype == torch.int8 and tuple(tp.shape) == (3, 9, block + 4)
    tp = tp.numpy()
    amax = np.abs(x).max(-1)
    normal = ~(np.isfinite(amax) & (amax > 0) & (amax < 2.0 ** -126))
    finite = np.isfinite(x).all(-1)
    keep = finite & normal
    # Scales: bitwise on every block the contract covers, NaN included.
    js = jp[..., block:].copy().view(np.uint32)[..., 0]
    ts = tp[..., block:].copy().view(np.uint32)[..., 0]
    np.testing.assert_array_equal(ts[normal], js[normal])
    assert np.isnan(ts.view(np.float32)[~finite]).all()
    np.testing.assert_array_equal(tp[..., :block][keep], jp[..., :block][keep])
    # Non-finite blocks carry q = 0 in the port (and on the card).
    assert (tp[..., :block][~finite] == 0).all()
    if want_deq:
        td = td.numpy()
        np.testing.assert_array_equal(td[keep].view(np.uint32),
                                      jd[keep].view(np.uint32))
        np.testing.assert_array_equal(np.isnan(td).any(-1), ~finite)
        np.testing.assert_array_equal(np.isnan(jd).any(-1), ~finite)
    else:
        assert td is None and jd is None


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_pack_layout_matches_jax_pack_math(wire):
    """The same wire values and scales packed by ``_pack_math`` and by
    the port: the scale's four bytes last, little-endian."""
    rng = np.random.default_rng(5)
    s = rng.standard_normal((2, 6, 1)).astype(np.float32)
    s[0, 0, 0] = np.nan
    if wire == "int8":
        q = rng.integers(-127, 128, (2, 6, 64)).astype(np.int8)
        jq_, tq_ = jnp.asarray(q), torch.from_numpy(q)
    else:
        raw = rng.standard_normal((2, 6, 64)).astype(np.float32) * 100
        tq_ = torch.from_numpy(raw).to(torch.float8_e4m3fn)
        jq_ = jax.lax.bitcast_convert_type(
            jnp.asarray(tq_.view(torch.int8).numpy()), jnp.float8_e4m3fn
        )
    want = np.asarray(jax.jit(jpq._pack_math)(jq_, jnp.asarray(s)))
    got = qk.pack_reference(tq_, torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 64:].copy().view(np.uint32),
                                  s.view(np.uint32))
    q2, s2 = qk.unpack_reference(torch.from_numpy(got), wire)
    assert torch.equal(q2.view(torch.int8), tq_.view(torch.int8))
    np.testing.assert_array_equal(s2.numpy().view(np.uint32), s.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_dequant_accum_matches_jax(wire, n):
    block = 128
    x = _blocks(n, 11, block, 20 + n, specials=False)
    packed, _ = _jax_quant(x, wire, False)
    want = np.array(jax.jit(lambda *a: jpq._rs_accum(list(a), wire))(
        *[jnp.asarray(packed[i]) for i in range(n)]
    ))
    got = qk.dequant_accum(torch.from_numpy(packed), wire).numpy()
    if n == 1:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        return
    q, s = qk.unpack_reference(torch.from_numpy(packed), wire)
    mag = (q.float() * s).abs().sum(0).numpy()
    np.testing.assert_array_less(np.abs(got - want), 2 * n * 2.0 ** -24 * mag + 1e-45)


@pytest.mark.parametrize("block", [64, 96])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_dequant_rows_matches_jax(wire, block):
    packed, _ = _jax_quant(_blocks(4, 7, block, 3), wire, False)
    kernel = pl.pallas_call(
        functools.partial(jpq._dequant_rows_kernel, wire=wire),
        out_shape=jax.ShapeDtypeStruct((4, 7, block), jnp.float32),
        interpret=True,
    )
    want = np.asarray(jax.jit(kernel)(jnp.asarray(packed)))
    got = qk.dequant_rows(torch.from_numpy(packed), wire).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))


def _leaves(seed, n, dtypes):
    rng = np.random.default_rng(seed)
    sizes = [int(s) * 4 for s in rng.integers(1, 40000, n)]
    return sizes, [dtypes[i] for i in rng.integers(0, len(dtypes), n)]


@pytest.mark.parametrize("block", [None, 64, 100])
@pytest.mark.parametrize("dtypes", [["float32"], ["float32", "bfloat16"],
                                    ["float32", "int32"]])
@pytest.mark.parametrize("wire", ["int8", "fp8", "e4m3"])
def test_quantized_plan_matches_jax(monkeypatch, wire, dtypes, block):
    """Per-bucket wires (one floating dtype per quantized bucket, else
    ``off``) and wire bytes (elements + 4 per block) as the JAX plan."""
    if block is not None:
        monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", str(block))
    sizes, dts = _leaves(len(dtypes), 30, dtypes)
    js = jplan.build_schedule(
        sizes, dts, jplan.SchedConfig(bucket_bytes=200000, wire=wire,
                                      lowering="flat"),
    )
    ts = tplan.build_schedule(sizes, dts,
                              tplan.SchedConfig(bucket_bytes=200000, wire=wire))
    assert len(js.buckets) == len(ts.buckets)
    for jb, tb in zip(js.buckets, ts.buckets):
        assert (tuple(jb.indices), jb.wire) == (tb.indices, tb.wire)
        assert jplan.eligible_wire(jb.wire, jb.wire_dtypes) == \
            tplan.eligible_wire(tb.wire, tb.wire_dtypes)
        assert jplan.wire_bytes(jb) == tplan.wire_bytes(tb)
    assert {b.wire for b in ts.buckets} <= {"fp8" if wire == "e4m3" else wire, "off"}


def test_knobs_match_jax(monkeypatch):
    from horovod_tpu.ops import quantized as jq

    monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", "96")
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE_EF", "0")
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "e4m3")
    assert tq.quant_block() == jq.quant_block() == 96
    j, t = jplan.SchedConfig.from_env(), tplan.SchedConfig.from_env()
    assert (t.wire, t.wire_ef) == (j.wire, j.wire_ef) == ("fp8", False)
    for spelling in ("phase", "fused", "pallas", "ring", "xla"):
        assert tq._canon_backend(spelling) == jq._canon_backend(spelling)
    monkeypatch.setenv("HVD_TPU_QUANT_BACKEND", "bogus")
    with pytest.raises(QuantizedWireError):
        tq.quant_backend()
    with pytest.raises(QuantizedWireError):
        tq._canon_wire("int4")
    assert tq.wire_itemsize("e4m3") == jq.wire_itemsize("e4m3") == 1


def test_wire_bytes_ratio_at_resnet_buckets(monkeypatch):
    """``sched.wire_bytes{wire=int8}`` / ``sched.compression_ratio``:
    at least 3x below the float32 wire at ResNet-50's bucket sizes (the
    contract stated by ``tests/test_quant_wire.py:188``)."""
    monkeypatch.delenv("HVD_TPU_QUANT_BLOCK", raising=False)
    sizes = [16489472 * 4, 9068032 * 4]
    sched = tplan.build_schedule(
        sizes, ["float32"] * 2, tplan.SchedConfig(bucket_bytes=sizes[0]),
        wire="int8",
    )
    assert [b.wire for b in sched.buckets] == ["int8", "int8"]
    tmetrics.reset("sched.")
    texecute.record_wire_metrics(sched)
    int8_bytes = tmetrics.get_gauge("sched.wire_bytes", {"wire": "int8"})
    assert int8_bytes == sum(s // 4 + 4 * (s // 4 // 512) for s in sizes)
    assert sum(sizes) / int8_bytes >= 3.0
    assert tmetrics.get_gauge("sched.compression_ratio") >= 3.0
    assert tmetrics.get_counter("sched.wire_bytes.int8") == int8_bytes


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_world1_quantized_allreduce_matches_jax(wire):
    """World of one: the quantized allreduce, with and without error
    feedback, against the JAX package's on one device, bitwise (B4 sums
    a single arrival).  The new residual ``e − q·s`` agrees to
    ``2^-24·|q·s|``: XLA:CPU fuses the product into the subtraction
    (one rounding), the port rounds the dequant first, as the card's
    B3 writes it."""
    import horovod_tpu as jhvd
    import horovod_tpu_torch as thvd
    from horovod_tpu.ops import quantized as jq
    from horovod_tpu.runtime import get_runtime

    rng = np.random.default_rng(9)
    x = (rng.standard_normal(3000) * 10.0 ** rng.integers(-2, 3, 3000)).astype(np.float32)
    r = (rng.standard_normal(3000) * 1e-3).astype(np.float32)
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    try:
        def run(v, res):
            out, r_new = jq.quantized_allreduce_ef(v, res, wire=wire, block=128)
            return out, r_new, jq.quantized_allreduce(v, wire=wire, block=128)

        fn = jax.jit(shard_map(
            run, mesh=get_runtime().mesh, in_specs=(P(), P()),
            out_specs=(P(), P(), P()), check_vma=False,
        ))
        out_j, r_j, plain_j = [np.array(a) for a in fn(jnp.asarray(x),
                                                        jnp.asarray(r))]
    finally:
        jhvd.shutdown()
    thvd.init("cpu")
    try:
        out, r_new = tq.quantized_allreduce_ef(
            torch.from_numpy(x), torch.from_numpy(r), wire=wire, block=128
        )
        plain = tq.quantized_allreduce(torch.from_numpy(x), wire=wire, block=128)
    finally:
        thvd.shutdown()
    np.testing.assert_array_equal(out.numpy().view(np.uint32), out_j.view(np.uint32))
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), plain_j.view(np.uint32))
    e = torch.nn.functional.pad(torch.from_numpy(x + r), (0, 72))
    deq = qk.quant_math_reference(e.view(24, 128), wire)[2].view(-1)[:3000]
    np.testing.assert_array_less(np.abs(r_new.numpy() - r_j), 2.0 ** -24 * deq.abs().numpy() + 1e-45)


def test_quantized_collectives_refuse_what_they_cannot_serve():
    import horovod_tpu_torch as thvd

    thvd.init("cpu")
    try:
        x = torch.ones(100)
        with pytest.raises(QuantizedWireError):
            tq.quantized_reduce_scatter(x, op=4)  # the JAX package's Max
        # A process set is validated as the JAX package's _ps_id
        # validates it: neither a non-ProcessSet nor an unregistered set.
        for bad in (object(), thvd.ProcessSet([0])):
            with pytest.raises(thvd.exceptions.HorovodTpuError):
                tq.quantized_allreduce(x, process_set=bad)
        with pytest.raises(QuantizedWireError):
            tq.quantized_all_gather(torch.ones(100), block=64)
        with pytest.raises(QuantizedWireError):
            tq.quantized_allreduce(x, backend="bogus")
    finally:
        thvd.shutdown()
