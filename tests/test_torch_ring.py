"""Kernels B6 and B7 and the fused quantized wire: the port against the
JAX package.

The plain versions of the ring kernels (``ops/ring_kernels.py``) are
held against ``horovod_tpu.ops.pallas_quant.fused_reduce_scatter`` and
``fused_all_gather`` in ``mode="interp"`` (Pallas interpret mode, one
``ppermute`` per hop) under ``shard_map`` on the conftest's CPU mesh,
jitted as the JAX package's own tests run them.  The CUDA kernels are
held bitwise against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, and why:

* the dequant of every chunk (the error-feedback residual's input) and
  B7's gathered rows: bitwise, NaN positions included, on every block
  whose maximum is not a float32 subnormal (XLA:CPU flushes those to
  zero, the port and the card keep them: ``tests/test_torch_quant.py``);
* B6's sum: bitwise on dyadic inputs (every product and every partial
  sum exact), else within ``5e-7·Σ|q_i·s_i|``: XLA:CPU contracts
  ``acc + q·s`` into a fused multiply-add, one rounding where the port
  and the card round the product and the sum, so each of the n - 1
  sums can differ by one float32 rounding of the terms (2·n·2^-24 ≤
  5e-7 at n ≤ 4).

The gloo worlds of 2 and 4 hold ``quantized_allreduce_ef`` and
``quantized_reduce_scatter`` on the ``fused`` backend (the interp
lowering: arrivals in hop order) and on ``phase`` (source order)
against the JAX package's, bitwise on dyadic inputs.  On random inputs
the reduce-scatter's shard agrees within ``5e-7·Σ|q_i·s_i|`` as above;
the allreduce re-quantizes that shard for its all-gather, so where the
two sums round apart an element can land one step of the wire's grid
(the block's scale for int8, the e4m3 spacing at that point times the
scale for fp8) apart, and the output is held to one step plus
``5e-7`` of itself; the new residual, ``e − q·s``, agrees to
``2^-24·|q·s|`` (XLA:CPU fuses the product into the subtraction).
"""

import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu import metrics as jmetrics
from horovod_tpu.ops import pallas_quant as jpq
from horovod_tpu.ops import quantized as jq
from horovod_tpu.runtime import WORLD_AXIS
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.ops import peer
from horovod_tpu_torch.ops import quant_kernels as qk
from horovod_tpu_torch.ops import quantized as tq
from horovod_tpu_torch.ops import ring_kernels as rk

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QMAX = {"int8": 127.0, "fp8": 448.0}


def _wire_grid(vals, wire):
    """Round float32 ``vals`` onto the wire's value grid."""
    if wire == "int8":
        return np.clip(np.round(vals), -127, 127).astype(np.float32)
    return torch.from_numpy(np.clip(vals, -448, 448).astype(np.float32)).to(
        torch.float8_e4m3fn).float().numpy()


def _inputs(rows, cols, block, seed, kind, wire):
    """(rows, cols) float32.  ``specials``: magnitudes 1e-3 to 1e3 per
    block, with an all-zero block, an infinity, a NaN, a block of
    subnormals and subnormals beside normals spread over the rows.
    ``dyadic``: every block holds values of the wire's grid times a
    power of two, its maximum ``qmax·2^-k``, so every scale, product and
    sum is exact."""
    rng = np.random.default_rng(seed)
    nb = cols // block
    if kind == "dyadic":
        k = rng.integers(2, 5, (rows, nb, 1))
        q = _wire_grid(rng.uniform(-QMAX[wire], QMAX[wire], (rows, nb, block)), wire)
        q[..., 0] = QMAX[wire]
        return (q * 2.0 ** -k).astype(np.float32).reshape(rows, cols)
    x = rng.standard_normal((rows, nb, block)).astype(np.float32)
    x *= (10.0 ** rng.integers(-3, 4, (rows, nb, 1))).astype(np.float32)
    flat = x.reshape(-1, block)
    step = max(1, flat.shape[0] // 5)
    flat[0] = 0.0
    flat[step, 3] = np.inf
    flat[2 * step, 5] = np.nan
    flat[3 * step] = np.linspace(-1e-39, 1e-39, block, dtype=np.float32)
    flat[4 * step, :3] = [1e-40, -3e-39, 1.2e-38]
    return x.reshape(rows, cols)


def _covered(blocks):
    """Per block (last axis): its maximum is not a float32 subnormal."""
    amax = np.abs(blocks).max(-1)
    return ~(np.isfinite(amax) & (amax > 0) & (amax < 2.0 ** -126))


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (WORLD_AXIS,))


def _jax_rs(x, wire, block, want_deq):
    n = x.shape[0]
    c = x.shape[1] // n

    def f(v):
        acc, deq = jpq.fused_reduce_scatter(
            v.reshape(n, c), WORLD_AXIS, groups=None, n=n, wire=wire,
            block=block, want_deq=want_deq, mode="interp")
        return (acc[None], deq[None]) if want_deq else acc[None]

    specs = (P(WORLD_AXIS), P(WORLD_AXIS)) if want_deq else P(WORLD_AXIS)
    out = jax.jit(shard_map(f, mesh=_mesh(n), in_specs=P(WORLD_AXIS),
                            out_specs=specs, check_vma=False))(jnp.asarray(x))
    return (np.array(out[0]), np.array(out[1])) if want_deq else (np.array(out), None)


def _jax_ag(shards, wire, block):
    n, c = shards.shape

    def f(v):
        return jpq.fused_all_gather(v.reshape(c), WORLD_AXIS, groups=None, n=n,
                                    wire=wire, block=block, mode="interp")[None]

    return np.array(jax.jit(shard_map(f, mesh=_mesh(n), in_specs=P(WORLD_AXIS),
                                      out_specs=P(WORLD_AXIS), check_vma=False))(
        jnp.asarray(shards)))


def _bitwise(got, want, where):
    """Bitwise on ``where`` (broadcast over the last axis), NaN where the
    other is NaN."""
    where = np.broadcast_to(where[..., None], got.shape)
    np.testing.assert_array_equal(np.isnan(got[where]), np.isnan(want[where]))
    ok = where & ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))


@pytest.mark.parametrize("kind", ["specials", "dyadic"])
@pytest.mark.parametrize("block", [64, 512])
@pytest.mark.parametrize("want_deq", [False, True])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 4])
def test_rs_ring_reference_matches_jax(n, wire, want_deq, block, kind):
    nb = 3 if block == 512 else 7
    c = nb * block
    x = _inputs(n, n * c, block, 10 * n + block, kind, wire)
    acc, deq = rk.rs_ring_reference(torch.from_numpy(x), wire, block, want_deq)
    jacc, jdeq = _jax_rs(x, wire, block, want_deq)
    assert tuple(acc.shape) == jacc.shape == (n, c)
    blocks = x.reshape(n, n, nb, block)  # [rank, chunk, block]
    cov = _covered(blocks)
    if want_deq:
        assert jdeq.shape == (n, n, c)
        _bitwise(deq.numpy().reshape(n, n, nb, block), jdeq.reshape(n, n, nb, block), cov)
    else:
        assert deq is None
    # Rank r's sum covers chunk r of every rank.
    mine = np.stack([cov[:, r].all(0) for r in range(n)])
    got, want = acc.numpy().reshape(n, nb, block), jacc.reshape(n, nb, block)
    if kind == "dyadic":
        _bitwise(got, want, mine)
        return
    terms = np.abs(rk.rs_ring_reference(torch.from_numpy(x), wire, block, True)[1]
                   .numpy().reshape(n, n, nb, block))
    mag = np.stack([terms[:, r].sum(0) for r in range(n)])
    where = np.broadcast_to(mine[..., None], got.shape)
    np.testing.assert_array_equal(np.isnan(got[where]), np.isnan(want[where]))
    ok = where & ~np.isnan(want)
    assert (np.abs(got[ok] - want[ok]) <= 5e-7 * mag[ok]).all()


@pytest.mark.parametrize("kind", ["specials", "dyadic"])
@pytest.mark.parametrize("block", [64, 512])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 4])
def test_ag_ring_reference_matches_jax(n, wire, block, kind):
    nb = 3 if block == 512 else 7
    shards = _inputs(n, nb * block, block, 7 * n + block, kind, wire)
    got = rk.ag_ring_reference(torch.from_numpy(shards), wire, block).numpy()
    want = _jax_ag(shards, wire, block)
    assert got.shape == want.shape == (n, n * nb * block)
    cov = np.broadcast_to(_covered(shards.reshape(n, nb, block)).reshape(1, -1),
                          (n, n * nb))
    _bitwise(got.reshape(n, n * nb, block), want.reshape(n, n * nb, block), cov)


@pytest.mark.parametrize("block", [64, 96])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_ring_references_are_the_b3_b4_b5_composition(n, wire, block):
    """B6's plain version is B3 on each rank's chunks, the arrivals in
    hop order, then B4; B7's is B3 on each shard, then B5: bitwise."""
    nb = 5
    c = nb * block
    x = torch.from_numpy(_inputs(n, n * c, block, n + block, "specials", wire))
    acc, deq = rk.rs_ring_reference(x, wire, block, want_deq=True)
    packed = []
    for r in range(n):
        p, d = qk.quant_packed(x[r].view(n, nb, block), wire, want_deq=True)
        assert torch.equal(d.view(n, c).view(torch.int32), deq[r].view(torch.int32))
        packed.append(p)
    for r in range(n):
        hops = torch.stack([packed[(r - t) % n][r] for t in range(n)])
        want = qk.dequant_accum(hops, wire).view(c)
        assert torch.equal(acc[r].view(torch.int32), want.view(torch.int32))
    shards = x[:, :c].contiguous()
    rows = qk.quant_packed(shards.view(n, nb, block), wire)[0]
    gathered = qk.dequant_rows(rows, wire).view(1, n * c)
    out = rk.ag_ring_reference(shards, wire, block)
    assert torch.equal(out.view(torch.int32), gathered.expand(n, -1).view(torch.int32))


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    x = torch.from_numpy(_inputs(3, 3 * 128, 64, 3, "specials", "int8"))
    before = (rk.rs_ring.launches, rk.ag_ring.launches)
    acc, deq = rk.rs_ring(x, None, "int8", 64, want_deq=True)
    racc, rdeq = rk.rs_ring_reference(x, "int8", 64, want_deq=True)
    assert torch.equal(acc.view(torch.int32), racc.view(torch.int32))
    assert torch.equal(deq.view(torch.int32), rdeq.view(torch.int32))
    out = rk.ag_ring(x[:, :128].contiguous(), None, "fp8", 64)
    want = rk.ag_ring_reference(x[:, :128].contiguous(), "fp8", 64)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert (rk.rs_ring.launches, rk.ag_ring.launches) == before
    with pytest.raises(ValueError):
        rk.rs_ring(x[:, :100], None, "int8", 64)  # not n chunks of whole blocks
    with pytest.raises(TypeError):
        rk.ag_ring(x.double(), None, "int8", 64)


# ------------------------------------------------------------ dispatch


@pytest.fixture
def jax_on_tpu(monkeypatch):
    """The JAX dispatch's hardware branch, as on one TPU slice."""
    from horovod_tpu.topo import model as topo_model

    class _Topo:
        num_slices = 1

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpq, "_HAS_PLTPU", True)
    monkeypatch.setattr(topo_model, "current", lambda: _Topo)
    return _Topo


@pytest.mark.parametrize("n,nbytes,hosts,want", [
    (2, 4096, 1, "ring"),
    (4, 8 * 1024 * 1024, 1, "ring"),
    (4, 8 * 1024 * 1024 + 1, 1, None),  # past the cap
    (4, 4096, 2, None),  # two hosts / two slices
    (1, 4096, 1, None),  # a world of one
])
def test_dispatch_mode_on_the_card_matches_the_tpu_dispatch(jax_on_tpu, n, nbytes,
                                                             hosts, want):
    jax_on_tpu.num_slices = hosts
    jwant = jpq.dispatch_mode(None, n, nbytes)
    assert (jwant == "tpu" and want == "ring") or jwant is want is None
    assert tq.dispatch_mode(n, nbytes, True, hosts == 1, True) == want
    # Cards that cannot reach each other's memory take the NCCL lowering.
    assert tq.dispatch_mode(n, nbytes, True, hosts == 1, False) is None


@pytest.mark.parametrize("n", [2, 4])
def test_dispatch_off_the_card_is_interp(n):
    assert jpq.dispatch_mode(None, n, 1 << 30) == "interp"
    assert tq.dispatch_mode(n, 1 << 30, False, False, False) == "interp"


def test_dispatch_counts_fallback_as_the_reference_does():
    """A world of one under ``fused`` falls back and counts it; under
    ``phase`` nothing is counted (``_fused_mode``, ``:157``)."""
    tmetrics.reset("quant.")
    before = jmetrics.get_counter("quant.fused_fallback")
    for backend in ("fused", "phase"):  # one fallback in all
        assert jq._fused_mode(None, 1, 512, 512, "int8", backend) is None
        assert tq.dispatch(1, 512, 512, "int8", torch.device("cpu"), backend) is None
        assert jmetrics.get_counter("quant.fused_fallback") - before == 1
        assert tmetrics.get_counter("quant.fused_fallback") == 1
    assert tq.dispatch(2, 512, 512, "int8", torch.device("cpu"), "fused") == \
        jq._fused_mode(None, 2, 512, 512, "int8", "fused") == "interp"


def test_world_of_one_counts_one_fallback_per_collective():
    import horovod_tpu_torch as thvd

    tmetrics.reset("quant.")
    thvd.init("cpu")
    try:
        assert (thvd.local_size(), thvd.cross_rank(), thvd.cross_size()) == (1, 0, 1)
        tq.quantized_allreduce_ef(torch.ones(1000), torch.zeros(1000), block=128,
                                  backend="fused")
        tq.quantized_allreduce(torch.ones(1000), block=128, backend="phase")
    finally:
        thvd.shutdown()
    assert tmetrics.get_counter("quant.fused_fallback") == 2
    assert tmetrics.get_counter("quant.fused_collectives") == 0


@pytest.mark.parametrize("n,want", [(16, "ring"), (17, None)])
def test_dispatch_mode_falls_back_past_the_kernels_ranks(n, want):
    """The kernels' pointer tables hold ``peer.MAX_RANKS`` (16) ranks; a
    larger one-host world falls back, as ``_fused_mode`` falls back on
    anything it cannot serve (``horovod_tpu/ops/quantized.py:157``)."""
    assert peer.MAX_RANKS == 16
    assert tq.dispatch_mode(n, 4096, True, True, True) == want


@pytest.fixture
def one_host_cards(monkeypatch):
    """A CUDA world on one host whose cards reach each other, without a
    card: the runtime ``dispatch`` asks is a stand-in."""
    fake = types.SimpleNamespace(cross_size=1, peers_reach=True)
    monkeypatch.setattr(tq.runtime, "get_runtime", lambda: fake)
    return fake


def test_dispatch_counts_the_fallback_past_the_kernels_ranks(one_host_cards):
    tmetrics.reset("quant.")
    cuda = torch.device("cuda")  # a device name: nothing is allocated
    assert tq.dispatch(16, 512, 512, "int8", cuda, "fused") == "ring"
    assert tmetrics.get_counter("quant.fused_collectives") == 1
    assert tmetrics.get_counter("quant.fused_fallback") == 0
    assert tq.dispatch(17, 512, 512, "int8", cuda, "fused") is None
    assert tmetrics.get_counter("quant.fused_fallback") == 1
    assert tmetrics.get_counter("quant.fused_collectives") == 1


# ------------------------------------------------------------ spin bound


@pytest.mark.parametrize("timeout_s", [37.5, 300.0])
def test_spin_bound_is_the_process_groups_timeout(timeout_s):
    import horovod_tpu_torch as thvd

    thvd.init("cpu", timeout_s=timeout_s)
    try:
        assert thvd.runtime.get_runtime().timeout_s == timeout_s
        assert rk.spin_timeout_s() == timeout_s
    finally:
        thvd.shutdown()
    assert rk.spin_timeout_s() == thvd.runtime.DEFAULT_TIMEOUT_S == 300.0


@pytest.mark.parametrize("which", ["rs_ring", "ag_ring"])
def test_ring_launch_passes_the_process_groups_timeout(monkeypatch, which):
    """The launch argument of each ring kernel is the runtime's timeout,
    unless the caller passes its own bound: the kernels' C entry points
    are replaced by a spy that records their arguments."""
    import contextlib

    import horovod_tpu_torch as thvd

    seen = []

    class _Lib:
        def _spy(self, *args):
            seen.append(args)
            return 0
        hvd_rs_ring = hvd_ag_ring = _spy

    monkeypatch.setattr(rk, "_check", lambda *a: True)
    monkeypatch.setattr(rk.peer, "library", lambda: _Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    window = types.SimpleNamespace(n=2, ranks=[0, 1], bases=[0, 0],
                                   slot_bytes=1 << 20, epochs=64)
    fn = getattr(rk, which)
    x = torch.ones(2, 2 * 64 if which == "rs_ring" else 64)
    thvd.init("cpu", timeout_s=41.0)
    try:
        before = fn.launches
        fn(x, window, "int8", 64)
        fn(x, window, "int8", 64, timeout_s=0.5)
        assert fn.launches == before + 2
    finally:
        thvd.shutdown()
    assert [args[-2] for args in seen] == [41.0, 0.5]


@pytest.mark.parametrize("ranks", [[0, 1], [1]])
@pytest.mark.parametrize("which", ["rs_ring", "ag_ring"])
def test_cached_pointer_tables_carry_each_calls_tensors(monkeypatch, which, ranks):
    """The wrappers keep their ctypes tables on the window and rewrite
    them per call: a spy on the C entry copies the tables it is handed,
    and two calls with different tensors on one window each carry their
    own tensors' addresses at their ranks' indices (the other ranks'
    null), and every rank's window base."""
    import contextlib

    seen = []

    def spy(*args):
        tables = []
        for a in args:  # the tables lead; the world size is the first int
            if isinstance(a, int):
                break
            tables.append(None if a is None else list(a))
        seen.append(tables)
        return 0

    lib = types.SimpleNamespace(hvd_rs_ring=spy, hvd_ag_ring=spy)
    monkeypatch.setattr(rk, "_check", lambda *a: True)
    monkeypatch.setattr(rk.peer, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    window = types.SimpleNamespace(n=2, ranks=ranks, bases=[4096, 8192],
                                   slot_bytes=1 << 20, epochs=64)
    fn = getattr(rk, which)
    cols = 2 * 64 if which == "rs_ring" else 64
    calls = [torch.ones(len(ranks), cols), torch.zeros(len(ranks), cols)]
    kept = [fn(x, window, "int8", 64, **({"want_deq": True} if which == "rs_ring" else {}))
            for x in calls]  # both calls' outputs alive: their addresses differ
    assert len(seen) == 2 and len(kept) == 2
    for x, tables in zip(calls, seen):
        xs, wins = tables[0], tables[-1]
        assert len(tables) == (4 if which == "rs_ring" else 3)
        assert wins == [4096, 8192]
        want = [None, None]
        for i, r in enumerate(ranks):
            want[r] = x[i].data_ptr()
        assert xs == want
    # The outputs' tables carry each call's own fresh output rows.
    for result, tables in zip(kept, seen):
        out = result[0] if which == "rs_ring" else result
        want = [None, None]
        for i, r in enumerate(ranks):
            want[r] = out[i].data_ptr()
        assert tables[1] == want
    assert seen[0][1] != seen[1][1]


# --------------------------------------------------------- gloo worlds


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.ops import quantized as tq

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=100)
    try:
        data = np.load(out + "/data.npz")
        res = {"places": np.array([hvd.local_size(), hvd.cross_rank(),
                                   hvd.cross_size()])}
        for key in sorted(k for k in data.files if k.startswith("x_")):
            _, wire, kind = key.split("_")
            x = torch.from_numpy(data[key][rank])
            r = torch.from_numpy(data["r_" + wire + "_" + kind][rank])
            for backend in ("fused", "phase"):
                metrics.reset("quant.")
                tag = "_".join((wire, kind, backend))
                out_, r_new = tq.quantized_allreduce_ef(x, r, wire=wire, block=128,
                                                        backend=backend)
                shard, _ = tq.quantized_reduce_scatter(x + r, tq.Sum, wire=wire,
                                                       block=128, ef=True,
                                                       backend=backend)
                res["out_" + tag] = out_.numpy()
                res["res_" + tag] = r_new.numpy()
                res["shard_" + tag] = shard.numpy()
                res["count_" + tag] = np.array([
                    metrics.get_counter("quant.fused_collectives"),
                    metrics.get_counter("quant.fused_fallback")])
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""")

V, BLOCK = 3000, 128
WIRES, KINDS = ("int8", "fp8"), ("dyadic", "random")


def _world_data(n):
    data = {}
    for wire in WIRES:
        for kind in KINDS:
            if kind == "dyadic":
                x = _inputs(n, 24 * BLOCK, BLOCK, n, "dyadic", wire)[:, :V]
                r = np.zeros((n, V), np.float32)
            else:
                rng = np.random.default_rng(n + 1)
                x = (rng.standard_normal((n, V))
                     * 10.0 ** rng.integers(-2, 3, (n, V))).astype(np.float32)
                r = (rng.standard_normal((n, V)) * 1e-3).astype(np.float32)
            data[f"x_{wire}_{kind}"], data[f"r_{wire}_{kind}"] = x, r
    return data


def _run_world(tmp, n):
    data = _world_data(n)
    np.savez(tmp / "data.npz", **data)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_QUANT_BACKEND"):
        env.pop(k, None)
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(n), str(tmp / "store"),
                 str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return data, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's gloo worlds of 2 and 4, each run once."""
    return {n: _run_world(tmp_path_factory.mktemp(f"world{n}"), n) for n in (2, 4)}


def _jax_world(x, r, wire, backend):
    n = x.shape[0]

    def f(xv, rv):
        out, r_new = jq.quantized_allreduce_ef(xv[0], rv[0], WORLD_AXIS, wire=wire,
                                               block=BLOCK, backend=backend)
        shard, _ = jq.quantized_reduce_scatter(xv[0] + rv[0], WORLD_AXIS, op=jq.Sum,
                                               wire=wire, block=BLOCK, ef=True,
                                               backend=backend)
        return out[None], r_new[None], shard[None]

    spec = P(WORLD_AXIS)
    fn = jax.jit(shard_map(f, mesh=_mesh(n), in_specs=(spec, spec),
                           out_specs=(spec, spec, spec), check_vma=False))
    return [np.array(a) for a in fn(jnp.asarray(x), jnp.asarray(r))]


@pytest.mark.parametrize("backend", ["fused", "phase"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n", [2, 4])
def test_gloo_world_matches_jax(worlds, n, wire, kind, backend):
    data, ranks = worlds[n]
    x, r = data[f"x_{wire}_{kind}"], data[f"r_{wire}_{kind}"]
    jout, jres, jshard = _jax_world(x, r, wire, backend)
    tag = "_".join((wire, kind, backend))
    out = np.stack([g["out_" + tag] for g in ranks])
    res = np.stack([g["res_" + tag] for g in ranks])
    shard = np.stack([g["shard_" + tag] for g in ranks])
    for g in ranks:
        np.testing.assert_array_equal(g["places"], [n, 0, 1])
        # Every rank applies the same all-gathered dequant.
        np.testing.assert_array_equal(g["out_" + tag], ranks[0]["out_" + tag])
        # Three collectives (the allreduce's two and the reduce-scatter);
        # phase counts none.
        np.testing.assert_array_equal(g["count_" + tag],
                                      [3 if backend == "fused" else 0, 0])
    if kind == "dyadic":
        for got, want in ((out, jout), (res, jres), (shard, jshard)):
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        return
    # The terms of each shard element: every rank's dequant of it.
    c = shard.shape[1]
    e = np.zeros((n, n * c), np.float32)
    e[:, :V] = x + r
    deq = qk.quant_math_reference(torch.from_numpy(e).view(n, n, c // BLOCK, BLOCK),
                                  wire)[2].numpy().reshape(n, n, c)
    mag = np.abs(deq).sum(0)  # [chunk (= rank of the shard), element]
    assert (np.abs(shard - jshard) <= 5e-7 * mag).all()
    np.testing.assert_array_less(np.abs(res - jres),
                                 2.0 ** -24 * np.abs(deq.reshape(n, -1)[:, :V]) + 1e-45)
    step = _grid_step(jout[0], n, c, wire)
    assert (np.abs(out - jout) <= step + 5e-7 * np.abs(jout)).all()


def _grid_step(avg, n, c, wire):
    """Per element of an average out of the all-gather, the distance from
    its grid point to the next one out: the block's scale (int8) or the
    e4m3 spacing at that point times the scale (fp8), over n.  The scale
    is recovered from the block's largest dequant, ``qmax·scale``
    rounded once, hence the margin of 2^-20."""
    full = np.zeros(n * c, np.float32)
    full[:avg.size] = avg * n  # the gathered dequant (n is a power of two)
    blocks = full.reshape(-1, BLOCK)
    scale = np.abs(blocks).max(-1, keepdims=True) / QMAX[wire]
    if wire == "int8":
        spacing = np.ones_like(blocks)
    else:
        g = np.abs(blocks) / np.where(scale > 0, scale, 1.0)
        g = np.abs(_wire_grid(g, wire))
        spacing = np.where(g >= 2.0 ** -6,
                           2.0 ** (np.floor(np.log2(np.maximum(g, 2.0 ** -6))) - 3),
                           2.0 ** -9)
    return ((spacing * scale) / n * (1 + 2.0 ** -20)).reshape(-1)[:avg.size]
