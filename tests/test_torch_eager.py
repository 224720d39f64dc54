"""The port's eager collective API against the JAX package's.

Two gloo worlds of the port, of 2 and of 3 processes joined through a
``FileStore``, each run every op of ``horovod_tpu_torch.ops.eager`` once
on its own rank's tensors and save the results.  The same per-rank
inputs, made from a seed with numpy, stacked, go through the JAX eager
ops (``horovod_tpu.ops.eager``) on ``jax.devices()[:n]``; rank r's
result must equal row r of the JAX op's (the JAX eager API's stacked
form is one row per rank).  Tolerances:

* bitwise on the dyadic float32/bf16 inputs (multiples of 1/4 in
  [-2, 2]: every sum, product, scale and cast of them is exact or
  rounds once, the same way in both packages) and on int32 inputs, for
  every ReduceOp but Adasum, the pre/postscale (bf16: kernel B1's plain
  version, float32 arithmetic rounded once), integer Average at world 3
  (float32(1/3), truncated), grouped allreduce (fused and under
  ``HVD_TPU_DISABLE_GROUP_FUSION``), allgather, allgather_v, broadcast
  from root 1, reducescatter, even and uneven alltoall (the JAX
  package's uneven output is padded to the largest chunk; its padding is
  removed before the comparison) with their received splits,
  ``join_average``, the async forms, and the gradients of
  ``horovod_tpu/interop/_grads.py``;
* on random float32 inputs gloo and XLA add the n terms in other
  orders, so a Sum or Average agrees to 2·2^-24 of Σ|x_i| (two
  roundings at most at n ≤ 3); bf16 to 2·2^-8 of it (gloo rounds each
  partial sum to bf16).

Also: ``barrier``, ``join`` (the rank that sleeps 0.2 s before it joins
is the answer on every rank), the counters, the consistency check (a
shape mismatch raises on every rank), the errors of a reducescatter or
even alltoall whose dim 0 the world does not divide, and, in this
process at world one, the errors for an unregistered ``process_set`` and
``average`` with ``op``, Adasum returning the input, and ``runtime.refuse_in_capture`` for every op
that waits on the host, with the capture faked.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.interop import _grads
from horovod_tpu.ops import eager as je
from horovod_tpu.ops import traced
from horovod_tpu.runtime import WORLD_AXIS, get_runtime
import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import fusion as tfusion

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("float32", "bfloat16", "int32")
OPS = {"avg": 0, "sum": 1, "min": 3, "max": 4, "prod": 5}
SLEEPER = 0  # the rank that joins last

_WORKER = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, runtime
    from horovod_tpu_torch.exceptions import HorovodTpuError
    from horovod_tpu_torch.ops import collectives

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60)
    data = dict(np.load(out + "/data.npz"))
    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}
    OPS = {"avg": hvd.Average, "sum": hvd.Sum, "min": hvd.Min, "max": hvd.Max,
           "prod": hvd.Product}
    res = {}

    def mine(key, dt=None):
        t = torch.from_numpy(data[key][rank].copy())
        return t.to(DT[dt]) if dt else t

    def own(key):
        return torch.from_numpy(data[f"{key}_{rank}"].copy())

    def save(key, t):
        res[key] = (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()

    def raises(exc, fn):
        try:
            fn()
        except exc as e:
            return str(e)
        raise SystemExit(f"rank {rank}: expected {exc.__name__}")

    try:
        metrics.reset("collective.")
        x = mine("x_float32", "float32")
        hvd.allreduce(x)
        hvd.grouped_allreduce([x, x[:1].to(torch.bfloat16)])
        res["counters"] = np.array([
            metrics.get_counter("collective.allreduce.dispatches"),
            metrics.get_counter("collective.allreduce.bytes"),
            metrics.get_counter("collective.grouped_allreduce.dispatches"),
            metrics.get_counter("collective.grouped_allreduce.bytes")])
        for dt in DT:
            x = mine("x_" + dt, dt)
            before = x.clone()
            for name, op in OPS.items():
                save(f"ar_{name}_{dt}", hvd.allreduce(x, op=op))
            save("ar_scaled_" + dt, hvd.allreduce(x, op=hvd.Average, prescale_factor=0.5,
                                                  postscale_factor=3.0))
            save("allgather_" + dt, hvd.allgather(x))
            save("broadcast_" + dt, hvd.broadcast(x, 1))
            save("rs_sum_" + dt, hvd.reducescatter(x))
            save("rs_avg_" + dt, hvd.reducescatter(x, op=hvd.Average))
            save("rs_scaled_" + dt, hvd.reducescatter(x, op=hvd.Average, prescale_factor=0.5,
                                                     postscale_factor=3.0))
            save("a2a_" + dt, hvd.alltoall(x))
            assert torch.equal(x, before)  # out of place
            y = x.clone()
            assert hvd.allreduce_(y, op=hvd.Max) is y
            save("ar_inplace_" + dt, y)
            y = x.clone()
            assert hvd.broadcast_(y, 1) is y
            save("broadcast_inplace_" + dt, y)
        group = [mine("x_float32", "float32"), mine("x_bfloat16", "bfloat16"),
                 mine("x_int32", "int32"), mine("y_float32", "float32")]
        for tag, fuse in (("fused", "0"), ("unfused", "1")):
            os.environ["HVD_TPU_DISABLE_GROUP_FUSION"] = fuse
            metrics.reset("collective.")
            outs = hvd.grouped_allreduce(group, op=hvd.Average, prescale_factor=0.5)
            for i, o in enumerate(outs):
                save(f"grouped_{tag}_{i}", o)
            res[f"grouped_{tag}_calls"] = np.array([
                metrics.get_counter("collective.grouped_allreduce.dispatches"),
                metrics.get_counter("collective.allreduce.dispatches")])
            ys = [t.clone() for t in group]
            got = hvd.grouped_allreduce_(ys, op=hvd.Average, prescale_factor=0.5)
            assert all(a is b for a, b in zip(got, ys))
            for i, o in enumerate(ys):
                save(f"grouped_inplace_{tag}_{i}", o)
        os.environ.pop("HVD_TPU_DISABLE_GROUP_FUSION")
        xv = own("v")
        save("allgather_v", hvd.allgather_v(xv))
        save("allgather_v_int32", hvd.allgather_v(xv.to(torch.int32)))
        xu = own("u")
        out_u, recv = hvd.alltoall(xu, splits=data["splits"][rank].tolist())
        save("a2a_uneven", out_u)
        save("a2a_uneven_recv", recv)
        for kind in ("random", "random_bf16"):
            x = mine("x_" + kind, "bfloat16" if kind.endswith("bf16") else "float32")
            save(f"ar_sum_{kind}", hvd.allreduce(x, op=hvd.Sum))
            save(f"ar_avg_{kind}", hvd.allreduce(x))
        x = mine("x_float32", "float32")
        save("join_average", collectives.join_average(x, rank != 1))
        save("join_average_none", collectives.join_average(x, False))
        save("join_average_int32", collectives.join_average(mine("x_int32", "int32"),
                                                            rank != 1))
        # NaN in rank 0's row: what Min and Max make of it.
        xn = mine("x_nan")
        save("ar_min_nan", hvd.allreduce(xn, op=hvd.Min))
        save("ar_max_nan", hvd.allreduce(xn, op=hvd.Max))

        # The async forms.
        x = mine("x_float32", "float32")
        h = hvd.allreduce_async(x, op=hvd.Sum, name="a")
        while not hvd.poll(h):
            time.sleep(0.001)
        save("async_ar", hvd.synchronize(h))
        assert hvd.synchronize(h) is hvd.synchronize(h)
        y = mine("x_bfloat16", "bfloat16")
        h = hvd.allreduce_async_(y, op=hvd.Average, prescale_factor=0.5,
                                 postscale_factor=3.0)
        assert hvd.synchronize(h) is y
        save("async_ar_inplace", y)
        ys = [t.clone() for t in group]
        h = hvd.grouped_allreduce_async_(ys, op=hvd.Average, prescale_factor=0.5)
        assert all(a is b for a, b in zip(hvd.synchronize(h), ys))
        for i, o in enumerate(ys):
            save(f"async_grouped_{i}", o)
        for i, o in enumerate(hvd.synchronize(hvd.grouped_allreduce_async(
                group, op=hvd.Average, prescale_factor=0.5))):
            save(f"async_grouped_out_{i}", o)
        save("async_allgather", hvd.synchronize(hvd.allgather_async(x)))
        y = x.clone()
        assert hvd.synchronize(hvd.broadcast_async_(y, 1)) is y
        save("async_broadcast_inplace", y)
        save("async_broadcast", hvd.synchronize(hvd.broadcast_async(x, 1)))
        save("async_rs", hvd.synchronize(hvd.reducescatter_async(x, op=hvd.Average)))
        save("async_a2a", hvd.synchronize(hvd.alltoall_async(x)))
        out_u, recv = hvd.synchronize(hvd.alltoall_async(
            xu, splits=torch.tensor(data["splits"][rank])))
        save("async_a2a_uneven", out_u)
        save("async_a2a_uneven_recv", recv)

        # Gradients: every rank weighs its output by its own dyadic w.
        w = mine("w_float32", "float32")
        x = mine("x_float32", "float32").requires_grad_()
        y = hvd.allreduce(x, op=hvd.Average, prescale_factor=0.5, postscale_factor=3.0)
        (y * w).sum().backward()
        save("grad_allreduce", x.grad)
        x.grad = None
        ys = hvd.grouped_allreduce([x, 2 * x], op=hvd.Sum)
        (ys[0] * w + ys[1] * w * w).sum().backward()
        save("grad_grouped", x.grad)
        x.grad = None
        (hvd.allgather(x) * mine("wg_float32", "float32")).sum().backward()
        save("grad_allgather", x.grad)
        x.grad = None
        (hvd.broadcast(x, 1) * w).sum().backward()
        save("grad_broadcast", x.grad)
        x.grad = None
        (hvd.alltoall(x) * w).sum().backward()
        save("grad_alltoall", x.grad)
        xu = own("u").requires_grad_()
        out_u, recv = hvd.alltoall(xu, splits=data["splits"][rank].tolist())
        assert not recv.requires_grad
        (out_u * own("wu")).sum().backward()
        save("grad_alltoall_uneven", xu.grad)
        y = x.detach().clone().requires_grad_()
        z = y * 1.0
        hvd.allreduce_(z, op=hvd.Sum)
        save("allreduce_inplace_grad_value", z)

        hvd.barrier()
        if rank == SLEEPER:
            time.sleep(0.2)
        res["join"] = np.array(hvd.join())

        # Errors: a dim 0 the world does not divide; a shape mismatch
        # under the consistency check, on every rank; a host wait under
        # a (faked) capture.
        odd = torch.ones(n + 1, 2)
        res["err_rs"] = np.array(raises(ValueError, lambda: hvd.reducescatter(odd)))
        res["err_a2a"] = np.array(raises(ValueError, lambda: hvd.alltoall(odd)))
        os.environ["HVD_TPU_CONSISTENCY_CHECK"] = "1"
        save("checked", hvd.allreduce(torch.ones(3), op=hvd.Sum, name="ok"))
        res["err_check"] = np.array(raises(
            HorovodTpuError, lambda: hvd.allreduce(torch.ones(rank + 1), name="t")))
        capturing, runtime.capturing = runtime.capturing, lambda: True
        res["err_check_capture"] = np.array(raises(
            RuntimeError, lambda: hvd.allreduce(torch.ones(3))))
        os.environ.pop("HVD_TPU_CONSISTENCY_CHECK")
        save("captured_ar", hvd.allreduce(torch.ones(3), op=hvd.Sum))
        runtime.capturing = capturing
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""").replace("SLEEPER", str(SLEEPER))


def _data(n):
    """Every world's inputs, stacked one row per rank, from seed n."""
    rng = np.random.default_rng(n)
    dyadic = lambda *s: (rng.integers(-8, 9, (n,) + s) / 4).astype(np.float32)  # noqa: E731
    d = {"x_float32": dyadic(6, 4), "x_bfloat16": dyadic(6, 4),
         "x_int32": rng.integers(-50, 51, (n, 6, 4)).astype(np.int32),
         "y_float32": dyadic(5), "w_float32": dyadic(6, 4),
         "wg_float32": dyadic(6 * n, 4)}
    d["x_random"] = (rng.standard_normal((n, 6, 4))
                     * 10.0 ** rng.integers(-2, 3, (n, 6, 4))).astype(np.float32)
    d["x_random_bf16"] = np.asarray(jnp.asarray(d["x_random"][::-1].copy())
                                    .astype(jnp.bfloat16).astype(jnp.float32))
    d["x_nan"] = dyadic(4)
    d["x_nan"][0, :2] = np.nan
    # Ragged rows for allgather_v; rank r sends splits[r][j] rows to j.
    for r in range(n):
        d[f"v_{r}"] = dyadic(r + 1, 3)[0]
    splits = rng.integers(0, 4, (n, n))
    splits[0, 1] = 0
    d["splits"] = splits
    for r in range(n):
        d[f"u_{r}"] = dyadic(int(splits[r].sum()), 2)[0]
        d[f"wu_{r}"] = dyadic(int(splits[:, r].sum()), 2)[0]
    return d


def _run_world(tmp, n):
    data = _data(n)
    np.savez(tmp / "data.npz", **data)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_CONSISTENCY_CHECK",
              "HVD_TPU_DISABLE_GROUP_FUSION"):
        env.pop(k, None)
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(n), str(tmp / "store"),
                 str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return data, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]


def _np(a):
    """A JAX result as numpy, bf16 widened to float32 (exactly)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _jax_in(data, key, dt=None):
    x = jnp.asarray(data[key])
    return x.astype(dt) if dt else x


def _traced(fn, *xs):
    """``fn`` of each rank's rows under ``shard_map`` on the JAX world."""
    spec = P(WORLD_AXIS)
    f = shard_map(lambda *vs: fn(*[v[0] for v in vs])[None], mesh=get_runtime().mesh,
                  in_specs=(spec,) * len(xs), out_specs=spec, check_vma=False)
    return _np(jax.jit(f)(*xs))


def _jax_world(n, data):
    """The JAX package's results on the same inputs, stacked by rank."""
    want = {}
    for dt in DTYPES:
        x = _jax_in(data, "x_" + dt, dt)
        for name, op in OPS.items():
            want[f"ar_{name}_{dt}"] = _np(je.allreduce(x, op=op))
        want["ar_scaled_" + dt] = _np(je.allreduce(x, op=je.Average, prescale_factor=0.5,
                                                   postscale_factor=3.0))
        want["allgather_" + dt] = _np(je.allgather(x))
        want["broadcast_" + dt] = _np(je.broadcast(x, 1))
        want["rs_sum_" + dt] = _np(je.reducescatter(x))
        want["rs_avg_" + dt] = _np(je.reducescatter(x, op=je.Average))
        want["rs_scaled_" + dt] = _traced(lambda v: traced.reducescatter(
            v, op=je.Average, prescale_factor=0.5, postscale_factor=3.0), x)
        want["a2a_" + dt] = _np(je.alltoall(x))
        want["ar_inplace_" + dt] = want[f"ar_max_{dt}"]
        want["broadcast_inplace_" + dt] = want["broadcast_" + dt]
    group = [_jax_in(data, "x_float32"), _jax_in(data, "x_bfloat16", jnp.bfloat16),
             _jax_in(data, "x_int32"), _jax_in(data, "y_float32")]
    for i, o in enumerate(je.grouped_allreduce(group, op=je.Average, prescale_factor=0.5)):
        for tag in ("fused", "unfused", "inplace_fused", "inplace_unfused"):
            want[f"grouped_{tag}_{i}"] = _np(o)
        want[f"async_grouped_{i}"] = want[f"async_grouped_out_{i}"] = _np(o)
    v = je.allgather_v([jnp.asarray(data[f"v_{r}"]) for r in range(n)])
    want["allgather_v"] = np.stack([_np(v)] * n)
    want["allgather_v_int32"] = want["allgather_v"].astype(np.int32)
    want["a2a_uneven"], want["a2a_uneven_recv"] = _uneven_alltoall(data, n)
    for kind in ("random", "random_bf16"):
        x = _jax_in(data, "x_" + kind, jnp.bfloat16 if kind.endswith("bf16") else None)
        want["ar_sum_" + kind] = _np(je.allreduce(x, op=je.Sum))
        want["ar_avg_" + kind] = _np(je.allreduce(x))
    active = jnp.asarray(np.arange(n) != 1)
    x = _jax_in(data, "x_float32")
    want["join_average"] = _traced(traced.join_average, x, active)
    want["join_average_none"] = _traced(traced.join_average, x, active & False)
    want["join_average_int32"] = _traced(traced.join_average, _jax_in(data, "x_int32"),
                                         active)
    xn = _jax_in(data, "x_nan")
    want["ar_min_nan"] = _np(je.allreduce(xn, op=je.Min))
    want["ar_max_nan"] = _np(je.allreduce(xn, op=je.Max))
    x = _jax_in(data, "x_float32")
    want["async_ar"] = _np(je.allreduce(x, op=je.Sum))
    want["async_ar_inplace"] = want["ar_scaled_bfloat16"]
    want["async_allgather"] = want["allgather_float32"]
    want["async_broadcast"] = want["async_broadcast_inplace"] = want["broadcast_float32"]
    want["async_rs"] = want["rs_avg_float32"]
    want["async_a2a"] = want["a2a_float32"]
    want["async_a2a_uneven"] = want["a2a_uneven"]
    want["async_a2a_uneven_recv"] = want["a2a_uneven_recv"]
    # The gradient rules of the JAX package's bridges, on the weights.
    w = data["w_float32"]
    want["grad_allreduce"] = _np(_grads.allreduce_grad(
        w, je.Average, prescale_factor=0.5, postscale_factor=3.0))
    want["grad_grouped"] = (_np(_grads.allreduce_grad(w, je.Sum))
                            + 2 * _np(_grads.allreduce_grad(w * w, je.Sum)))
    want["grad_allgather"] = _np(_grads.allgather_grad(data["wg_float32"]))
    want["grad_broadcast"] = _np(_grads.broadcast_grad(w, 1))
    want["grad_alltoall"] = _np(_grads.alltoall_grad(w))
    want["grad_alltoall_uneven"] = _uneven_alltoall_grad(data, n)
    return want


def _uneven_alltoall(data, n):
    """The JAX uneven alltoall on the stacked ranks' rows (equal row
    counts: each rank's rows padded with zeros to the largest), its
    padding removed: rank r's output and received splits."""
    splits = data["splits"]
    rows = max(int(s.sum()) for s in splits)
    x = np.zeros((n, rows, 2), np.float32)
    for r in range(n):
        x[r, :splits[r].sum()] = data[f"u_{r}"]
    # The JAX op takes one (n, n) matrix whose rows sum to the row count:
    # each rank's padding rows go at the end of its last chunk.
    padded = splits.copy()
    padded[:, -1] += rows - splits.sum(1)
    out, recv = je.alltoall(jnp.asarray(x), splits=padded)
    out, recv = _np(out), _np(recv).copy()
    recv[n - 1] -= rows - splits.sum(1)  # the padding, received by rank n-1
    chunk = int(padded.max())
    got = []
    for r in range(n):
        got.append(np.concatenate([out[r, j * chunk:j * chunk + splits[j, r]]
                                   for j in range(n)]))
    return got, list(recv)


def _uneven_alltoall_grad(data, n):
    """``_grads.alltoall_grad`` of each rank's weights, placed as the JAX
    forward's padded output lays them out; rank r's rows of it."""
    splits = data["splits"]
    rows = max(int(s.sum()) for s in splits)
    padded = splits.copy()
    padded[:, -1] += rows - splits.sum(1)
    chunk = int(padded.max())
    dy = np.zeros((n, n * chunk, 2), np.float32)
    for r in range(n):
        off = 0
        for j in range(n):
            c = int(splits[j, r])
            dy[r, j * chunk:j * chunk + c] = data[f"wu_{r}"][off:off + c]
            off += c
    g = _np(_grads.alltoall_grad(dy, splits=padded))
    return [g[r, :splits[r].sum()] for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's gloo worlds of 2 and 3, each run once, beside the JAX
    package's results on ``jax.devices()[:n]``."""
    out = {}
    for n in (2, 3):
        data, ranks = _run_world(tmp_path_factory.mktemp(f"world{n}"), n)
        hvd.shutdown()
        hvd.init(devices=jax.devices()[:n])
        try:
            out[n] = (data, ranks, _jax_world(n, data))
        finally:
            hvd.shutdown()
    return out


def _bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.astype(np.float32).view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


BITWISE = (
    [f"ar_{name}_{dt}" for name in OPS for dt in DTYPES]
    + [f"{k}_{dt}" for k in ("ar_scaled", "allgather", "broadcast", "rs_sum", "rs_avg",
                             "rs_scaled", "a2a", "ar_inplace", "broadcast_inplace")
       for dt in DTYPES]
    + [f"grouped_{tag}_{i}" for tag in ("fused", "unfused", "inplace_fused",
                                        "inplace_unfused") for i in range(4)]
    + ["allgather_v", "allgather_v_int32", "a2a_uneven", "a2a_uneven_recv",
       "join_average", "join_average_none", "join_average_int32"]
    + ["async_ar", "async_ar_inplace", "async_allgather", "async_broadcast",
       "async_broadcast_inplace", "async_rs", "async_a2a", "async_a2a_uneven",
       "async_a2a_uneven_recv"]
    + [f"async_grouped_{i}" for i in range(4)] + [f"async_grouped_out_{i}" for i in range(4)]
    + ["grad_allreduce", "grad_grouped", "grad_allgather", "grad_broadcast",
       "grad_alltoall", "grad_alltoall_uneven"]
)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("key", BITWISE)
def test_rank_r_is_row_r_of_the_jax_op_bitwise(worlds, key, n):
    data, ranks, want = worlds[n]
    for r, got in enumerate(ranks):
        _bitwise(got[key], want[key][r], f"{key}, rank {r} of {n}")


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("op", ["sum", "avg"])
@pytest.mark.parametrize("kind", ["random", "random_bf16"])
def test_random_sums_agree_to_two_roundings(worlds, kind, op, n):
    """gloo and XLA add the terms in other orders (module docstring)."""
    data, ranks, want = worlds[n]
    x = data["x_" + kind]
    eps = 2.0 ** -24 if kind == "random" else 2.0 ** -8
    bound = 2 * eps * np.abs(x).sum(0) / (n if op == "avg" else 1)
    for r, got in enumerate(ranks):
        err = np.abs(got[f"ar_{op}_{kind}"] - want[f"ar_{op}_{kind}"][r])
        assert (err <= bound).all(), (r, err.max())


@pytest.mark.parametrize("n", [2, 3])
def test_min_and_max_with_nan_diverge_from_jax(worlds, n):
    """A standing divergence (ROADMAP Queue C): with NaN in rank 0's
    row, XLA:CPU's ``lax.pmin``/``pmax`` return the other ranks' minimum
    or maximum there, while gloo's MIN and MAX propagate the NaN to
    every rank.  The finite columns agree bitwise."""
    data, ranks, want = worlds[n]
    x = data["x_nan"]
    for key, fn in (("ar_min_nan", np.min), ("ar_max_nan", np.max)):
        for r, got in enumerate(ranks):
            _bitwise(got[key][2:], want[key][r][2:], f"{key}, rank {r} of {n}")
            assert np.isnan(got[key][:2]).all()
            np.testing.assert_array_equal(want[key][r][:2], fn(x[1:, :2], axis=0))


@pytest.mark.parametrize("n", [2, 3])
def test_barrier_join_counters_and_errors_in_the_world(worlds, n):
    data, ranks, _ = worlds[n]
    for r, got in enumerate(ranks):
        assert int(got["join"]) == SLEEPER, r
        # One allreduce of 96 bytes; one grouped call of 96 + 8 bytes.
        np.testing.assert_array_equal(got["counters"], [1, 96, 1, 104])
        # Fused: one grouped call (one collective per dtype); unfused:
        # one allreduce per tensor, in order.
        np.testing.assert_array_equal(got["grouped_fused_calls"], [1, 0])
        np.testing.assert_array_equal(got["grouped_unfused_calls"], [0, 4])
        assert "must be divisible by set size" in str(got["err_rs"])
        assert "must be divisible by set size" in str(got["err_a2a"])
        np.testing.assert_array_equal(got["checked"], [n, n, n])
        # The mismatch is found by rank 0 and raised on every rank.
        assert str(got["err_check"]).startswith("collective consistency check failed")
        assert "cannot run while a CUDA graph is captured" in str(got["err_check_capture"])
        np.testing.assert_array_equal(got["captured_ar"], [n, n, n])
        np.testing.assert_array_equal(got["allreduce_inplace_grad_value"],
                                      data["x_float32"].sum(0))


def test_errors_at_world_one():
    """A ``process_set`` that is not a registered ``ProcessSet`` raises
    ``HorovodTpuError`` (the JAX package's ``_ps_id``), and ``average``
    with ``op`` a ``ValueError``, as the JAX eager API does.  Adasum,
    which raised before it was ported, returns a world of one's input
    (``tests/test_torch_adasum.py`` holds it at worlds three and four)."""
    thvd.init("cpu")
    try:
        x = torch.ones(4)
        for fn in (thvd.allreduce, thvd.allgather, thvd.allgather_v, thvd.broadcast,
                   thvd.reducescatter, thvd.alltoall, thvd.allreduce_async,
                   thvd.grouped_allreduce):
            arg = [x] if fn is thvd.grouped_allreduce else x
            for bad in (object(), thvd.ProcessSet([0])):
                with pytest.raises(thvd.exceptions.HorovodTpuError):
                    fn(arg, process_set=bad)
        with pytest.raises(thvd.exceptions.HorovodTpuError, match="not registered"):
            thvd.barrier(process_set=thvd.ProcessSet([0]))
        assert torch.equal(thvd.allreduce(x, op=thvd.Adasum), x)
        assert torch.equal(thvd.grouped_allreduce([x], op=thvd.Adasum)[0], x)
        with pytest.raises(ValueError, match="either average or op"):
            thvd.allreduce(x, average=True, op=thvd.Sum)
        with pytest.raises(ValueError, match="either average or op"):
            je.allreduce(np.ones((8, 1), np.float32), average=True, op=je.Sum)
        with pytest.raises(ValueError, match="SUM/AVERAGE"):
            thvd.reducescatter(x, op=thvd.Max)
        with pytest.raises(thvd.exceptions.HorovodTpuError, match="sum to its row count"):
            thvd.alltoall(x, splits=[3])
    finally:
        thvd.shutdown()


def test_host_waits_refuse_under_capture(monkeypatch):
    """Under a capture (faked) an async op, ``synchronize``, ``poll``,
    ``barrier``, ``join``, ``allgather_v`` and an uneven ``alltoall``
    raise through ``runtime.refuse_in_capture``; a synchronous op runs."""
    thvd.init("cpu")
    try:
        x = torch.arange(4.0)
        handle = thvd.allreduce_async(x)
        monkeypatch.setattr(thvd.runtime, "capturing", lambda: True)
        for fn in (lambda: thvd.allreduce_async(x), lambda: thvd.allreduce_async_(x),
                   lambda: thvd.grouped_allreduce_async([x]),
                   lambda: thvd.grouped_allreduce_async_([x]),
                   lambda: thvd.allgather_async(x), lambda: thvd.broadcast_async(x),
                   lambda: thvd.broadcast_async_(x), lambda: thvd.reducescatter_async(x),
                   lambda: thvd.alltoall_async(x), lambda: thvd.synchronize(handle),
                   lambda: thvd.poll(handle), thvd.barrier, thvd.join,
                   lambda: thvd.allgather_v(x), lambda: thvd.alltoall(x, splits=[4])):
            with pytest.raises(RuntimeError, match="cannot run while a CUDA graph"):
                fn()
        assert torch.equal(thvd.allreduce(x, op=thvd.Sum), x)
        assert torch.equal(thvd.alltoall(x), x)
        monkeypatch.undo()
        assert torch.equal(thvd.synchronize(handle), x)
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("unit", [None, 64, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_pad_to_atomic_unit_matches_jax(dtype, unit):
    from horovod_tpu.ops import fusion as jfusion

    for n in (1, 127, 128, 300):
        flat = np.arange(1, n + 1, dtype=np.float32)
        got, m = tfusion.pad_to_atomic_unit(
            torch.from_numpy(flat).to(getattr(torch, dtype)), unit)
        want, k = jfusion.pad_to_atomic_unit(jnp.asarray(flat).astype(dtype), unit)
        assert m == k == n
        np.testing.assert_array_equal(got.float().numpy(), _np(want).astype(np.float32))
