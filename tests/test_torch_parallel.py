"""The port's mesh, tensor-parallel layers, ring and Ulysses attention and
``sync_gradients`` against the JAX package's.

* The mesh, in this process: ``make_mesh`` over a world of n ranks
  against ``horovod_tpu.parallel.make_mesh`` over ``jax.devices()[:n]``
  (the axes, the shape, each rank's coordinates where the JAX mesh
  places device n, and each set of axes' groups: the device ids that
  share the other coordinates), its errors with their messages, and
  ``split_axis``.
* One gloo world of four processes (``FileStore``), against the JAX
  functions under ``shard_map`` on ``jax.devices()[:4]`` (computed while
  the ranks run), rank r against device r:
  - ``TensorParallelMLP`` at tp 4: the output and the gradients of the
    input and of every shard, to 2e-6 relative to the largest element
    (float32 products and sums in another order; measured 1.4e-6 on the
    input's gradient).  The gradient of the replicated input is
    each rank's own (the row layer's sum has the sum as its backward),
    as JAX's is under ``check_vma=False``.
  - ``ring_attention`` at sp 4, causal and not (and causal with each hop
    staged through host buffers, as gloo on a card runs it), and
    ``ulysses_attention`` at sp 4 with full attention and with flash
    attention inside: the output and the gradients of q, k and v, to
    2e-6 absolute (the online softmax's sums in another order; measured
    1.1e-6).
  - ``sync_gradients`` on ``tests/test_grad_sync.py``'s
    ``TestRule2x2Mesh`` inputs (``dp2 x tp2``, replicated, tp-sharded
    and mixed leaves), plain and scheduled: bitwise (small integers:
    every sum is exact, and the means divide by powers of two).  Then
    multiples of 1/8 in [-2, 2], 1100 elements a leaf, scheduled, on the
    bf16 wire (bitwise: every partial sum is exact in bf16) and on int8 with
    error feedback (the tp-sharded leaf's mean is over dp alone and goes
    on the quantized wire; the others stay dense): result and residual
    to 5e-7 of Σ|q·s| (ROADMAP Queue C's FMA divergence; measured: the
    results equal, residuals 6e-8 apart).
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
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import split_axis as jax_split_axis
from horovod_tpu.parallel import sync_gradients as jax_sync
from horovod_tpu.parallel.ring_attention import full_attention as jax_full
from horovod_tpu.parallel.ring_attention import ring_attention as jax_ring
from horovod_tpu.parallel.tensor import TensorParallelMLP as JaxMLP
from horovod_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from horovod_tpu.sched import execute as jexec
from horovod_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
BLOCK = 512


# ------------------------------------------------------------ the mesh


def _jax_groups(jm, axes):
    """Device ids sharing every coordinate outside ``axes``, sorted."""
    names = jm.axis_names
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    inside = [i for i, a in enumerate(names) if a in axes]
    outside = [i for i, a in enumerate(names) if a not in axes]
    moved = np.transpose(ids, outside + inside)
    width = int(np.prod([ids.shape[i] for i in inside])) if inside else 1
    return sorted(sorted(int(x) for x in row) for row in moved.reshape(-1, width))


@pytest.mark.parametrize("n,degrees,keep", [
    (4, {"dp": 2, "tp": 2}, False), (4, {"sp": 4}, False), (8, {"dp": 2, "sp": 2, "tp": 2}, False),
    (8, {"dp": -1, "tp": 2}, False), (4, {"pp": 1, "dp": 4}, False), (4, {"tp": 4}, True),
    (8, {"sp": 2, "ep": 2, "dp": 2}, False), (1, {}, False),
])
def test_make_mesh_matches_jax(n, degrees, keep):
    jm = jax_make_mesh(devices=jax.devices()[:n], keep_unit_axes=keep, **degrees)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(n):
        m = tmesh.Mesh(*tmesh.mesh_layout(n, keep_unit_axes=keep, **degrees), r)
        assert m.axis_names == tuple(jm.axis_names)
        assert m.shape == dict(jm.shape)
        where = np.argwhere(ids == r)[0]
        assert m.coords == {a: int(c) for a, c in zip(jm.axis_names, where)}
        for k in range(1, len(m.axis_names) + 1):
            for axes in __import__("itertools").combinations(m.axis_names, k):
                assert sorted(m.tiles(axes)) == _jax_groups(jm, axes)
                assert r in m.ranks(axes) and len(m.ranks(axes)) == m.group_size(axes)


@pytest.mark.parametrize("n,degrees", [
    (4, {"dp": -1, "tp": -1}), (4, {"dp": 2, "tp": 4}), (6, {"dp": -1, "tp": 4}),
])
def test_make_mesh_errors_match_jax(n, degrees):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(devices=jax.devices()[:n], **degrees)
    with pytest.raises(ValueError) as got:
        tmesh.mesh_layout(n, **degrees)
    assert str(got.value) == str(want.value)


def test_split_axis_and_config_match_jax():
    jm = jax_split_axis(jax_make_mesh(devices=jax.devices()[:8], dp=4, tp=2), "dp", 2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        m = tmesh.split_axis(tmesh.Mesh(*tmesh.mesh_layout(8, dp=4, tp=2), r), "dp", 2)
        assert m.axis_names == tuple(jm.axis_names) == ("dp_dcn", "dp_ici", "tp")
        assert m.coords == {a: int(c) for a, c in zip(jm.axis_names, np.argwhere(ids == r)[0])}
    m = tmesh.Mesh(*tmesh.mesh_layout(4, dp=4), 0)
    for bad in (("tp", 2), ("dp", 3)):
        with pytest.raises(ValueError) as want:
            jax_split_axis(jax_make_mesh(devices=jax.devices()[:4], dp=4), *bad)
        with pytest.raises(ValueError) as got:
            tmesh.split_axis(m, *bad)
        assert str(got.value) == str(want.value)
    assert tmesh.sub_axis_names("sp") == ("sp_dcn", "sp_ici")
    assert tmesh.ParallelConfig(dp=2, tp=4).axes() == ["dp", "tp"]
    with pytest.raises(ValueError, match="either a ParallelConfig"):
        tmesh.mesh_layout(4, tmesh.ParallelConfig(dp=4), dp=4)


def test_a_mesh_without_groups_refuses_a_collective():
    m = tmesh.Mesh(*tmesh.mesh_layout(4, dp=2, tp=2), 1)
    assert m.group(("dp", "tp")) is None  # the world: the default group
    assert m.group("sp") is None  # an axis the mesh lacks: one rank
    with pytest.raises(RuntimeError, match="holds no process group"):
        m.group("tp")


# ------------------------------------------------------------ the world of four

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash
    from horovod_tpu_torch.parallel import (TensorParallelMLP, full_attention,
                                            make_mesh, ring_attention,
                                            sync_gradients, ulysses_attention)

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60)
    data = dict(np.load(out + "/data.npz"))
    res = {}

    def t(key):
        return torch.from_numpy(data[key].copy())

    try:
        mesh = make_mesh(tp=4)
        mlp = TensorParallelMLP(8, 16, 8, mesh=mesh)
        with torch.no_grad():
            for name, p in mlp.named_parameters():
                p.copy_(t("mlp/" + name)[rank] if name.endswith(("Dense_0.kernel",))
                        or name == "wi.Dense_0.bias" else t("mlp/" + name))
        x = t("mlp_x").requires_grad_()
        y = mlp(x)
        (y * t("mlp_w")).sum().backward()
        res["mlp|y"] = y.detach().numpy()
        res["mlp|dx"] = x.grad.numpy()
        for name, p in mlp.named_parameters():
            res["mlp|d" + name] = p.grad.numpy()
        mesh.shutdown()

        mesh = make_mesh(sp=4)
        ring_mod = sys.modules["horovod_tpu_torch.parallel.ring_attention"]
        staged = ring_mod._staged
        for kind in ("ring_causal", "ring", "ring_staged", "ulysses_full", "ulysses_flash"):
            q, k, v = (t("attn_" + c)[rank].requires_grad_() for c in "qkv")
            causal = kind != "ring"
            if kind.startswith("ring"):
                # ring_staged: each hop through host copies, as gloo on a card takes it
                ring_mod._staged = (lambda x, g: True) if kind == "ring_staged" else staged
                o = ring_attention(q, k, v, mesh, causal=causal)
            else:
                fn = full_attention if kind == "ulysses_full" else flash.flash_attention
                o = ulysses_attention(q, k, v, mesh, causal=causal, attn_fn=fn)
            (o * t("attn_w")[rank]).sum().backward()
            res[kind + "|o"] = o.detach().numpy()
            for c, z in zip("qkv", (q, k, v)):
                res[kind + "|d" + c] = z.grad.numpy()
        mesh.shutdown()

        mesh = make_mesh(dp=2, tp=2)
        axes = {"rep": "", "tp": "tp", "mix": ""}
        xb = t("rule_x")[rank]
        g = {"rep": xb, "tp": xb * 2.0, "mix": xb + 1.0}
        for sched in (False, True):
            for k, v in sync_gradients(g, axes, mesh, axes=("dp", "tp"),
                                       scheduled=sched).items():
                res[f"rule|{int(sched)}|{k}"] = v.numpy()
        big = {k: t("big_" + k)[rank] for k in axes}
        for wire in ("bf16", "int8"):
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            os.environ["HVD_TPU_QUANT_BLOCK"] = str(BLOCK_LITERAL)
            resid = {k: t("big_r_" + k)[rank] for k in axes}
            out_g, out_r = sync_gradients(big, axes, mesh, axes=("dp", "tp"),
                                          scheduled=True, residuals=resid)
            for k in axes:
                res[f"{wire}|{k}"] = out_g[k].numpy()
                res[f"{wire}|r|{k}"] = out_r[k].numpy()
        os.environ.pop("HVD_TPU_SCHED_WIRE")
        from horovod_tpu_torch import runtime
        res["wire_groups_made"] = np.array(len(runtime.get_runtime().wire_groups))
        mesh.shutdown()
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""").replace("BLOCK_LITERAL", str(BLOCK))


def _data():
    rng = np.random.default_rng(44)
    d = {"mlp_x": rng.standard_normal((2, 3, 8)).astype(np.float32),
         "mlp_w": rng.standard_normal((2, 3, 8)).astype(np.float32)}
    wi = (rng.standard_normal((8, 16)) * 0.3).astype(np.float32)
    wo = (rng.standard_normal((16, 8)) * 0.3).astype(np.float32)
    d["mlp/wi.Dense_0.kernel"] = wi.reshape(8, N, 4).transpose(1, 0, 2)  # [tp, in, out/tp]
    d["mlp/wi.Dense_0.bias"] = (rng.standard_normal((N, 4)) * 0.1).astype(np.float32)
    d["mlp/wo.Dense_0.kernel"] = wo.reshape(N, 4, 8)  # [tp, in/tp, out]
    d["mlp/wo.bias"] = (rng.standard_normal(8) * 0.1).astype(np.float32)
    for c in "qkv":  # [rank, B, T_local, H, D]
        d["attn_" + c] = rng.standard_normal((N, 2, 8, 4, 16)).astype(np.float32)
    d["attn_w"] = rng.standard_normal((N, 2, 8, 4, 16)).astype(np.float32)
    x = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    d["rule_x"] = np.stack([x[2 * (r // 2):2 * (r // 2) + 2, 2 * (r % 2):2 * (r % 2) + 2]
                            for r in range(N)])
    for k in ("rep", "tp", "mix"):
        d["big_" + k] = (rng.integers(-16, 17, (N, 1100)) / 8).astype(np.float32)
        d["big_r_" + k] = (rng.integers(-8, 9, (N, 1100)) / 256).astype(np.float32)
    return d


def _per_device(fn, mesh, in_specs):
    """``fn`` under ``shard_map`` with every output stacked per device."""
    def body(*xs):
        return jax.tree.map(lambda y: y[None], fn(*xs))
    names = tuple(mesh.axis_names)
    return jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                             out_specs=P(names), check_vma=False))


def _jax_world(d, monkeypatch):
    want = {}
    devs = jax.devices()[:N]
    mesh = jax_make_mesh(devices=devs, tp=4)
    mlp = JaxMLP(16, 8)

    def mlp_fn(wi, bi, wo, bo, x, w):
        p = {"params": {"wi": {"Dense_0": {"kernel": wi[0], "bias": bi[0]}},
                        "wo": {"Dense_0": {"kernel": wo[0]}, "bias": bo}}}

        def loss(p, x):
            y = mlp.apply(p, x)
            return jnp.sum(y * w), y
        (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)
        gp = gp["params"]
        return {"y": y, "dx": gx, "dwi.Dense_0.kernel": gp["wi"]["Dense_0"]["kernel"],
                "dwi.Dense_0.bias": gp["wi"]["Dense_0"]["bias"],
                "dwo.Dense_0.kernel": gp["wo"]["Dense_0"]["kernel"],
                "dwo.bias": gp["wo"]["bias"]}

    out = _per_device(mlp_fn, mesh, (P("tp"), P("tp"), P("tp"), P(), P(), P()))(
        d["mlp/wi.Dense_0.kernel"], d["mlp/wi.Dense_0.bias"], d["mlp/wo.Dense_0.kernel"],
        d["mlp/wo.bias"], d["mlp_x"], d["mlp_w"])
    want.update({"mlp|" + k: np.asarray(v) for k, v in out.items()})

    mesh = jax_make_mesh(devices=devs, sp=4)
    for kind in ("ring_causal", "ring", "ulysses_full", "ulysses_flash"):
        causal = kind != "ring"

        def attn(q, k, v, w, kind=kind, causal=causal):
            def loss(q, k, v):
                if kind.startswith("ring"):
                    o = jax_ring(q[0], k[0], v[0], causal=causal)
                else:
                    fn = jax_full if kind == "ulysses_full" else jax_flash
                    o = jax_ulysses(q[0], k[0], v[0], causal=causal, attn_fn=fn)
                return jnp.sum(o * w[0]), o
            (_, o), (gq, gk, gv) = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
            return {"o": o, "dq": gq[0], "dk": gk[0], "dv": gv[0]}

        out = _per_device(attn, mesh, (P("sp"),) * 4)(
            d["attn_q"], d["attn_k"], d["attn_v"], d["attn_w"])
        want.update({f"{kind}|{k}": np.asarray(v) for k, v in out.items()})

    mesh = jax_make_mesh(devices=devs, dp=2, tp=2)
    axes = {"rep": "", "tp": "tp", "mix": ""}
    spec = P(("dp", "tp"))
    for sched in (False, True):
        def rule(x, sched=sched):
            g = {"rep": x[0], "tp": x[0] * 2.0, "mix": x[0] + 1.0}
            return jax_sync(g, axes, axes=("dp", "tp"), scheduled=sched)
        out = _per_device(rule, mesh, (spec,))(d["rule_x"])
        want.update({f"rule|{int(sched)}|{k}": np.asarray(v) for k, v in out.items()})
    monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", str(BLOCK))
    for wire in ("bf16", "int8"):
        monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)

        def wired(rep, tp, mix, rr, rt, rm):
            g = {"rep": rep[0], "tp": tp[0], "mix": mix[0]}
            r = {"rep": rr[0], "tp": rt[0], "mix": rm[0]}
            synced, res = jexec.sync_gradients_bucketed(g, axes, ("dp", "tp"), residuals=r)
            return {"g": synced, "r": res}
        out = _per_device(wired, mesh, (spec,) * 6)(
            *(d["big_" + k] for k in axes), *(d["big_r_" + k] for k in axes))
        for k in axes:
            want[f"{wire}|{k}"] = np.asarray(out["g"][k])
            want[f"{wire}|r|{k}"] = np.asarray(out["r"][k])
    return want


def _run_world(tmp):
    d = _data()
    np.savez(tmp / "data.npz", **d)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_SCHED_WIRE", "HVD_TPU_SCHED",
              "HVD_TPU_QUANT_BLOCK", "HVD_TPU_QUANT_BACKEND", "HVD_TPU_TOPO_LOWER",
              "HVD_TPU_XIR_WIRE", "HVD_TPU_SCHED_WIRE_EF"):
        env.pop(k, None)
    procs = []
    mp = pytest.MonkeyPatch()
    try:
        for r in range(N):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(N), str(tmp / "store"), str(tmp)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        hvd.shutdown()
        want = _jax_world(d, mp)  # while the ranks run
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        mp.undo()
        hvd.shutdown()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return d, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)], want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Computed once: under xdist by the first worker that needs it (a
    file under the session's shared temporary root, behind a lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_parallel_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        result = _run_world(tmp_path_factory.mktemp("parallel"))
        with open(path, "wb") as f:
            pickle.dump(result, f)
    return result


@pytest.mark.parametrize("key", ["y", "dx", "dwi.Dense_0.kernel", "dwi.Dense_0.bias",
                                 "dwo.Dense_0.kernel", "dwo.bias"])
def test_tensor_parallel_mlp_and_its_gradients_match_jax(world, key):
    _, ranks, want = world
    for r, got in enumerate(ranks):
        w = want["mlp|" + key][r]
        np.testing.assert_allclose(got["mlp|" + key], w, rtol=2e-6,
                                   atol=2e-6 * np.abs(w).max())


@pytest.mark.parametrize("kind", ["ring_causal", "ring", "ring_staged", "ulysses_full",
                                  "ulysses_flash"])
@pytest.mark.parametrize("key", ["o", "dq", "dk", "dv"])
def test_sequence_parallel_attention_matches_jax(world, kind, key):
    """``ring_staged`` is the causal ring with every hop staged through
    host buffers (gloo on a card), held against the same JAX ring."""
    _, ranks, want = world
    ref = "ring_causal" if kind == "ring_staged" else kind
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{kind}|{key}"], want[f"{ref}|{key}"][r],
                                   rtol=0, atol=2e-6)


@pytest.mark.parametrize("sched", [0, 1])
@pytest.mark.parametrize("leaf", ["rep", "tp", "mix"])
def test_sync_gradients_rule_is_bitwise_with_jax(world, sched, leaf):
    _, ranks, want = world
    for r, got in enumerate(ranks):
        g, w = got[f"rule|{sched}|{leaf}"], want[f"rule|{sched}|{leaf}"][r]
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("leaf", ["rep", "tp", "mix"])
def test_sync_gradients_bf16_wire_is_bitwise_with_jax(world, leaf):
    _, ranks, want = world
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"bf16|{leaf}"], want[f"bf16|{leaf}"][r])
        np.testing.assert_array_equal(got[f"bf16|r|{leaf}"], want[f"bf16|r|{leaf}"][r])


@pytest.mark.parametrize("leaf", ["rep", "tp", "mix"])
def test_sync_gradients_int8_wire_matches_jax(world, leaf):
    d, ranks, want = world
    for r, got in enumerate(ranks):
        for key in (f"int8|{leaf}", f"int8|r|{leaf}"):
            w = want[key][r]
            # 5e-7 of sum |q s| over the ranks summed, bounded by their |x|.
            bound = 5e-7 * N * (np.abs(d["big_" + leaf]).max() + 1) * 2
            np.testing.assert_allclose(got[key], w, rtol=0, atol=bound, err_msg=key)
    if leaf == "tp":  # the quantized wire moved it: not the dense mean
        dense = np.mean([d["big_tp"][r] + d["big_r_tp"][r] for r in (0, 2)], axis=0) / 2
        assert not np.array_equal(ranks[0]["int8|tp"], dense)
        assert np.abs(ranks[0]["int8|r|tp"]).max() > 0


def test_the_int8_wire_runs_on_the_mesh_groups(world):
    """``sync_gradients``' quantized buckets take the mesh's own groups
    (``grad_sync.wire_groups``): the runtime made no group of its own."""
    _, ranks, _ = world
    assert [int(got["wire_groups_made"]) for got in ranks] == [0] * N
