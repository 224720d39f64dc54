"""The hybrid-parallel GPT path of the port against the JAX package's.

* ``gpt_tiny`` (float32) trained for three AdamW steps (lr 1e-3, betas
  0.9 / 0.95, weight decay 0.1: ``examples/gpt_pretrain.py``'s
  optimizer) in one gloo world of four processes on three meshes:
  ``dp2 x tp2`` with flash attention, ``sp2 x tp2`` with ring attention
  and ``sp4`` with Ulysses (flash inside, at 4 / 4 = 1 head over the
  whole sequence).  Each rank loads the full-width flax weights through
  ``load_jax_params`` (its tp shard) and runs
  ``utils.benchmarks.build_hybrid_lm_step``: its block of the batch
  (rows over dp, positions over sp), ``sync_gradients`` with
  ``param_shard_axes``, the update, the loss averaged over the mesh.
  The JAX side runs the same three steps under ``shard_map`` on
  ``jax.devices()[:4]``, with the weights in the stacked-shard form of
  ``tests/test_grad_sync.py`` (a tp-sharded leaf is stacked
  ``[tp, ...]`` and sharded ``P("tp")``: qkv's kernel reshaped
  ``[D, 3, tp, H/tp, hd]`` and moved tp first, ``wi`` by columns,
  ``proj`` and ``wo`` by rows).
  - The first loss agrees to rtol 2e-6 (the same forward, float32 sums
    in another order; measured 8.6e-8); the later ones to rtol 2e-5
    (they see the updated weights).
  - Every rank's parameters equal the JAX shard of its tp coordinate
    (replicated leaves: the JAX device-0 copy) to 5e-5 absolute, lr/20
    (measured 1.4e-5): Adam moves an element by about lr·m/√v, which
    float32 rounding of its gradient (relative ~1e-6, far more where the
    gradient is small against its rounding) changes by up to a few 1e-6
    per step.  The key columns of the qkv bias have an
    exact gradient of 0 (a constant added to every key of a query's row
    leaves its softmax unchanged), so either package steps them by
    rounding noise, which Adam scales to a step of up to ~lr in any
    direction: they agree to ``2·3·1.004·lr`` plus the decay (measured
    2.5e-4).
  - Replicated parameters are bitwise equal on every rank, and each tp
    shard bitwise equal across its dp and sp replicas.
* ``pack_batches`` bitwise with the JAX package's.
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
from horovod_tpu.data.packing import pack_batches as jax_pack_batches
from horovod_tpu.models.transformer import gpt_tiny as jax_gpt_tiny
from horovod_tpu.models.transformer import param_shard_axes as jax_shard_axes
from horovod_tpu.models.transformer import token_cross_entropy as jax_ce
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import sync_gradients as jax_sync
from horovod_tpu_torch.data.packing import pack_batches
from horovod_tpu_torch.models import transformer as tt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LR, STEPS, B, T = 4, 1e-3, 3, 4, 32
MESHES = {"dp2_tp2": ({"dp": 2, "tp": 2}, "flash"),
          "sp2_tp2": ({"sp": 2, "tp": 2}, "ring"),
          "sp4": ({"sp": 4}, "ulysses")}
W_TOL = 5e-5
KBIAS_TOL = 2 * 3 * LR * (1.004 + 0.1 * LR)

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh
    from horovod_tpu_torch.utils.benchmarks import build_hybrid_lm_step

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    MESHES = MESHES_LITERAL
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60)
    try:
        data = dict(np.load(out + "/data.npz"))
        full = {k[2:]: v for k, v in data.items() if k.startswith("p/")}
        res = {}
        for kind, (deg, impl) in MESHES.items():
            mesh = make_mesh(**deg)
            try:
                model = tt.load_jax_params(
                    tt.gpt_tiny(device="cpu", mesh=mesh, attn_impl=impl), full)
                step, _ = build_hybrid_lm_step(model, mesh, lr=LR)
                b = data["tokens"].shape[1] // mesh.axis_size("dp")
                t = data["tokens"].shape[2] // mesh.axis_size("sp")
                rows = slice(mesh.axis_index("dp") * b, (mesh.axis_index("dp") + 1) * b)
                cols = slice(mesh.axis_index("sp") * t, (mesh.axis_index("sp") + 1) * t)
                losses = []
                for toks, tgts in zip(data["tokens"], data["targets"]):
                    losses.append(float(step(torch.from_numpy(toks[rows, cols]).long(),
                                             torch.from_numpy(tgts[rows, cols]).long())))
                res[kind + "|losses"] = np.array(losses)
                for name, p in model.named_parameters():
                    res[kind + "|" + name] = p.detach().numpy()
                res[kind + "|coords"] = np.array([mesh.axis_index(a)
                                                  for a in ("dp", "sp", "tp")])
            finally:
                mesh.shutdown()
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""").replace("MESHES_LITERAL", repr(MESHES)).replace("LR", repr(LR))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _stacked(name, arr, tp, cfg):
    """The JAX stacked-shard form of a tp-sharded leaf: ``[tp, ...]``."""
    h, hd = cfg.num_heads, cfg.head_dim
    if ".qkv." in name:
        lead = arr.shape[:-1]
        x = arr.reshape(lead + (3, tp, h // tp, hd))
        x = np.moveaxis(x, len(lead) + 1, 0)
        return x.reshape((tp,) + lead + (3 * (h // tp) * hd,))
    if ".wi." in name:
        lead = arr.shape[:-1]
        return np.moveaxis(arr.reshape(lead + (tp, -1)), len(lead), 0)
    return arr.reshape((tp, -1) + arr.shape[1:])  # proj / wo kernels: rows


def _data():
    rng = np.random.default_rng(31)
    seq = rng.integers(0, 256, (STEPS, B, T + 1)).astype(np.int32)
    return seq[:, :, :T], seq[:, :, 1:]


def _jax_run(params, toks, tgts, kind):
    deg, impl = MESHES[kind]
    mesh = jax_make_mesh(devices=jax.devices()[:N], **deg)
    jm = jax_gpt_tiny(attn_impl=impl)
    cfg = jm.cfg
    tp = deg.get("tp", 1)
    axes = {"params": jax_shard_axes(params["params"], cfg)}
    flat_axes = _flat(axes["params"])
    flat = _flat(params["params"])
    stacked = {n: (_stacked(n, v, tp, cfg) if flat_axes[n] and tp > 1 else v)
               for n, v in flat.items()}
    sharded = {n: bool(flat_axes[n]) and tp > 1 for n in flat}
    p_spec = {"params": _unflat({n: P("tp") if s else P() for n, s in sharded.items()})}
    tok_spec = P(None, "dp" if deg.get("dp", 1) > 1 else None,
                 "sp" if deg.get("sp", 1) > 1 else None)
    tx = optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1)
    loss_axes = tuple(a for a in ("dp", "sp", "tp") if a in mesh.axis_names)

    def run(p, toks, tgts):
        p = jax.tree.map(lambda x, s: x[0] if s else x, p,
                         {"params": _unflat(sharded)})
        opt_state = tx.init(p)

        def one(carry, batch):
            p, opt_state = carry

            def loss_fn(q):
                logits, aux = jm.apply(q, batch[0])
                return jax_ce(logits, batch[1]) + 0.01 * aux

            loss, g = jax.value_and_grad(loss_fn)(p)
            g = jax_sync(g, axes)
            upd, opt_state = tx.update(g, opt_state, p)
            return (optax.apply_updates(p, upd), opt_state), jax.lax.pmean(loss, loss_axes)

        (p, _), losses = jax.lax.scan(one, (p, opt_state), (toks, tgts))
        p = jax.tree.map(lambda x, s: x[None] if s else x, p,
                         {"params": _unflat(sharded)})
        return p, losses

    f = jax.jit(shard_map(run, mesh=mesh, in_specs=(p_spec, tok_spec, tok_spec),
                          out_specs=(p_spec, P()), check_vma=False))
    p, losses = f({"params": _unflat({n: jnp.asarray(v) for n, v in stacked.items()})},
                  jnp.asarray(toks), jnp.asarray(tgts))
    return np.asarray(losses), {n: np.asarray(v) for n, v in _flat(p["params"]).items()}


def _run_world(tmp):
    toks, tgts = _data()
    params = jax.tree.map(np.array, jax.jit(jax_gpt_tiny().init)(
        jax.random.PRNGKey(3), jnp.zeros((1, T), jnp.int32)))
    flat = _flat(params["params"])
    np.savez(tmp / "data.npz", tokens=toks, targets=tgts,
             **{f"p/{n}": v for n, v in flat.items()})
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_SCHED_WIRE", "HVD_TPU_SCHED",
              "HVD_TPU_TOPO_LOWER", "HVD_TPU_XIR_WIRE"):
        env.pop(k, None)
    procs = []
    try:
        for r in range(N):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(N), str(tmp / "store"), str(tmp)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        # The JAX side runs while the ranks do.
        want = {kind: _jax_run(params, toks, tgts, kind) for kind in MESHES}
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
    return flat, ranks, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's gloo world of four and the JAX runs, computed once: under
    xdist by the first worker that needs them (a file under the session's
    shared temporary root, behind a lock), loaded by the others."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_gpt_hybrid_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        hvd.shutdown()
        result = _run_world(tmp_path_factory.mktemp("hybrid"))
        with open(path, "wb") as f:
            pickle.dump(result, f)
    return result


@pytest.mark.parametrize("kind", list(MESHES))
def test_losses_match_jax(world, kind):
    _, ranks, want = world
    want_losses = want[kind][0]
    for got in ranks:
        losses = got[kind + "|losses"]
        np.testing.assert_allclose(losses[0], want_losses[0], rtol=2e-6)
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5)


def _sharded(name, kind):
    """Whether the parameter ``name`` is a tp shard on the mesh ``kind``."""
    cfg = jax_gpt_tiny().cfg
    return (MESHES[kind][0].get("tp", 1) > 1
            and tt.param_shard_axes([name], cfg)[name] == cfg.tp_axis)


@pytest.mark.parametrize("kind", list(MESHES))
def test_updated_weights_match_jax_shard_for_shard(world, kind):
    start, ranks, want = world
    tp = MESHES[kind][0].get("tp", 1)
    cfg = jax_gpt_tiny().cfg
    for got in ranks:
        r = int(got[kind + "|coords"][2])
        for name, w in want[kind][1].items():
            s = start[name]
            if _sharded(name, kind):
                w, s = w[r], _stacked(name, s, tp, cfg)[r]
            g = got[kind + "|" + name]
            assert g.shape == w.shape, (name, g.shape, w.shape)
            tol = np.full(w.shape, W_TOL, np.float32)
            if name.endswith("qkv.Dense_0.bias"):
                tol.reshape(3, -1)[1] = KBIAS_TOL  # the key columns
            np.testing.assert_array_less(np.abs(g - w), tol, err_msg=f"{kind} {name}")
            assert not np.array_equal(g, s), name  # every parameter moved


@pytest.mark.parametrize("kind", list(MESHES))
def test_replicas_are_bitwise_equal(world, kind):
    """Replicated parameters on every rank, each tp shard across its dp
    and sp replicas."""
    start, ranks, _ = world
    for name in start:
        held = {}
        for got in ranks:
            key = int(got[kind + "|coords"][2]) if _sharded(name, kind) else 0
            held.setdefault(key, []).append(got[kind + "|" + name])
        for arrs in held.values():
            for a in arrs[1:]:
                np.testing.assert_array_equal(a, arrs[0], err_msg=f"{kind} {name}")


@pytest.mark.parametrize("seq_len,batch,drop", [(16, 3, True), (40, 2, False), (8, 5, True)])
def test_pack_batches_bitwise_with_jax(seq_len, batch, drop):
    rng = np.random.default_rng(seq_len)
    docs = [rng.integers(1, 100, rng.integers(1, 3 * seq_len)).astype(np.int32)
            for _ in range(37)]
    got = list(pack_batches(iter(docs), seq_len, batch, drop_remainder=drop))
    want = list(jax_pack_batches(iter(docs), seq_len, batch, drop_remainder=drop))
    assert len(got) == len(want) > 0
    for (gt, gs), (wt, ws) in zip(got, want):
        assert gt.dtype == wt.dtype and gs.dtype == ws.dtype
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)
