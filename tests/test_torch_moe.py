"""The port's mixture-of-experts layer, the GPT model's MoE blocks and the
shuffles' wire rule against the JAX package's.

* ``_top_k_gating`` for k = 1 and 2, with ties, with capacity overflow
  and without.  The JAX function's softmax is patched to return the
  port's gates, so every operation after it is compared: combine and
  dispatch bitwise, aux to rtol 1e-6 (a float32 mean over the tokens in
  another order).  Unpatched, dispatch is bitwise and combine agrees to
  2^-22 relative (XLA:CPU's and PyTorch's ``exp`` differ by an ulp).
* ``MoELayer`` at world one against flax's on the same weights: the
  output, aux and the gradients of the input, router, ``wi`` and ``wo``
  against ``jax.grad``, to 1e-6 of each tensor's largest element
  (float32 products in another order; measured 2.1e-7).
* ``gpt_tiny(moe_every=2)`` (float32) through ``load_jax_params``: its
  logits to 2e-6 absolute and its loss (cross-entropy plus
  ``0.01·aux``) to rtol 1e-6, as ``test_torch_transformer.py`` holds
  the dense model; ``param_shard_axes`` on the MoE names.
* One gloo world of four processes, against the JAX functions under
  ``shard_map`` on ``jax.devices()[:4]`` (computed while the ranks run):
  - the layer over ``ep4`` (two experts a rank, eight in all, capacity
    factor 1 so that tokens overflow): output, aux, and the gradients of
    the input, the router, ``wi`` and ``wo``, rank r against device r,
    to 1e-6 of each tensor's largest element (measured 4.1e-7);
  - ``load_jax_params`` cutting a full tree's ``[8, ...]`` expert
    weights to each rank's two;
  - the wire rule: each of ``HVD_TPU_XIR_WIRE`` ``off``, ``bf16``,
    ``int8`` and ``fp8`` on float32 and bf16 payloads through the
    Ulysses flip (``sp4``), the MoE all-to-alls (``ep4``) and the
    pipeline hop (``pp4``): bitwise with ``off`` where
    ``horovod_tpu.xir.ir.eligible_wire`` downgrades to ``off``, and
    ``NotImplementedError`` where it casts (``bf16`` on float32).
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
from horovod_tpu.models.transformer import gpt_tiny as jax_gpt_tiny
from horovod_tpu.models.transformer import param_shard_axes as jax_shard_axes
from horovod_tpu.models.transformer import token_cross_entropy as jax_ce
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import moe as jax_moe
from horovod_tpu.xir.ir import eligible_wire
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import moe as tmoe
from horovod_tpu_torch.parallel import wire as twire

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, T, D, E_LOCAL, HIDDEN = 4, 2, 8, 16, 2, 24
WIRES = ("off", "bf16", "int8", "fp8")


def _logits(seed, s, e):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((s, e)) * 2).astype(np.float32)
    lg[3] = lg[3, 0]  # a row of equal gates: the first expert wins
    lg[7, :2] = lg[7].max() + 1.0  # a tie for first place
    return lg


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("s,e,cap", [(64, 4, 8), (64, 4, 40), (33, 3, 5), (16, 1, 9)])
def test_top_k_gating_matches_jax(monkeypatch, k, s, e, cap):
    lg = _logits(s + e + cap, s, e)
    combine, dispatch, aux = tmoe._top_k_gating(torch.from_numpy(lg), k, cap)
    gates = jnp.asarray(torch.softmax(torch.from_numpy(lg), -1).numpy())
    monkeypatch.setattr(jax.nn, "softmax", lambda x, axis=-1: gates)
    jc, jd, ja = jax_moe._top_k_gating(jnp.asarray(lg), k, cap)
    monkeypatch.undo()
    np.testing.assert_array_equal(combine.numpy().view(np.uint32), np.asarray(jc).view(np.uint32))
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    if cap < s * k // e:
        assert int(dispatch.sum()) < s * k  # tokens were dropped
    jc, jd, _ = jax_moe._top_k_gating(jnp.asarray(lg), k, cap)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=2.0 ** -22, atol=0)


def _layer_data(seed, batch, e_total):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((batch, T, D)).astype(np.float32),
            "w": rng.standard_normal((batch, T, D)).astype(np.float32),
            "rk": (rng.standard_normal((D, e_total)) * 0.5).astype(np.float32),
            "rb": (rng.standard_normal(e_total) * 0.1).astype(np.float32),
            "wi": (rng.standard_normal((e_total, D, HIDDEN)) * 0.3).astype(np.float32),
            "wo": (rng.standard_normal((e_total, HIDDEN, D)) * 0.3).astype(np.float32)}


def _jax_layer_grads(layer, rk, rb, wi, wo, x, w):
    p = {"params": {"router": {"kernel": rk, "bias": rb}, "wi": wi, "wo": wo}}

    def loss(p, x):
        out, aux = layer.apply(p, x)
        return jnp.sum(out * w) + aux, (out, aux)
    (_, (out, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)
    gp = gp["params"]
    return {"out": out, "aux": aux, "dx": gx, "drouter.kernel": gp["router"]["kernel"],
            "drouter.bias": gp["router"]["bias"], "dwi": gp["wi"], "dwo": gp["wo"]}


def _torch_layer_grads(layer, d, x, w):
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(d[name].copy()))
    x = torch.from_numpy(x.copy()).requires_grad_()
    out, aux = layer(x)
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    res = {"out": out.detach().numpy(), "aux": aux.detach().numpy(), "dx": x.grad.numpy()}
    res.update({"d" + n: p.grad.numpy() for n, p in layer.named_parameters()})
    return res


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_moe_layer_matches_flax_at_world_one():
    d = _layer_data(3, B, E_LOCAL)
    want = _jax_layer_grads(jax_moe.MoELayer(num_experts_local=E_LOCAL, hidden=HIDDEN, k=2),
                            *(jnp.asarray(d[k]) for k in ("rk", "rb", "wi", "wo", "x", "w")))
    layer = tmoe.MoELayer(D, E_LOCAL, HIDDEN, k=2)
    got = _torch_layer_grads(layer, {"router.kernel": d["rk"], "router.bias": d["rb"],
                                     "wi": d["wi"], "wo": d["wo"]}, d["x"], d["w"])
    assert set(got) == set(want)
    for key in got:
        _close(got[key], want[key], key)


def _jax_init(model, t):
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, t), jnp.int32))


def test_gpt_tiny_moe_matches_jax():
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 256, (2, 25)).astype(np.int32)
    jm = jax_gpt_tiny(moe_every=2, num_experts_local=4)
    params = _jax_init(jm, 24)

    def jloss(p):
        logits, aux = jm.apply(p, jnp.asarray(toks[:, :-1]))
        return jax_ce(logits, jnp.asarray(toks[:, 1:])) + 0.01 * aux, logits
    (want_loss, want), _ = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = tt.load_jax_params(tt.gpt_tiny(device="cpu", moe_every=2, num_experts_local=4),
                               params)
    assert isinstance(model.block_1.moe, tmoe.MoELayer) and not hasattr(model.block_0, "moe")
    logits, aux = model(torch.from_numpy(toks[:, :-1]))
    loss = tt.token_cross_entropy(logits, torch.from_numpy(toks[:, 1:])) + 0.01 * aux
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=0, atol=2e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    assert aux.item() > 0


def test_param_shard_axes_on_moe_names():
    model = tt.gpt_tiny(device="cpu", moe_every=2, num_experts_local=2)
    names = dict(model.named_parameters())
    axes = tt.param_shard_axes(names, model.cfg)
    assert axes["block_1.moe.wi"] == axes["block_1.moe.wo"] == "ep"
    assert axes["block_1.moe.router.kernel"] == axes["block_1.moe.router.bias"] == ""
    assert names["block_1.moe.wi"].shape == (2, 64, 64)  # hidden = ff_dim / 2
    jm = jax_gpt_tiny(moe_every=2, num_experts_local=2)
    jaxes = jax_shard_axes(_jax_init(jm, 8), jm.cfg)
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            walk(name, v) if isinstance(v, dict) else flat.__setitem__(name, v)
    walk("", jaxes["params"])
    assert {n: (a or "") for n, a in flat.items()} == axes


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shuffle_wire_rule_matches_eligible_wire(monkeypatch, wire, dtype):
    monkeypatch.setenv("HVD_TPU_XIR_WIRE", wire)
    tdtype = getattr(torch, dtype)
    for op in ("all_to_all", "permute"):
        want = eligible_wire(op, wire, jnp.dtype(dtype))
        assert twire.shuffle_wire(tdtype) == want
    assert twire.shuffle_wire(torch.int32) == eligible_wire("all_to_all", wire, jnp.int32)
    monkeypatch.setenv("HVD_TPU_XIR", "0")  # the JAX package's direct lax path
    assert twire.shuffle_wire(tdtype) == "off"


# ------------------------------------------------------------ the world of four

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import (MoELayer, full_attention, make_mesh,
                                            pipeline_apply, ulysses_attention)

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60)
    data = dict(np.load(out + "/data.npz"))
    res = {}

    def t(key):
        return torch.from_numpy(data[key].copy())

    try:
        mesh = make_mesh(ep=4)
        E, H = E_LOCAL_LITERAL, HIDDEN_LITERAL
        layer = MoELayer(16, E, H, k=2, capacity_factor=1.0, mesh=mesh)
        rows = slice(2 * rank, 2 * rank + 2)
        experts = slice(E * rank, E * (rank + 1))
        with torch.no_grad():
            layer.router.kernel.copy_(t("rk"))
            layer.router.bias.copy_(t("rb"))
            layer.wi.copy_(t("wi")[experts])
            layer.wo.copy_(t("wo")[experts])
        x = t("x")[rows].requires_grad_()
        o, aux = layer(x)
        ((o * t("w")[rows]).sum() + aux).backward()
        res["moe|out"], res["moe|aux"], res["moe|dx"] = o.detach().numpy(), aux.detach().numpy(), x.grad.numpy()
        for name, p in layer.named_parameters():
            res["moe|d" + name] = p.grad.numpy()

        model = tt.gpt_tiny(device="cpu", mesh=mesh, moe_every=2, num_experts_local=E)
        full = {n: t("gpt/" + n) for n in dict(model.named_parameters())}
        tt.load_jax_params(model, full)
        res["gpt_wi"] = model.block_1.moe.wi.detach().numpy()
        res["gpt_router"] = model.block_1.moe.router.kernel.detach().numpy()

        meshes = {"ulysses": make_mesh(sp=4), "moe": mesh, "hop": make_mesh(pp=4)}
        for wire in ("off", "bf16", "int8", "fp8"):
            os.environ["HVD_TPU_XIR_WIRE"] = wire
            for dtype in (torch.float32, torch.bfloat16):
                for op, m in meshes.items():
                    key = f"wire|{op}|{wire}|{str(dtype)[6:]}"
                    try:
                        if op == "ulysses":
                            q, k, v = (t("u_" + c)[rank].to(dtype) for c in "qkv")
                            y = ulysses_attention(q, k, v, m, causal=True,
                                                  attn_fn=full_attention)
                        elif op == "moe":
                            y = layer(t("x")[rows].to(dtype))[0]
                        else:
                            w = t("hop_w")[rank].to(dtype)
                            y = pipeline_apply(lambda p, h: torch.tanh(h @ p), w,
                                               t("hop_x").to(dtype), m)
                        res[key] = y.detach().float().numpy()
                    except NotImplementedError as e:
                        res[key] = np.array("raised: " + str(e))
        os.environ.pop("HVD_TPU_XIR_WIRE")
        for m in meshes.values():
            m.shutdown()
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""").replace("E_LOCAL_LITERAL", str(E_LOCAL)).replace("HIDDEN_LITERAL", str(HIDDEN))


def _world_data():
    d = _layer_data(11, N * B, N * E_LOCAL)
    rng = np.random.default_rng(12)
    for c in "qkv":
        d["u_" + c] = rng.standard_normal((N, 1, 4, 4, 8)).astype(np.float32)
    d["hop_w"] = (rng.standard_normal((N, 8, 8)) * 0.4).astype(np.float32)
    d["hop_x"] = rng.standard_normal((3, 2, 8)).astype(np.float32)
    cfg = tt.gpt_tiny(device="cpu", moe_every=2, num_experts_local=E_LOCAL).cfg
    model = tt.Transformer(cfg, seed=1, device="cpu", experts_local=N * E_LOCAL)
    for n, p in model.named_parameters():
        d["gpt/" + n] = p.detach().numpy()
    return d


def _jax_world(d):
    devs = jax.devices()[:N]
    mesh = jax_make_mesh(devices=devs, ep=4)
    layer = jax_moe.MoELayer(num_experts_local=E_LOCAL, hidden=HIDDEN, k=2,
                             capacity_factor=1.0)

    def body(rk, rb, wi, wo, x, w):
        out = _jax_layer_grads(layer, rk, rb, wi, wo, x, w)
        out["aux"] = out["aux"][None]
        return jax.tree.map(lambda y: y[None], out)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(), P("ep"), P("ep"), P("ep"),
                                                     P("ep")),
                          out_specs=P("ep"), check_vma=False))
    out = f(*(jnp.asarray(d[k]) for k in ("rk", "rb", "wi", "wo", "x", "w")))
    return {k: np.asarray(v) for k, v in out.items()}


def _run_world(tmp):
    d = _world_data()
    np.savez(tmp / "data.npz", **d)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_XIR_WIRE", "HVD_TPU_XIR",
              "HVD_TPU_SCHED_WIRE"):
        env.pop(k, None)
    procs = []
    try:
        for r in range(N):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(N), str(tmp / "store"), str(tmp)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        hvd.shutdown()
        want = _jax_world(d)  # while the ranks run
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
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
    path = root / "torch_moe_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        result = _run_world(tmp_path_factory.mktemp("moe"))
        with open(path, "wb") as f:
            pickle.dump(result, f)
    return result


@pytest.mark.parametrize("key", ["out", "aux", "dx", "drouter.kernel", "drouter.bias",
                                 "dwi", "dwo"])
def test_moe_layer_over_ep4_matches_jax(world, key):
    _, ranks, want = world
    for r, got in enumerate(ranks):
        _close(got["moe|" + key], want[key][r], f"rank {r} {key}")


def test_load_jax_params_cuts_the_experts_over_ep(world):
    d, ranks, _ = world
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(
            got["gpt_wi"], d["gpt/block_1.moe.wi"][E_LOCAL * r:E_LOCAL * (r + 1)])
        np.testing.assert_array_equal(got["gpt_router"], d["gpt/block_1.moe.router.kernel"])


@pytest.mark.parametrize("op", ["ulysses", "moe", "hop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["bf16", "int8", "fp8"])
def test_each_wire_is_dense_or_raises_where_jax_casts(world, op, dtype, wire):
    _, ranks, _ = world
    casts = eligible_wire("all_to_all" if op != "hop" else "permute", wire,
                          jnp.dtype(dtype)) != "off"
    for r, got in enumerate(ranks):
        y = got[f"wire|{op}|{wire}|{dtype}"]
        if casts:
            assert str(y).startswith("raised") and "A12 (rest)" in str(y), (r, y)
        else:
            off = got[f"wire|{op}|off|{dtype}"]
            assert y.dtype == np.float32, (r, y)
            np.testing.assert_array_equal(y.view(np.uint32), off.view(np.uint32))
