"""The port's SyncBatchNorm, both forms, against their counterparts.

One gloo world of four, run once (the JAX side computed while it runs,
shared across xdist workers behind a ``filelock``), with the set {0,1}
registered; each rank its own batch (4 x 3 channels x 5 x 5) and its own
cotangent ``dy`` (the loss is Σ_r Σ y_r·dy_r):

* **The model form** (``FlaxSyncBatchNorm``, the norm of
  ``ResNet(sync_bn=True)``) against the JAX package's flax
  ``SyncBatchNorm`` in ``shard_map`` on four CPU devices: the output, the
  running ``mean`` and ``var`` (flax momentum 0.9, the biased variance),
  ``dx`` (through the Sum allreduce's transpose) and the ``scale`` and
  ``bias`` gradients; float32 over the world and over {0,1} (rank 2 and
  3 off the set use their own moments), and bf16.  And a tiny
  ``ResNet(sync_bn=True)`` (stages [1,1], 8 filters, 16x16, batch 2 a
  rank) carried across from the flax tree by ``load_jax_params`` (flax
  names its block norms ``SyncBatchNorm_<i>``): the training-mode
  logits, the running statistics and every parameter's gradient.
* **The public form** (``hvd.SyncBatchNorm``, ``horovod.torch``
  semantics) against ``horovod_tpu/interop/torch.py``'s
  ``SyncBatchNorm`` (run here in four threads whose cross-process sum is
  a barrier over the threads' vectors), and against
  ``torch.nn.BatchNorm2d`` on the concatenated global batch: the output,
  ``dx``, the (local) weight and bias gradients, the running statistics
  (PyTorch momentum 0.1 and the cumulative ``momentum=None``, the
  unbiased variance) over two training passes, then eval mode; also
  ``affine=False`` and the set {0,1}.

Tolerances (each relative to the largest element of the reference):
1e-5 in float32: the moments and the ``dy`` sums are float32 sums in
another order (gloo's ring against XLA's or numpy's), and XLA contracts
``E[x²] - E[x]²`` and ``-mean·mult + bias`` into FMAs (ROADMAP Queue C),
a few ulps of each; 2^-7 in bf16 (one bf16 rounding of the output, whose
multiply and add both round), but the bf16 ``scale`` and ``bias``
gradients, each a sum of the rank's 100 bf16 products of the cotangent
per channel, which the two packages accumulate at other precisions,
to 2^-7 of the sum of those products' magnitudes, Σ|dy|·(1 + |x̂|); the
ResNet to 1e-4 as
``tests/test_torch_resnet.py`` (convolutions summed in other orders),
its gradients to 1e-3 of each parameter gradient's norm.  A missing
reduction moves the statistics by O(1) of themselves.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.interop import _common as icommon
from horovod_tpu.interop import torch as itorch
from horovod_tpu.models.resnet import ResNet as JaxResNet
from horovod_tpu.runtime import WORLD_AXIS, get_runtime
from horovod_tpu.sync_batch_norm import SyncBatchNorm as JaxSyncBatchNorm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
TOL, TOL_BF16, RESNET_TOL, GRAD_TOL = 1e-5, 2.0 ** -7, 1e-4, 1e-3
SHAPE = (4, 3, 5, 5)  # per rank, NCHW

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.sync_batch_norm import FlaxSyncBatchNorm

    rank, n, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    s01 = hvd.ProcessSet([0, 1])
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=n, timeout_s=60,
             process_sets=[s01])
    data = dict(np.load(out + "/data.npz"))
    res = {}

    def save(key, t):
        res[key] = t.detach().float().numpy()

    try:
        for tag, dtype, ps in (("f32", torch.float32, None), ("bf16", torch.bfloat16, None),
                               ("set", torch.float32, s01)):
            m = FlaxSyncBatchNorm(3, dtype=dtype, process_set=ps)
            with torch.no_grad():
                m.scale.copy_(torch.from_numpy(data["scale"]))
                m.bias.copy_(torch.from_numpy(data["bias"]))
            x = torch.from_numpy(data["x"][rank]).to(dtype).requires_grad_()
            y = m(x)
            (y.float() * torch.from_numpy(data["dy"][rank])).sum().backward()
            for k, v in (("y", y), ("dx", x.grad), ("dscale", m.scale.grad),
                         ("dbias", m.bias.grad), ("mean", m.mean), ("var", m.var)):
                save(f"flax|{tag}|{k}", v)
        for tag in ("plain", "nomomentum", "noaffine", "set"):
            bn = hvd.SyncBatchNorm(3, momentum=None if tag == "nomomentum" else 0.1,
                                   affine=tag != "noaffine",
                                   process_set=s01 if tag == "set" else None)
            if bn.affine:
                with torch.no_grad():
                    bn.weight.copy_(torch.from_numpy(data["scale"]))
                    bn.bias.copy_(torch.from_numpy(data["bias"]))
            for p in range(2):
                x = torch.from_numpy(data["x"][rank] + p).requires_grad_()
                y = bn(x)
                (y * torch.from_numpy(data["dy"][rank])).sum().backward()
                save(f"public|{tag}|y{p}", y)
                save(f"public|{tag}|dx{p}", x.grad)
            if bn.affine:
                save(f"public|{tag}|dweight", bn.weight.grad)
                save(f"public|{tag}|dbias", bn.bias.grad)
            save(f"public|{tag}|running_mean", bn.running_mean)
            save(f"public|{tag}|running_var", bn.running_var)
            res[f"public|{tag}|tracked"] = bn.num_batches_tracked.numpy()
            bn.eval()
            save(f"public|{tag}|eval", bn(torch.from_numpy(data["x"][rank])))
        net = resnet.ResNet([1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
                            device="cpu", sync_bn=True)
        tree = np.load(out + "/resnet.npz", allow_pickle=True)
        net.load_state_dict(resnet.load_jax_params(tree["params"].item(),
                                                   tree["stats"].item()), strict=True)
        logits = net(torch.from_numpy(data["img"][rank]))
        (logits * torch.from_numpy(data["lw"][rank])).sum().backward()
        save("resnet|logits", logits)
        for name, v in net.state_dict().items():
            if name.endswith(".mean") or name.endswith(".var"):
                save(f"resnet|stat|{name}", v)
        for name, p in net.named_parameters():
            save(f"resnet|grad|{name}", p.grad)
        np.savez(out + f"/rank{rank}.npz", **res)
    finally:
        hvd.shutdown()
""")


def _data():
    rng = np.random.default_rng(8)
    return {
        "x": (1.5 * rng.standard_normal((N,) + SHAPE) + 0.5).astype(np.float32),
        "dy": rng.standard_normal((N,) + SHAPE).astype(np.float32),
        "scale": (1 + 0.2 * rng.standard_normal(3)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(3)).astype(np.float32),
        "img": rng.standard_normal((N, 2, 16, 16, 3)).astype(np.float32),
        "lw": rng.standard_normal((N, 2, 10)).astype(np.float32),
    }


def _resnet_jax():
    model = JaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                      dtype=jnp.float32, sync_bn=True)
    variables = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 16, 16, 3)))
    return model, variables


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _traced(fn, *xs):
    spec = P(WORLD_AXIS)
    f = shard_map(lambda *vs: jax.tree.map(lambda a: a[None], fn(*[v[0] for v in vs])),
                  mesh=get_runtime().mesh, in_specs=(spec,) * len(xs), out_specs=spec,
                  check_vma=False)
    return jax.tree.map(_np, jax.jit(f)(*xs))


def _jax_world(data, model, variables):
    want = {}
    s01 = hvd.ProcessSet([0, 1])
    hvd.init(devices=jax.devices()[:N], process_sets=[s01])
    nhwc = lambda a: jnp.asarray(a).transpose(0, 1, 3, 4, 2)  # noqa: E731
    for tag, dtype, ps in (("f32", jnp.float32, None), ("bf16", jnp.bfloat16, None),
                           ("set", jnp.float32, s01)):
        bn = JaxSyncBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                              dtype=dtype, process_set=ps)
        params = {"scale": jnp.asarray(data["scale"]), "bias": jnp.asarray(data["bias"])}
        stats = {"mean": jnp.zeros(3), "var": jnp.ones(3)}

        def body(x, dy, bn=bn, params=params, stats=stats, dtype=dtype):
            def f(p, x):
                y, upd = bn.apply({"params": p, "batch_stats": stats}, x.astype(dtype),
                                  mutable=["batch_stats"])
                return jnp.sum(y.astype(jnp.float32) * dy), (y, upd)
            (_, (y, upd)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
                params, x)
            return {"y": y, "dx": gx, "dscale": gp["scale"], "dbias": gp["bias"],
                    "mean": upd["batch_stats"]["mean"], "var": upd["batch_stats"]["var"]}

        got = _traced(body, nhwc(data["x"]), nhwc(data["dy"]))
        for k, v in got.items():
            want[f"flax|{tag}|{k}"] = v.transpose(0, 1, 4, 2, 3) if v.ndim == 5 else v

    def rbody(img, lw):
        def f(p):
            logits, upd = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                      img, train=True, mutable=["batch_stats"])
            return jnp.sum(logits * lw), (logits, upd)
        (_, (logits, upd)), g = jax.value_and_grad(f, has_aux=True)(variables["params"])
        return logits, upd["batch_stats"], g

    logits, stats, grads = _traced(rbody, jnp.asarray(data["img"]), jnp.asarray(data["lw"]))
    want["resnet|logits"] = logits
    want["resnet|stats"], want["resnet|grads"] = stats, grads
    return want


def _spawn(tmp):
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_TOPO", "HVD_TPU_ONESTEP"):
        env.pop(k, None)
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(N), str(tmp / "store"),
         str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(N)]


def _collect(procs, tmp):
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_sync_bn_world.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        tmp = tmp_path_factory.mktemp("syncbn")
        data = _data()
        np.savez(tmp / "data.npz", **data)
        model, variables = _resnet_jax()
        tree = jax.tree.map(np.asarray, variables)
        np.savez(tmp / "resnet.npz", params=np.array(tree["params"], dtype=object),
                 stats=np.array(tree["batch_stats"], dtype=object))
        procs = _spawn(tmp)
        hvd.shutdown()
        try:
            want = _jax_world(data, model, variables)
        finally:
            hvd.shutdown()
        ranks = _collect(procs, tmp)
        with open(path, "wb") as f:
            pickle.dump((data, ranks, want, tree), f)
    return data, ranks, want, tree


def _close(got, exp, tol, what):
    got, exp = np.asarray(got, np.float32), np.asarray(exp, np.float32)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    err = np.abs(got - exp).max()
    assert err <= tol * max(np.abs(exp).max(), 1e-30), (what, err)


@pytest.mark.parametrize("key", ["y", "dx", "dscale", "dbias", "mean", "var"])
@pytest.mark.parametrize("tag", ["f32", "bf16", "set"])
def test_model_form_matches_jax(world, tag, key):
    data, ranks, want, _ = world
    if tag == "bf16" and key in ("dscale", "dbias"):
        x = data["x"].astype(np.float64)
        xhat = (x - x.mean((0, 1, 3, 4), keepdims=True)) / x.std((0, 1, 3, 4), keepdims=True)
        for r in range(N):
            bound = 2.0 ** -7 * (np.abs(data["dy"][r]) * (1 + np.abs(xhat[r]))).sum((0, 2, 3))
            err = np.abs(ranks[r][f"flax|bf16|{key}"] - want[f"flax|bf16|{key}"][r])
            assert (err <= bound).all(), (key, r, err, bound)
        return
    tol = TOL_BF16 if tag == "bf16" else TOL
    for r in range(N):
        _close(ranks[r][f"flax|{tag}|{key}"], want[f"flax|{tag}|{key}"][r], tol,
               f"{tag} {key} rank {r}")


def test_model_form_off_the_set_uses_local_moments(world):
    """Ranks 2 and 3 are off {0,1}: their statistics are their own, not the
    world's; ranks 0 and 1 share theirs."""
    _, ranks, _, _ = world
    np.testing.assert_array_equal(ranks[0]["flax|set|mean"], ranks[1]["flax|set|mean"])
    assert not np.allclose(ranks[2]["flax|set|mean"], ranks[3]["flax|set|mean"])
    assert not np.allclose(ranks[2]["flax|set|mean"], ranks[2]["flax|f32|mean"])


def _rename(path):
    """The flax tree path of a port ResNet parameter or statistic."""
    parts = path.split(".")
    if parts[0] == "blocks":
        block, mod, leaf = f"BottleneckBlock_{parts[1]}", parts[2], parts[3]
        if mod.startswith("conv") and mod != "conv_proj":
            return (block, f"Conv_{mod[4]}", leaf)
        if mod.startswith("bn"):
            return (block, f"SyncBatchNorm_{mod[2]}", leaf)
        return (block, mod, leaf)
    if parts[0] == "fc":
        return ("Dense_0", parts[1])
    return tuple(parts)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def test_resnet_with_sync_bn_matches_jax(world):
    """Logits, every running statistic and every gradient (the port's conv
    kernels OIHW against flax's HWIO, the classifier (out, in) against
    (in, out); the gradient of ``weight``/``kernel``, ``scale``, ``bias``)."""
    _, ranks, want, tree = world
    assert any(k.startswith("SyncBatchNorm_") for k in tree["params"]["BottleneckBlock_0"])
    for r in range(N):
        rec = ranks[r]
        np.testing.assert_allclose(rec["resnet|logits"], want["resnet|logits"][r],
                                   rtol=RESNET_TOL, atol=RESNET_TOL)
        stats = [k for k in rec if k.startswith("resnet|stat|")]
        assert len(stats) == 2 * (1 + 2 * 4)  # bn_init; 3 per block and its norm_proj
        for key in stats:
            name = key.split("|")[2]
            np.testing.assert_allclose(rec[key], _leaf(want["resnet|stats"], _rename(name))[r],
                                       rtol=RESNET_TOL, atol=RESNET_TOL, err_msg=name)
        for key in (k for k in rec if k.startswith("resnet|grad|")):
            name = key.split("|")[2]
            path = _rename(name.replace(".weight", ".kernel"))
            g = _leaf(want["resnet|grads"], path)[r]
            if g.ndim == 4:
                g = g.transpose(3, 2, 0, 1)
            elif g.ndim == 2:
                g = g.T
            assert (np.linalg.norm(rec[key] - g) <= GRAD_TOL * np.linalg.norm(g)), name


# ------------------------------------------------------------ the public form


class _ThreadWorld:
    """Four threads standing for the ranks of
    ``horovod_tpu/interop/torch.py``'s SyncBatchNorm: its cross-process
    sum (``_common.process_reduce``) is a barrier over the threads'
    vectors, summed in rank order."""

    def __init__(self, n):
        self.n, self.local = n, threading.local()
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)

    def members(self, process_set):
        if process_set is None:
            return None, True
        return list(process_set.ranks), self.local.rank in process_set.ranks

    def reduce(self, arr, average, member_procs=None, op_sum=None):
        r = self.local.rank
        self.slots[r] = np.asarray(arr)
        self.barrier.wait()
        members = list(range(self.n)) if member_procs is None else member_procs
        out = self.slots[members[0]].copy()
        for m in members[1:]:
            out = out + self.slots[m]
        self.barrier.wait()
        return out


def _interop(monkeypatch, data, tag):
    """The interop SyncBatchNorm's record on each of four thread ranks."""
    w = _ThreadWorld(N)
    monkeypatch.setattr(icommon, "process_reduce", w.reduce)
    monkeypatch.setattr(icommon, "member_processes", w.members)
    monkeypatch.setattr(itorch, "_is_single_process", lambda: False)
    monkeypatch.setattr(itorch, "_SYNC_BN_CLS", None)
    monkeypatch.setattr(itorch, "_TorchSyncBatchNorm", None, raising=False)
    recs, errors = [None] * N, []

    def run(r):
        try:
            w.local.rank = r
            torch.set_num_threads(1)
            bn = itorch.SyncBatchNorm(3, momentum=None if tag == "nomomentum" else 0.1,
                                      affine=tag != "noaffine")
            rec = {}
            if bn.affine:
                with torch.no_grad():
                    bn.weight.copy_(torch.from_numpy(data["scale"]))
                    bn.bias.copy_(torch.from_numpy(data["bias"]))
            for p in range(2):
                x = torch.from_numpy(data["x"][r] + p).requires_grad_()
                y = bn(x)
                (y * torch.from_numpy(data["dy"][r])).sum().backward()
                rec[f"y{p}"], rec[f"dx{p}"] = y.detach().numpy(), x.grad.numpy()
            if bn.affine:
                rec["dweight"], rec["dbias"] = bn.weight.grad.numpy(), bn.bias.grad.numpy()
            rec["running_mean"] = bn.running_mean.numpy()
            rec["running_var"] = bn.running_var.numpy()
            rec["tracked"] = bn.num_batches_tracked.numpy()
            bn.eval()
            rec["eval"] = bn(torch.from_numpy(data["x"][r])).detach().numpy()
            recs[r] = rec
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            w.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return recs


@pytest.mark.parametrize("tag", ["plain", "nomomentum", "noaffine"])
def test_public_form_matches_the_interop_sync_batch_norm(world, monkeypatch, tag):
    data, ranks, _, _ = world
    recs = _interop(monkeypatch, data, tag)
    for r in range(N):
        for key, exp in recs[r].items():
            got = ranks[r][f"public|{tag}|{key}"]
            if key == "tracked":
                assert int(got) == int(exp) == 2
                continue
            _close(got, exp, TOL, f"{tag} {key} rank {r}")


@pytest.mark.parametrize("tag", ["plain", "nomomentum", "noaffine", "set"])
def test_public_form_matches_batch_norm_on_the_global_batch(world, tag):
    """``torch.nn.BatchNorm2d`` on the members' batches concatenated: the
    members' output and ``dx`` are their slices, the running statistics
    the same, the weight and bias gradients each rank's own share (their
    sum over the members is BatchNorm2d's)."""
    data, ranks, _, _ = world
    members = [0, 1] if tag == "set" else list(range(N))
    bn = torch.nn.BatchNorm2d(3, momentum=None if tag == "nomomentum" else 0.1,
                              affine=tag != "noaffine")
    if bn.affine:
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(data["scale"]))
            bn.bias.copy_(torch.from_numpy(data["bias"]))
    b = SHAPE[0]
    for p in range(2):
        x = torch.from_numpy(np.concatenate([data["x"][r] for r in members]) + p)
        x.requires_grad_()
        y = bn(x)
        (y * torch.from_numpy(np.concatenate([data["dy"][r] for r in members]))).sum().backward()
        for i, r in enumerate(members):
            sl = slice(i * b, (i + 1) * b)
            _close(ranks[r][f"public|{tag}|y{p}"], y[sl].detach().numpy(), TOL, f"y{p} {r}")
            _close(ranks[r][f"public|{tag}|dx{p}"], x.grad[sl].numpy(), TOL, f"dx{p} {r}")
    for r in members:
        for key in ("running_mean", "running_var"):
            _close(ranks[r][f"public|{tag}|{key}"], getattr(bn, key).numpy(), TOL, key)
    if bn.affine:
        for key, grad in (("dweight", bn.weight.grad), ("dbias", bn.bias.grad)):
            total = sum(ranks[r][f"public|{tag}|{key}"] for r in members)
            _close(total, grad.numpy(), TOL, key)
    bn.eval()
    for r in members:
        _close(ranks[r][f"public|{tag}|eval"], bn(torch.from_numpy(data["x"][r])).detach().numpy(),
               TOL, f"eval {r}")
    if tag == "set":  # off the set: BatchNorm on the rank's own batch
        for r in (2, 3):
            own = torch.nn.BatchNorm2d(3)
            with torch.no_grad():
                own.weight.copy_(torch.from_numpy(data["scale"]))
                own.bias.copy_(torch.from_numpy(data["bias"]))
            _close(ranks[r]["public|set|y0"], own(torch.from_numpy(data["x"][r])).detach().numpy(),
                   TOL, f"off the set {r}")


def test_public_form_is_plain_batch_norm_at_world_one():
    import horovod_tpu_torch as thvd

    x = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(0))
    thvd.init("cpu")
    try:
        bn, ref = thvd.SyncBatchNorm(3), torch.nn.BatchNorm1d(3)
        assert torch.equal(bn(x), ref(x))
        assert torch.equal(bn.running_var, ref.running_var)
        assert isinstance(bn, torch.nn.modules.batchnorm._BatchNorm)
    finally:
        thvd.shutdown()
    with pytest.raises(ValueError, match="at least 2D"):
        thvd.SyncBatchNorm(3)(torch.ones(3))
