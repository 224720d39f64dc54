"""The ported GPT slice against the JAX package's, on the CPU.

* Forward: ``gpt_tiny`` through ``load_jax_params`` against
  ``model.apply`` on the same tokens, dense and packed, flash and full
  attention.  float32: 2e-6 absolute on logits below 1 (measured 5e-7:
  the products and LayerNorm sums run in another order).  bfloat16:
  2^-6 absolute, four bf16 ulps at the logits' magnitude (measured
  0.0059, 1.5 ulps): XLA evaluates the bf16 gelu and bias adds one
  rounded operation at a time where PyTorch rounds once per operator,
  and each such rounding can flip an ulp that later layers carry.
* Packing: ``pack_documents`` bitwise with the JAX package's;
  ``packed_lm_batch`` bitwise with ``bench.py``'s construction.
* The ``bench_gpt`` step: three steps of ``build_lm_step`` on
  ``gpt_tiny`` (world of one, ``Compression.bf16``) against the JAX
  package's ``DistributedOptimizer(optax.adamw(3e-4), Compression.bf16)``
  and ``distributed_train_step``, dense and packed; and two steps of a
  gloo world of two against JAX at world two.  Losses to rtol 1e-6
  (measured 2e-7).  Weights: a float32 gradient element near a bf16
  rounding boundary may round to the other neighbour in the two
  packages, which moves Adam's ``m/√v`` by up to 2^-7 of itself, so
  each of three updates of at most ``lr`` may differ by ``lr·2^-7``:
  weights agree to ``3·lr·2^-7 + 1e-6`` (measured 3.1e-6).  Except the
  key columns of the qkv bias: adding a constant to every key of a
  query's row leaves its softmax unchanged, so their exact gradient is
  0 and what either package computes is rounding noise, which Adam
  scales to a step in any direction (measured 8.3e-5).  Each of Adam's
  first three updates is at most 1.004·lr in size whatever the
  gradients (Cauchy-Schwarz over the moments' weights at betas 0.9 /
  0.999), so these agree to ``2·3·1.004·lr`` plus weight decay: the
  two packages' steps may point opposite ways.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd
import horovod_tpu_torch as thvd
from horovod_tpu.data.packing import pack_documents as jax_pack
from horovod_tpu.models.transformer import gpt_tiny as jax_gpt_tiny
from horovod_tpu.models.transformer import packed_token_cross_entropy as jax_pce
from horovod_tpu.models.transformer import token_cross_entropy as jax_ce
from horovod_tpu_torch.data.packing import pack_documents, packing_efficiency
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel.tensor import ColumnParallelDense
from horovod_tpu_torch.utils.benchmarks import build_lm_step, packed_lm_batch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, T, VOCAB = 3e-4, 32, 256
W_TOL = 3 * LR * 2.0 ** -7 + 1e-6
KBIAS_TOL = 2 * 3 * LR * (1.004 + 1e-4)


def _tokens(b, t, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(np.int32)


def _packed(rows, t, seed):
    """Rows of several documents of 4..t-4 tokens each, with padding."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, VOCAB, rng.integers(4, t - 4)).astype(np.int32)
            for _ in range(3 * rows)]
    tok, seg = pack_documents(docs, t)
    assert tok.shape[0] >= rows and seg.max() > 1
    return tok[:rows], seg[:rows]


def _jax_init(model, t):
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, t), jnp.int32))
    return jax.tree.map(np.array, params)


@pytest.mark.parametrize("impl", ["flash", "full"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(impl, packed, dtype):
    jdt, tdt, atol = {"float32": (jnp.float32, torch.float32, 2e-6),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)}[dtype]
    t = 48
    if packed:
        toks, segs = _packed(2, t, seed=1)
    else:
        toks, segs = _tokens(2, t, seed=1), None
    jm = jax_gpt_tiny(attn_impl=impl, dtype=jdt)
    params = _jax_init(jm, t)
    args = (toks,) if segs is None else (toks, segs)
    want, want_aux = jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in args))
    model = tt.load_jax_params(tt.gpt_tiny(attn_impl=impl, dtype=tdt, device="cpu"),
                               params)
    with torch.no_grad():
        got, aux = model(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == (2, t, VOCAB)
    assert float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_load_jax_params_names_every_parameter():
    params = _jax_init(jax_gpt_tiny(), 16)
    model = tt.gpt_tiny(device="cpu")
    assert {n for n, _ in model.named_parameters()} >= {
        "wte.embedding", "wpe", "block_0.attn.qkv.Dense_0.kernel",
        "block_1.attn.proj.bias", "block_1.mlp.wo.Dense_0.kernel", "ln_f.scale"}
    tt.load_jax_params(model, params)
    np.testing.assert_array_equal(
        model.block_1.mlp.wi.Dense_0.kernel.detach().numpy(),
        params["params"]["block_1"]["mlp"]["wi"]["Dense_0"]["kernel"])
    del params["params"]["ln_f"]
    with pytest.raises(KeyError, match="ln_f"):
        tt.load_jax_params(model, params)


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 16, VOCAB)).astype(np.float32) * 3
    toks, segs = _packed(2, 16, seed=6)
    tgt = np.roll(toks, -1, axis=-1)
    np.testing.assert_allclose(
        float(tt.token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt))),
        float(jax_ce(jnp.asarray(logits), jnp.asarray(tgt))), rtol=1e-6)
    np.testing.assert_allclose(
        float(tt.packed_token_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(toks),
                                            torch.from_numpy(segs))),
        float(jax_pce(jnp.asarray(logits), jnp.asarray(toks), jnp.asarray(segs))),
        rtol=1e-6)


@pytest.mark.parametrize("kwargs,exc", [
    ({"attn_impl": "sparse"}, ValueError),
])
def test_unported_options_raise(kwargs, exc):
    with pytest.raises(exc, match="unknown attn_impl"):
        tt.gpt_tiny(device="cpu", **kwargs)


def _logits_and_grads(model, toks):
    model.zero_grad(set_to_none=True)
    logits, aux = model(torch.from_numpy(toks[:, :-1]))
    (tt.token_cross_entropy(logits, torch.from_numpy(toks[:, 1:])) + 0.01 * aux).backward()
    return logits.detach().numpy(), {n: p.grad.numpy().copy()
                                     for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl,moe", [("flash", 0), ("full", 0), ("flash", 2)])
def test_remat_is_bitwise_with_no_remat(impl, moe):
    """``remat=True`` recomputes each block in the backward: on the CPU
    the same operations on the same inputs, so the logits and every
    gradient are bitwise those of ``remat=False``."""
    toks = _tokens(2, 33, seed=9)
    got = [_logits_and_grads(tt.gpt_tiny(device="cpu", attn_impl=impl, moe_every=moe,
                                         remat=remat), toks) for remat in (False, True)]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    for name, g in got[0][1].items():
        np.testing.assert_array_equal(got[1][1][name], g, err_msg=name)


def test_remat_matches_the_jax_remat_model():
    """Against ``nn.remat(Block)`` through ``jax.grad``: the logits to 2e-6
    absolute (as the dense model's) and each gradient to 1e-5 of its
    largest element (float32 sums in another order over the backward)."""
    toks = _tokens(2, 33, seed=10)
    jm = jax_gpt_tiny(attn_impl="flash", remat=True)
    params = _jax_init(jm, 32)

    def loss(p):
        logits, aux = jm.apply(p, jnp.asarray(toks[:, :-1]))
        return jax_ce(logits, jnp.asarray(toks[:, 1:])) + 0.01 * aux, logits
    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = tt.load_jax_params(tt.gpt_tiny(device="cpu", attn_impl="flash", remat=True), params)
    logits, got = _logits_and_grads(model, toks)
    np.testing.assert_allclose(logits, np.asarray(want), rtol=0, atol=2e-6)
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            walk(name, v) if isinstance(v, dict) else flat.__setitem__(name, np.asarray(v))
    walk("", grads["params"])
    assert set(flat) == set(got)
    for name, g in got.items():
        w = flat[name]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_without_a_mesh_match_jax(impl):
    """Off a mesh ring and Ulysses lower to full attention, as in the JAX
    model; with packed rows they raise its ValueError."""
    toks, segs = _packed(2, 24, seed=2)
    jm = jax_gpt_tiny(attn_impl=impl)
    params = _jax_init(jm, 24)
    want, _ = jax.jit(jm.apply)(params, jnp.asarray(toks))
    model = tt.load_jax_params(tt.gpt_tiny(attn_impl=impl, device="cpu"), params)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="packed sequences"):
        jm.apply(params, jnp.asarray(toks), jnp.asarray(segs))
    with pytest.raises(ValueError, match="packed sequences"):
        model(torch.from_numpy(toks), torch.from_numpy(segs))


def test_tensor_parallel_degree_raises():
    """A tp degree that does not divide the heads or the features raises
    the JAX model's ValueError."""
    from horovod_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(("tp",), (3,), rank=0)
    with pytest.raises(ValueError, match="not divisible by 'tp' axis size 3"):
        ColumnParallelDense(8, 8, mesh=mesh)
    with pytest.raises(ValueError, match="num_heads 4 not divisible by tp degree 3"):
        tt.gpt_tiny(device="cpu", mesh=mesh)


def test_sequence_longer_than_max_len_raises():
    model = tt.gpt_tiny(device="cpu", max_len=16)
    with pytest.raises(ValueError, match="exceeds max_len"):
        model(torch.zeros(1, 17, dtype=torch.long))


@pytest.mark.parametrize("seq_len", [8, 50])
def test_pack_documents_bitwise_with_jax(seq_len):
    rng = np.random.default_rng(seq_len)
    docs = [rng.integers(0, 100, rng.integers(0, 3 * seq_len)).astype(np.int32)
            for _ in range(40)]
    got, want = pack_documents(docs, seq_len), jax_pack(docs, seq_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert packing_efficiency(got[1]) == float((want[1] > 0).mean())
    assert pack_documents([], seq_len)[0].shape == (0, seq_len)


def test_packed_lm_batch_is_bench_gpts_batch():
    """``bench.py`` ``bench_gpt``'s packed batch, written out with the JAX
    package's packer (``bench.py:174-186``), at a short row."""
    rows, seq_len, vocab = 6, 256, 50304
    rng = np.random.RandomState(3)
    docs, filled = [], 0
    while filled < rows + 2:
        ln = int(np.clip(rng.lognormal(5.8, 0.7), 32, seq_len))
        docs.append(rng.randint(0, vocab, ln).astype(np.int32))
        filled = sum(len(d) for d in docs) // seq_len
    want_t, want_s = jax_pack(docs, seq_len)
    got_t, got_s = packed_lm_batch(rows, seq_len, vocab)
    np.testing.assert_array_equal(got_t, want_t[:rows])
    np.testing.assert_array_equal(got_s, want_s[:rows])


def _batches(packed, b, steps):
    if packed:
        toks, segs = _packed(b * steps, T, seed=21)
        return [(toks[i * b:(i + 1) * b], segs[i * b:(i + 1) * b])
                for i in range(steps)]
    return [_tokens(b, T, seed=20 + i) for i in range(steps)]


def _run_jax(params, batches, packed, world):
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:world])
    try:
        jm = jax_gpt_tiny()

        if packed:
            def loss_fn(p, batch):
                toks, segs = batch
                logits, aux = jm.apply(p, toks, segs)
                return jax_pce(logits, toks, segs) + 0.01 * aux
        else:
            def loss_fn(p, toks):
                logits, aux = jm.apply(p, toks)
                return jax_ce(logits, jnp.roll(toks, -1, axis=-1)) + 0.01 * aux

        step = hvd.distributed_train_step(
            loss_fn, hvd.DistributedOptimizer(optax.adamw(LR),
                                              compression=hvd.Compression.bf16))
        params = jax.tree.map(jnp.asarray, params)  # the step donates
        opt_state = step.init(params)
        losses = []
        for batch in batches:
            jb = tuple(map(jnp.asarray, batch)) if packed else jnp.asarray(batch)
            params, opt_state, loss = step(params, opt_state, jb)
            losses.append(float(loss))
        return losses, jax.tree.map(np.array, params)
    finally:
        hvd.shutdown()


def _check_weights(got: dict, want_params, start_params):
    want = dict(tt.load_jax_params(tt.gpt_tiny(device="cpu"), want_params)
                .named_parameters())
    start = dict(tt.load_jax_params(tt.gpt_tiny(device="cpu"), start_params)
                 .named_parameters())
    for name, w in want.items():
        w = w.detach().numpy()
        g = np.asarray(got[name])
        assert not np.array_equal(w, start[name].detach().numpy()), name
        tol = np.full(w.shape, W_TOL, np.float32)
        if name.endswith("qkv.Dense_0.bias"):
            tol.reshape(3, -1)[1] = KBIAS_TOL  # the key columns
        np.testing.assert_array_less(np.abs(g - w), tol, err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
def test_world1_lm_step_matches_jax(packed):
    batches = _batches(packed, 2, 3)
    start = _jax_init(jax_gpt_tiny(), T)
    want_losses, want = _run_jax(start, batches, packed, world=1)
    thvd.init("cpu")
    try:
        model = tt.load_jax_params(tt.gpt_tiny(device="cpu"), start)
        step, opt = build_lm_step(thvd, model, packed=packed)
        assert isinstance(opt, torch.optim.AdamW)
        assert opt.defaults["weight_decay"] == 1e-4
        assert opt.defaults["betas"] == (0.9, 0.999)
        losses = [float(step(tuple(map(torch.from_numpy, b)) if packed
                             else torch.from_numpy(b))) for b in batches]
    finally:
        thvd.shutdown()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    _check_weights({n: p.detach().numpy() for n, p in model.named_parameters()},
                   want, start)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.utils.benchmarks import build_lm_step

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    hvd.init("cpu", init_method="file://" + store, rank=rank, size=2,
             timeout_s=100)
    try:
        data = np.load(out + "/data.npz")
        model = tt.gpt_tiny(device="cpu", seed=rank)  # rank 0's weights win
        if rank == 0:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(data["p/" + n]))
        step, _ = build_lm_step(hvd, model, packed=False)
        rows = slice(2 * rank, 2 * rank + 2)
        losses = [float(step(torch.from_numpy(t[rows]))) for t in data["tokens"]]
        np.savez(f"{out}/rank{rank}.npz", losses=np.array(losses),
                 **{n: p.detach().numpy() for n, p in model.named_parameters()})
    finally:
        hvd.shutdown()
""")


def test_world2_lm_step_matches_jax(tmp_path):
    """Two gloo ranks of the port, each with half the batch, against the
    JAX step on two devices; rank 1 starts from other weights, which the
    step's broadcast replaces with rank 0's."""
    from tests.test_torch_train_step import _spawn

    batches = _batches(False, 4, 2)
    start = _jax_init(jax_gpt_tiny(), T)
    want_losses, want = _run_jax(start, batches, False, world=2)
    named = dict(tt.load_jax_params(tt.gpt_tiny(device="cpu"), start)
                 .named_parameters())
    np.savez(tmp_path / "data.npz", tokens=np.stack(batches),
             **{f"p/{n}": p.detach().numpy() for n, p in named.items()})
    got = _spawn(tmp_path, _WORKER, 2)
    for g in got:
        np.testing.assert_allclose(g["losses"], want_losses, rtol=1e-6)
        _check_weights(g, want, start)
    for name in named:
        np.testing.assert_array_equal(got[0][name], got[1][name])


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import horovod_tpu_torch.ops.flash, horovod_tpu_torch.models.transformer\n"
        "import horovod_tpu_torch.parallel.tensor, horovod_tpu_torch.parallel.ring_attention\n"
        "import horovod_tpu_torch.data.packing, horovod_tpu_torch.utils.benchmarks\n"
        "import horovod_tpu_torch.parallel, horovod_tpu_torch.parallel.grad_sync\n"
        "import horovod_tpu_torch.parallel.mesh, horovod_tpu_torch.parallel.ulysses\n"
        "import horovod_tpu_torch.parallel.moe, horovod_tpu_torch.parallel.pipeline\n"
        "import horovod_tpu_torch.parallel.wire, horovod_tpu_torch.optim.zero\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
