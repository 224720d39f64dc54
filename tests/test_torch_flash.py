"""Flash attention of the port against the JAX package's, on the CPU.

The JAX side is ``horovod_tpu/ops/pallas_kernels.py``: its Pallas
forward runs in interpret mode here, as in ``test_pallas_kernels.py``.
The port's side is ``horovod_tpu_torch/ops/flash.py`` on CPU tensors,
which is the plain version of kernel B2 (``flash_forward_reference``)
and the plain chunked backward.  Inputs are made with numpy from seeds.

Tolerances, and why:

* forward, bfloat16: one bf16 ulp (rtol 2^-7), and at least 99% of the
  elements bitwise.  At the same key block both compute float32 scores
  from products that are exact in float32, round p to bf16 against the
  same running maximum and round the output to bf16; only the order of
  the D-long sums differs, which can move a score by a float32 ulp and
  round its p, and the output, the other way (measured: 2 of 8192
  elements, one ulp apart).
* forward, float32: 2e-6 absolute on out (|out| < 4) and 1e-6 on lse:
  the two sum the D-long dot products and the block rows in another
  order and differ in exp's last ulp (measured 8e-7 and 5e-7).
* gradients, float32: 2e-5 absolute, 1e-5 relative: the backward is
  the same arithmetic as einsums in float32 against matmuls in another
  summation order (measured below 3e-6).
* full attention, float32: 2e-6 absolute (one softmax, two products).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import _flash_forward
from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu.parallel.ring_attention import full_attention as jax_full
from horovod_tpu_torch.ops import flash
from horovod_tpu_torch.parallel.ring_attention import full_attention

torch.set_num_threads(2)


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread for a bitwise comparison of two float32 GEMM
    computations: on a loaded host, MKL's threaded sgemm need not give
    the same bits from one call to the next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


def _segments(b, t, seed, pad=True):
    """Sorted segment ids 1..4 per row; with ``pad`` the row ends in a
    run of padding (0) after its documents, as ``pack_documents``
    leaves it."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(1, 5, (b, t)), axis=1).astype(np.int32)
    if pad:
        seg[:, t - t // 5:] = 0
    return seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,block", [(64, 16), (64, 32), (50, 16)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_forward_reference_matches_jax(dtype, t, block, causal, packed):
    jdt, tdt = _DT[dtype]
    b, h, d = 2, 2, 32
    q, k, v = _qkv(b, t, h, d, seed=t + block)
    seg = _segments(b, t, seed=t) if packed else None
    scale = d ** -0.5
    want_o, want_l = _flash_forward(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal, scale, block,
        block, None if seg is None else jnp.asarray(seg),
    )
    got_o, got_l = flash.flash_forward_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal, scale,
        None if seg is None else torch.from_numpy(seg), block_k=block,
    )
    assert got_o.dtype == tdt and got_o.shape == (b, t, h, d)
    assert got_l.dtype == torch.float32 and got_l.shape == (b, h, t)
    want_o = np.asarray(want_o, np.float32)
    if dtype == "bfloat16":
        got_o = got_o.float().numpy()
        np.testing.assert_allclose(got_o, want_o, rtol=2 ** -7, atol=1e-6)
        assert (got_o == want_o).mean() >= 0.99
    else:
        np.testing.assert_allclose(got_o.numpy(), want_o, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_forward_reference_matches_jax_at_the_kernel_tiles(dtype, block, causal, packed):
    """The plain version against the JAX kernel at the key tiles of B2's
    two routes (64: ``flash_forward_mma``; 128: ``flash_forward_wgmma``),
    over two or four tiles, so that the card tests, which hold each route
    to the plain version at its tile, hold it to the JAX kernel too.
    XLA:CPU and PyTorch sum q·k in other orders, so over 256 keys a
    score can move by a float32 ulp and round its bf16 p to the other
    neighbour: bf16 outputs agree to 2^-7 of themselves + 2^-9 (the
    card's ``FLASH_TOL``), and 99% of them exactly; float32 and lse as
    above."""
    jdt, tdt = _DT[dtype]
    b, t, h, d = 2, 256, 2, 64
    q, k, v = _qkv(b, t, h, d, seed=block)
    seg = _segments(b, t, seed=t) if packed else None
    scale = d ** -0.5
    want_o, want_l = _flash_forward(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal, scale, block,
        block, None if seg is None else jnp.asarray(seg),
    )
    got_o, got_l = flash.flash_forward_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal, scale,
        None if seg is None else torch.from_numpy(seg), block_k=block,
    )
    want_o = np.asarray(want_o, np.float32)
    if dtype == "bfloat16":
        got_o = got_o.float().numpy()
        np.testing.assert_allclose(got_o, want_o, rtol=2 ** -7, atol=2 ** -9)
        assert (got_o == want_o).mean() >= 0.99
    else:
        np.testing.assert_allclose(got_o.numpy(), want_o, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0,
                               atol=1e-6)


def test_forward_on_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 40, 2, 16, seed=1))
    before = flash.flash_forward.launches
    with _one_thread():
        out, lse = flash.flash_forward(q, k, v, True, 0.25)
        want_o, want_l = flash.flash_forward_reference(q, k, v, True, 0.25)
    assert flash.flash_forward.launches == before
    assert torch.equal(out, want_o) and torch.equal(lse, want_l)


def test_forward_refuses_other_devices():
    q = torch.zeros(1, 16, 1, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_forward(q, q, q, True, 0.25)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("t,block", [(48, 16), (40, 32)])
def test_gradients_match_jax(causal, packed, t, block):
    b, h, d = 2, 2, 16
    q, k, v = _qkv(b, t, h, d, seed=7 + t)
    w = np.random.default_rng(8).standard_normal((b, t, h, d)).astype(np.float32)
    seg = _segments(b, t, seed=9) if packed else None

    def loss_j(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal, None, block, block, block,
                        segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash.flash_attention(
        tq, tk, tv, causal, None, block, block, block,
        segment_ids=None if seg is None else torch.from_numpy(seg),
    )
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=2e-5, err_msg=f"d{name}")


def test_bf16_gradients_keep_the_input_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
               for x in _qkv(1, 32, 2, 16, seed=3))
    flash.flash_attention(q, k, v, True).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_full_attention_matches_jax(causal, packed):
    b, t, h, d = 2, 24, 3, 16
    q, k, v = _qkv(b, t, h, d, seed=11)
    seg = _segments(b, t, seed=12) if packed else None
    want = jax_full(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                    segment_ids=None if seg is None else jnp.asarray(seg))
    got = full_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal,
                         segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_full_attention_offsets_the_causal_diagonal():
    """Tq < Tk: query i sees keys up to i + Tk - Tq, as in JAX."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((1, 4, 1, 8)).astype(np.float32)
    kv = rng.standard_normal((1, 10, 1, 8)).astype(np.float32)
    want = jax_full(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), causal=True)
    got = full_attention(torch.from_numpy(q), torch.from_numpy(kv),
                         torch.from_numpy(kv), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_flash_matches_full_attention():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 36, 2, 16, seed=14))
    seg = torch.from_numpy(_segments(2, 36, seed=15))
    for s in (None, seg):
        got = flash.flash_attention(q, k, v, True, None, 16, 16, 16, segment_ids=s)
        want = full_attention(q, k, v, causal=True, segment_ids=s)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-6)


def test_value_errors_match_jax():
    q = torch.zeros(1, 64, 2, 32)
    kv = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="equal q/k/v sequence lengths"):
        flash.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match=r"segment_ids must be \[B, T\]"):
        flash.flash_attention(q, q, q, segment_ids=torch.zeros(1, 63, dtype=torch.int32))
