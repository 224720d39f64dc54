"""Kernels B1 to B7 on the card: each CUDA kernel against its plain
version.

These tests need an NVIDIA GPU and skip with a reason elsewhere.  They
import nothing of JAX or ``horovod_tpu``, so on the GPU machine they run
without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

The comparison is bitwise for B1, B3, B4 and B5: B1's conversions are
the same round-to-nearest-even instructions PyTorch's CUDA casts use;
B3-B5 round every product, quotient and sum to float32 as PyTorch's
separate operations do, and define the wire values of a non-finite block
(0).  B2, flash attention, has two routes (``flash.route``): wgmma for
bf16 at head dims 64 and 128, mma for float32 and bf16 at 16 and 32.
Each sums its dot products and row sums in another order than the plain
version's matmuls, so each is held, at its own key tile, to tolerances
(``FLASH_TOL``): in bfloat16 a score that moves by a float32 ulp can
round its p, and the output, to the other bf16 neighbour, so out agrees
to 2^-7 of itself + 2^-9; lse (about 7 at these lengths) to 1e-4, some
100 float32 ulps, since the row sums of up to 1024 terms and the
maxima's exp go in another order; float32 to 1e-5 on out and lse.
B6 and B7, the quantized rings, run the device functions of B3 and B4
and sum in the plain version's order: bitwise, on n virtual ranks of
one card, and in worlds of two processes (two cards over NVLink, or two
ranks sharing one card); captured into a CUDA graph and replayed too.
The step captured as one CUDA graph (``HVD_TPU_ONESTEP``) is held
bitwise against the eager step on a narrow ResNet, one graph per batch
shape, and ``on`` must raise where a step cannot be captured.  The
eager collective API runs ``chip_smoke.eager_checks`` in worlds of one
and two.
"""

import ctypes
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from horovod_tpu_torch.ops import flash, kernels, peer
from horovod_tpu_torch.ops import quant_kernels as qk
from horovod_tpu_torch.ops import ring_kernels as rk

torch.set_num_threads(2)

CASES = [
    (torch.float32, torch.bfloat16, 1.0),
    (torch.float32, torch.float16, 1.0),
    (torch.bfloat16, torch.float32, 1.0),
    (torch.bfloat16, torch.bfloat16, 1.0 / 3.0),
]
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 65504.0,
            65520.0, 1e5, 6e-8, 1e-40, -3e-39, 1.2e-38]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _input(n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * 100
    k = min(n, len(SPECIALS))
    x[:k] = torch.tensor(SPECIALS[:k], device="cuda")
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 65537, 1 << 20])
@pytest.mark.parametrize("din,dout,scale", CASES)
def test_kernel_matches_plain_bitwise(n, din, dout, scale):
    _cuda()
    x = _input(n, din, n)
    before = kernels.scale_cast.launches
    got = kernels.scale_cast(x, scale, dout)
    assert kernels.scale_cast.launches == before + 1
    want = kernels.scale_cast_reference(x, scale, dout)
    assert got.dtype == dout and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_unaligned_buffer_takes_the_scalar_path():
    _cuda()
    x = _input(4099, torch.float32, 1)[1:]  # 4-byte offset: not 16-aligned
    got = kernels.scale_cast(x, 0.5, torch.bfloat16)
    assert torch.equal(_bits(got), _bits(kernels.scale_cast_reference(x, 0.5, torch.bfloat16)))


_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _wave(unit):
    """Elements of one full wave of B1's vector kernel on this card:
    every thread the card holds (2048 an SM) with its four units."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return props.multi_processor_count * props.max_threads_per_multi_processor * 4 * unit


@pytest.mark.cuda
@pytest.mark.parametrize("dout", _DTYPES)
@pytest.mark.parametrize("din", _DTYPES)
def test_kernel_at_its_loop_bounds(din, dout):
    """Bitwise at one full wave of the vector kernel (every thread the
    card holds, each with its four units), one unit (4 or 8 elements) and
    one element either side of it, and past two waves."""
    _cuda()
    unit = 4 if torch.float32 in (din, dout) else 8
    r = _wave(unit)
    for n in (r, r - unit, r + unit, r - 1, r + 1, 2 * r + unit + 3):
        x = _input(n, din, n)
        got = kernels.scale_cast(x, 0.75, dout)
        assert torch.equal(_bits(got), _bits(kernels.scale_cast_reference(x, 0.75, dout))), n


@pytest.mark.cuda
@pytest.mark.parametrize("offset_bytes", [4, 8])
@pytest.mark.parametrize("dout", _DTYPES)
@pytest.mark.parametrize("din", _DTYPES)
def test_views_off_a_16_byte_boundary(din, dout, offset_bytes):
    """A view starting 4 or 8 bytes past a 16-byte boundary takes the
    scalar path, bitwise."""
    _cuda()
    k = offset_bytes // torch.empty(0, dtype=din).element_size()
    base = _input(70000, din, offset_bytes)
    x = base[k:]
    assert x.data_ptr() % 16 == offset_bytes
    got = kernels.scale_cast(x, 1.0, dout)
    assert torch.equal(_bits(got), _bits(kernels.scale_cast_reference(x, 1.0, dout)))


@pytest.mark.cuda
def test_gradient_goes_through_the_kernel():
    """dx = g·scale through B1 (bitwise with the plain version);
    dscale = Σ g·x in float32."""
    _cuda()
    x = _input(10000, torch.float32, 2).nan_to_num(0.0, 0.0, 0.0).requires_grad_()
    s = torch.tensor(0.375, device="cuda", requires_grad=True)
    g = _input(10000, torch.bfloat16, 3).nan_to_num(0.0, 0.0, 0.0)
    before = kernels.scale_cast.launches
    kernels.scale_buffer(x, s, torch.bfloat16).backward(g)
    assert kernels.scale_cast.launches == before + 2
    assert torch.equal(_bits(x.grad), _bits(kernels.scale_cast_reference(g, 0.375, torch.float32)))
    torch.testing.assert_close(s.grad, (g.float() * x.detach()).sum(), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_rejects_what_the_kernel_does_not_take():
    _cuda()
    x = torch.ones(8, 8, device="cuda")
    with pytest.raises(ValueError):
        kernels.scale_cast(x.t(), 2.0)
    with pytest.raises(TypeError):
        kernels.scale_cast(x.double(), 2.0)


def _blocks(m, nb, block, seed):
    """(m, nb, block) float32 with magnitudes from 1e-3 to 1e3 per block
    and, in the first blocks, the special cases: all zero, an infinity,
    a NaN, all subnormal, subnormals beside normals."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, nb, block, generator=g, device="cuda")
    x *= 10.0 ** torch.randint(-3, 4, (m, nb, 1), generator=g, device="cuda")
    flat = x.view(-1, block)
    k = flat.shape[0]
    if k >= 5:
        flat[0] = 0.0
        flat[1, 3] = float("inf")
        flat[2, 5] = float("nan")
        flat[3] = torch.linspace(-1e-39, 1e-39, block, device="cuda")
        flat[4, :3] = torch.tensor([1e-40, -3e-39, 1.2e-38], device="cuda")
    return x


def _int_bits(t):
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("want_deq", [False, True])
@pytest.mark.parametrize("block", [64, 128, 512, 96, 37])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quant_packed_matches_plain_bitwise(wire, block, want_deq):
    _cuda()
    x = _blocks(3, 257, block, block)
    before = qk.quant_packed.launches
    packed, deq = qk.quant_packed(x, wire, want_deq)
    assert qk.quant_packed.launches == before + 1
    ref_p, ref_d = qk.quant_packed_reference(x, wire, want_deq)
    assert packed.shape == (3, 257, block + 4) and packed.dtype == torch.int8
    assert torch.equal(packed, ref_p)
    if want_deq:
        assert torch.equal(_int_bits(deq), _int_bits(ref_d))
    else:
        assert deq is None


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [512, 96, 37])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_dequant_accum_matches_plain_bitwise(wire, block, n):
    _cuda()
    recv, _ = qk.quant_packed(_blocks(n, 301, block, n), wire)
    before = qk.dequant_accum.launches
    got = qk.dequant_accum(recv, wire)
    assert qk.dequant_accum.launches == before + 1
    want = qk.dequant_accum_reference(recv, wire)
    assert got.shape == (301, block)
    assert torch.equal(_int_bits(got), _int_bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [512, 96, 37])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_dequant_rows_matches_plain_bitwise(wire, block):
    _cuda()
    p, _ = qk.quant_packed(_blocks(4, 129, block, 7), wire)
    before = qk.dequant_rows.launches
    got = qk.dequant_rows(p, wire)
    assert qk.dequant_rows.launches == before + 1
    assert torch.equal(_int_bits(got), _int_bits(qk.dequant_rows_reference(p, wire)))


@pytest.mark.cuda
def test_quant_kernels_at_the_bucket_size():
    """The slice's largest bucket, padded to the block: B3 with its
    dequant, B4 of one arrival, B5."""
    _cuda()
    x = _blocks(1, 16489472 // 512, 512, 11)
    packed, deq = qk.quant_packed(x, "int8", True)
    ref_p, ref_d = qk.quant_packed_reference(x, "int8", True)
    assert torch.equal(packed, ref_p)
    assert torch.equal(_int_bits(deq), _int_bits(ref_d))
    acc = qk.dequant_accum(packed, "int8")
    assert torch.equal(_int_bits(acc), _int_bits(qk.dequant_accum_reference(packed, "int8")))
    rows = qk.dequant_rows(packed, "int8")
    assert torch.equal(_int_bits(rows), _int_bits(qk.dequant_rows_reference(packed, "int8")))


@pytest.mark.cuda
def test_quant_wrappers_reject_what_the_kernels_do_not_take():
    _cuda()
    x = torch.ones(2, 4, 64, device="cuda")
    with pytest.raises(TypeError):
        qk.quant_packed(x.double(), "int8")
    with pytest.raises(ValueError):
        qk.quant_packed(x.transpose(0, 1), "int8")
    with pytest.raises(ValueError):
        qk.dequant_rows(torch.zeros(2, 68, dtype=torch.int8, device="cuda"), "int8")


FLASH_TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -9, 1e-4),  # out rtol, out atol, lse atol
             torch.float32: (1e-5, 1e-5, 1e-5)}


def _qkv(b, t, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def _segments(b, t, seed):
    """Documents of 1..t/3 tokens, then padding (segment 0)."""
    g = torch.Generator().manual_seed(seed)
    seg = torch.zeros(b, t, dtype=torch.int32)
    for row in range(b):
        pos, sid = 0, 1
        while pos < t - t // 6:
            n = int(torch.randint(1, max(2, t // 3), (1,), generator=g))
            seg[row, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
        seg[row, t - t // 6:] = 0
    return seg.cuda()


def _check_flash(q, k, v, causal, seg=None, fn=None, block=None):
    """``fn`` (default ``flash_forward``) against the plain version at
    ``block`` (default: the key tile of the route for q's dtype and D)."""
    scale = q.shape[-1] ** -0.5
    fn = fn or flash.flash_forward
    block = block or flash.KERNEL_BLOCK[flash.route(q.dtype, q.shape[-1])]
    before = flash.flash_forward.launches
    out, lse = fn(q, k, v, causal, scale, seg)
    assert flash.flash_forward.launches == before + 1
    want_o, want_l = flash.flash_forward_reference(
        q, k, v, causal, scale, seg, block_k=block)
    torch.cuda.synchronize()
    rtol, atol, lse_tol = FLASH_TOL[q.dtype]
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    torch.testing.assert_close(out.float(), want_o.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, want_l, rtol=0, atol=lse_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [64, 100, 257])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_plain(d, dtype, t, causal):
    _cuda()
    _check_flash(*_qkv(2, t, 3, d, dtype, seed=t + d), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_packed_matches_plain(dtype, causal):
    _cuda()
    _check_flash(*_qkv(2, 200, 2, 64, dtype, seed=5), causal, _segments(2, 200, 6))


@pytest.mark.cuda
def test_flash_reads_strided_views_in_place():
    """q, k, v as views of one [B, T, 3, H, D] tensor, as the model
    passes them: the same result as contiguous copies."""
    _cuda()
    qkv = torch.randn(2, 130, 3, 4, 64, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out, lse = flash.flash_forward(q, k, v, True, 0.125)
    ref_o, ref_l = flash.flash_forward(q.contiguous(), k.contiguous(),
                                       v.contiguous(), True, 0.125)
    assert torch.equal(out, ref_o) and torch.equal(lse, ref_l)


@pytest.mark.cuda
def test_flash_rejects_what_the_kernel_does_not_take():
    _cuda()
    q = torch.zeros(1, 16, 2, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_forward(q, q, q, True, 0.125)
    q = torch.zeros(1, 16, 2, 65, device="cuda", dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash.flash_forward(q, q, q, True, 0.125)
    q = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash.flash_forward(q, q, q, True, 0.125)


def _qkv_views(b, t, h, d, seed):
    """q, k, v as the model passes them: bf16 views of one [B, T, 3, H, D]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3, h, d, generator=g, device="cuda").to(torch.bfloat16)
    return qkv.unbind(2)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 100, 127, 128, 129, 1000, 1024])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_matches_plain(d, t, causal, packed):
    """The wgmma route on strided qkv views against the plain version at
    its 128-key tile: ragged and exact tiles, one row, dense and packed
    rows (padding segments included)."""
    _cuda()
    q, k, v = _qkv_views(2, t, 3, d, seed=t + d)
    assert not q.is_contiguous()
    seg = _segments(2, t, t) if packed else None
    before = flash.flash_forward_wgmma.launches
    _check_flash(q, k, v, causal, seg)
    assert flash.flash_forward_wgmma.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_runs_are_bitwise_equal(d):
    _cuda()
    q, k, v = _qkv_views(3, 700, 4, d, seed=11)
    seg = _segments(3, 700, 12)
    first = flash.flash_forward_wgmma(q, k, v, True, 0.125, seg)
    again = flash.flash_forward_wgmma(q, k, v, True, 0.125, seg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,which", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.float32, 64, "mma"),
])
def test_flash_forward_takes_the_route_for_its_dtype_and_head_dim(dtype, d, which):
    _cuda()
    q, k, v = _qkv(1, 64, 2, d, dtype, seed=d)
    counts = {r: getattr(flash, f"flash_forward_{r}").launches for r in ("wgmma", "mma")}
    flash.flash_forward(q, k, v, True, 0.125)
    for r, c in counts.items():
        assert getattr(flash, f"flash_forward_{r}").launches == c + (r == which)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_mma_route_still_held(d):
    """The retained mma route, called on its own, at every head dim it
    takes in bf16 (the main path sends it 16 and 32; 64 is where it is
    timed beside the wgmma route), against the plain version at 64."""
    _cuda()
    before = flash.flash_forward_mma.launches
    _check_flash(*_qkv_views(2, 257, 3, d, seed=d), True, fn=flash.flash_forward_mma,
                 block=flash.KERNEL_BLOCK["mma"])
    assert flash.flash_forward_mma.launches == before + 1


@pytest.mark.cuda
def test_flash_wgmma_rejects_what_it_does_not_take():
    _cuda()
    q = torch.zeros(1, 16, 2, 64, device="cuda")
    with pytest.raises(TypeError):
        flash.flash_forward_wgmma(q, q, q, True, 0.125)  # float32
    q = torch.zeros(1, 16, 2, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_forward_wgmma(q, q, q, True, 0.125)
    q = torch.zeros(1, 16, 2, 68, device="cuda", dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash.flash_forward_wgmma(q, q, q, True, 0.125)  # h stride of 136 bytes
    q = torch.zeros(1, 16, 1, 64, device="cuda", dtype=torch.bfloat16).expand(2, 16, 3, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash.flash_forward_wgmma(q, q, q, True, 0.125)  # a broadcast (0) stride


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_flash_gradient_goes_through_the_wgmma_route(packed):
    """bf16 gradients of flash_attention at D 64 (the wgmma route's out
    and lse feed the chunked backward) against autograd through
    full_attention in float32 on the same values: the backward rounds
    only its result to bf16 (2^-8 of itself) and reads out rounded to
    bf16, which moves delta = rowsum(do * out) by some 1e-3, so 2^-6 of
    the value + 1e-2."""
    _cuda()
    from horovod_tpu_torch.parallel.ring_attention import full_attention

    q, k, v = (x.contiguous().requires_grad_() for x in _qkv_views(2, 96, 2, 64, 7))
    seg = _segments(2, 96, 8) if packed else None
    w = torch.randn(2, 96, 2, 64, device="cuda")
    before = flash.flash_forward_wgmma.launches
    (flash.flash_attention(q, k, v, True, None, segment_ids=seg).float() * w).sum().backward()
    assert flash.flash_forward_wgmma.launches == before + 1
    got = [x.grad.float() for x in (q, k, v)]
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    (full_attention(qf, kf, vf, causal=True, segment_ids=seg) * w).sum().backward()
    for g, x in zip(got, (qf, kf, vf)):
        torch.testing.assert_close(g, x.grad, rtol=2 ** -6, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_flash_gradient_goes_through_the_kernel(packed):
    """Gradients of flash_attention on the card (B2 forward, chunked
    backward) against autograd through full_attention in float32, to
    1e-4 (the kernel's out and lse to 1e-5 feed the backward)."""
    _cuda()
    from horovod_tpu_torch.parallel.ring_attention import full_attention

    q, k, v = (x.requires_grad_() for x in _qkv(2, 96, 2, 32, torch.float32, 7))
    seg = _segments(2, 96, 8) if packed else None
    w = torch.randn(2, 96, 2, 32, device="cuda")
    before = flash.flash_forward.launches
    (flash.flash_attention(q, k, v, True, None, 32, 32, 32, segment_ids=seg) * w).sum().backward()
    assert flash.flash_forward.launches == before + 1
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (full_attention(q, k, v, causal=True, segment_ids=seg) * w).sum().backward()
    for g, x in zip(got, (q, k, v)):
        torch.testing.assert_close(g, x.grad, rtol=1e-4, atol=1e-4)


def _ring_input(ranks, cols, block, seed):
    return _blocks(ranks, cols // block, block, seed).view(ranks, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("want_deq", [False, True])
@pytest.mark.parametrize("block", [64, 512, 96, 36, 33])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_rs_ring_matches_plain_bitwise(n, wire, block, want_deq):
    _cuda()
    win = peer.PeerWindow.virtual(n)
    try:
        c = 37 * block
        x = _ring_input(n, n * c, block, n + block)
        before = rk.rs_ring.launches
        acc, deq = rk.rs_ring(x, win, wire, block, want_deq)
        assert rk.rs_ring.launches == before + 1
        want_acc, want_deq_ = rk.rs_ring_reference(x, wire, block, want_deq)
        assert acc.shape == (n, c)
        assert torch.equal(_int_bits(acc), _int_bits(want_acc))
        if want_deq:
            assert torch.equal(_int_bits(deq), _int_bits(want_deq_))
        else:
            assert deq is None
    finally:
        win.close()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 512, 96, 36, 33])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_ag_ring_matches_plain_bitwise(n, wire, block):
    _cuda()
    win = peer.PeerWindow.virtual(n)
    try:
        shards = _ring_input(n, 41 * block, block, 3 * n + block)
        before = rk.ag_ring.launches
        got = rk.ag_ring(shards, win, wire, block)
        assert rk.ag_ring.launches == before + 1
        assert got.shape == (n, n * 41 * block)
        assert torch.equal(_int_bits(got), _int_bits(rk.ag_ring_reference(shards, wire, block)))
    finally:
        win.close()


@pytest.mark.cuda
def test_rings_at_the_bucket_size_and_over_many_epochs():
    """World 4 at the 32 MiB plan's largest bucket (8,208,384 elements,
    c = 2,052,096), then many launches in a row on one window: the
    epochs and the two parity sets of slots.  The back-to-back B6
    launches at the bucket size hold the argument that lets the rings
    skip an entry barrier: no launch stores into a slot a peer may
    still read."""
    _cuda()
    n = 4
    c = -(-8208384 // (n * 512)) * 512
    win = peer.PeerWindow.virtual(n)
    try:
        x = _ring_input(n, n * c, 512, 21)
        acc, deq = rk.rs_ring(x, win, "int8", 512, True)
        want_acc, want_deq = rk.rs_ring_reference(x, "int8", 512, True)
        assert torch.equal(_int_bits(acc), _int_bits(want_acc))
        assert torch.equal(_int_bits(deq), _int_bits(want_deq))
        out = rk.ag_ring(acc, win, "int8", 512)
        assert torch.equal(_int_bits(out), _int_bits(rk.ag_ring_reference(acc, "int8", 512)))
        small = _ring_input(n, n * 512 * 9, 512, 22)
        want_small = rk.rs_ring_reference(small, "fp8", 512)[0]
        for _ in range(25):
            got = rk.rs_ring(small, win, "fp8", 512)[0]
            rk.ag_ring(got, win, "fp8", 512)
        assert torch.equal(_int_bits(got), _int_bits(want_small))
        # B6 back to back at the bucket size, three inputs in rotation,
        # checked only after every launch has been queued.
        xs = [x] + [_ring_input(n, n * c, 512, 23 + i) for i in range(2)]
        wants = [(want_acc, want_deq)] + [rk.rs_ring_reference(v, "int8", 512, True)
                                          for v in xs[1:]]
        got = [rk.rs_ring(xs[i % 3], win, "int8", 512, True) for i in range(12)]
        for i, (a, d) in enumerate(got):
            assert torch.equal(_int_bits(a), _int_bits(wants[i % 3][0])), i
            assert torch.equal(_int_bits(d), _int_bits(wants[i % 3][1])), i
    finally:
        win.close()


@pytest.mark.cuda
def test_rings_alternate_on_one_window_at_the_bucket_size():
    """B6 and B7 in turns on one window, three inputs in rotation: the
    two kernels take the same slots in alternate epochs, and a slot read
    two epochs late would hold another input.  Then the same turns back
    to back, every launch queued before any is checked."""
    _cuda()
    n = 4
    c = -(-8208384 // (n * 512)) * 512
    win = peer.PeerWindow.virtual(n)
    try:
        xs = [_ring_input(n, n * c, 512, 30 + i) for i in range(3)]
        want = []
        for x in xs:
            acc, _ = rk.rs_ring_reference(x, "int8", 512)
            want.append((acc, rk.ag_ring_reference(acc, "int8", 512)))
        for i in range(12):
            x, (want_acc, want_out) = xs[i % 3], want[i % 3]
            acc, _ = rk.rs_ring(x, win, "int8", 512)
            assert torch.equal(_int_bits(acc), _int_bits(want_acc)), i
            out = rk.ag_ring(acc, win, "int8", 512)
            assert torch.equal(_int_bits(out), _int_bits(want_out)), i
        got = []
        for i in range(12):
            acc, _ = rk.rs_ring(xs[i % 3], win, "int8", 512)
            got.append((acc, rk.ag_ring(want[i % 3][0], win, "int8", 512)))
        for i, (acc, out) in enumerate(got):
            assert torch.equal(_int_bits(acc), _int_bits(want[i % 3][0])), i
            assert torch.equal(_int_bits(out), _int_bits(want[i % 3][1])), i
    finally:
        win.close()


@pytest.mark.cuda
def test_window_covers_the_slots_and_every_flag():
    """``hvd_ring_window_bytes`` for n = 2 to 16: two parity sets of n - 1
    slots, then one uint32 flag per (parity, slot, stripe) for the
    kernels' 2048 stripes, rounded up to the slot alignment."""
    _cuda()
    lib = peer.library()
    align = int(lib.hvd_ring_slot_align())
    for n in range(2, peer.MAX_RANKS + 1):
        slot = peer.slot_bytes(n)
        total = int(lib.hvd_ring_window_bytes(n, slot))
        flags = 2 * (n - 1) * 2048 * 4
        assert total % align == 0, n
        assert 2 * (n - 1) * slot + flags <= total < 2 * (n - 1) * slot + flags + align, n
    assert lib.hvd_ring_window_bytes(1, 256) == -1
    assert lib.hvd_ring_window_bytes(peer.MAX_RANKS + 1, 256) == -1


@pytest.mark.cuda
def test_ring_wrappers_reject_what_the_kernels_do_not_take():
    _cuda()
    win = peer.PeerWindow.virtual(2)
    try:
        x = torch.ones(2, 2 * 512, device="cuda")
        with pytest.raises(ValueError):
            rk.rs_ring(x[:1], win, "int8", 512)  # one row for two ranks
        with pytest.raises(ValueError):
            rk.rs_ring(x, win, "int8", 300)  # not n chunks of whole blocks
        with pytest.raises(TypeError):
            rk.ag_ring(x.double(), win, "int8", 512)
        big = torch.ones(2, 2 * 512 * 9000, device="cuda")  # past the slots
        with pytest.raises(ValueError):
            rk.rs_ring(big, win, "int8", 512)
        # A launch the C entry refuses (no epoch words: null) raises and is
        # not counted.
        lib = peer.library()
        before = rk.rs_ring.launches
        with pytest.raises(RuntimeError, match="cudaError"):
            tab = (ctypes.c_void_p * 2)(x[0].data_ptr(), x[1].data_ptr())
            rc = lib.hvd_rs_ring(tab, tab, None, (ctypes.c_void_p * 2)(*win.bases),
                                 2, 0, 2, 1, 512, 0, 1.0 / 127, 0, win.slot_bytes, 1.0,
                                 torch.cuda.current_stream().cuda_stream)
            rk._launched(rk.rs_ring, lib, rc)
        assert rk.rs_ring.launches == before
    finally:
        win.close()


_TRAP = textwrap.dedent("""
    import torch
    from horovod_tpu_torch.ops import peer
    from horovod_tpu_torch.ops import ring_kernels as rk

    both = peer.PeerWindow.virtual(2)
    # Rank 0 alone: rank 1 never launches, so rank 0 waits for its arrivals.
    alone = peer.PeerWindow(both.device, 2, [0], both.bases, both.slot_bytes,
                            [], [], False)
    rk.rs_ring(torch.ones(1, 2 * 512 * 4, device="cuda"), alone, "int8", 512,
               timeout_s=0.5)
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        print("TRAPPED:", e)
    else:
        print("NO TRAP")
""")


@pytest.mark.cuda
def test_a_spin_past_its_bound_traps():
    """A peer that never arrives is a CUDA error after the bound, not a
    hung card (in a subprocess: the trap ends its CUDA context)."""
    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TRAP], cwd=root, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert "TRAPPED" in proc.stdout, proc.stdout + proc.stderr


_WORLD = textwrap.dedent("""
    import sys
    import time
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.ops import quantized as tq
    from horovod_tpu_torch.ops import ring_kernels as rk

    rank, n, store, backend = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    late = float(sys.argv[5])  # seconds the last rank arrives late
    hvd.init("cuda", init_method="file://" + store, rank=rank, size=n,
             timeout_s=100, backend=backend)
    try:
        g = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(n, 300000, generator=g, device="cuda")
        r = torch.randn(n, 300000, generator=g, device="cuda") * 1e-3
        if late:
            # A first collective maps the peer windows (a host exchange
            # on the process group); in the second the early rank's
            # kernels spin on the card until the late rank's arrive.
            tq.quantized_allreduce_ef(x[rank], r[rank], backend="fused")
            torch.cuda.synchronize()
            rk.rs_ring.launches = rk.ag_ring.launches = 0
            if rank == n - 1:
                time.sleep(late)
        t0 = time.perf_counter()
        out, r_new = tq.quantized_allreduce_ef(x[rank], r[rank], backend="fused")
        torch.cuda.synchronize()
        print("WAITED", rank, time.perf_counter() - t0)
        assert (rk.rs_ring.launches, rk.ag_ring.launches) == (1, 1)
        assert metrics.get_counter("quant.fused_fallback") == 0
        # The plain versions over every rank's input.
        c = -(-300000 // (n * 512)) * 512
        e = torch.nn.functional.pad(x + r, (0, n * c - 300000))
        acc, deq = rk.rs_ring_reference(e, "int8", 512, True)
        want = rk.ag_ring_reference(acc, "int8", 512)[0, :300000] * (1.0 / n)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
        res = (e[rank] - deq[rank].reshape(-1))[:300000]
        assert torch.equal(r_new.view(torch.int32), res.view(torch.int32))
        # B7 alone: the early rank's B7 quantizes its shard and stores it
        # into the late rank's slots, then waits on the card for the late
        # rank's arrivals.
        s = torch.randn(n, 512 * 37, generator=g, device="cuda")
        torch.cuda.synchronize()
        rk.ag_ring.launches = 0
        if late and rank == n - 1:
            time.sleep(late)
        t0 = time.perf_counter()
        got = tq.quantized_all_gather(s[rank], backend="fused")
        torch.cuda.synchronize()
        print("AG WAITED", rank, time.perf_counter() - t0)
        assert rk.ag_ring.launches == 1
        want = rk.ag_ring_reference(s, "int8", 512)[0]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        print("RING OK", rank)
    finally:
        hvd.shutdown()
""")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["two cards", "one card shared"])
def test_ring_dispatch_in_a_world_of_two(tmp_path, layout):
    """``quantized_allreduce_ef`` on the fused backend takes B6 and B7 in
    a world of two processes, bitwise with the plain versions: on two
    cards over NVLink (NCCL), or with two ranks sharing one card (gloo;
    NCCL refuses two ranks on one card)."""
    _cuda()
    if layout == "two cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, HVD_TPU_QUANT_BACKEND="fused")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    if layout == "one card shared":
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    backend = "nccl" if layout == "two cards" else "gloo"
    _run_world(root, env, tmp_path, backend, 0.0)


def _run_world(root, env, tmp_path, backend, late):
    """Run ``_WORLD`` on two ranks; their outputs."""
    procs = [subprocess.Popen([sys.executable, "-c", _WORLD, str(r), "2",
                               str(tmp_path / "store"), backend, str(late)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RING OK {r}" in out, out
    return outs


@pytest.mark.cuda
def test_ring_waits_for_a_late_peer(tmp_path):
    """A peer 12 s late (past the 10 s bound the ring once had, within
    the process group's 100 s timeout, which is now the spins' bound):
    the early rank's kernels store into the late rank's slots (neither
    waits at an entry barrier), then wait on the card for its arrivals,
    and the collective ends bitwise equal to the plain versions.  Then
    the late rank is 12 s late to an all-gather alone.  Two ranks share
    one card on gloo."""
    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, HVD_TPU_QUANT_BACKEND="fused")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    outs = _run_world(root, env, tmp_path, "gloo", 12.0)
    for stage in ("WAITED", "AG WAITED"):
        waited = float(re.search(rf"^{stage} 0 (\S+)", outs[0], re.M).group(1))
        assert waited > 10.0, outs[0]


# --------------------------------------------------- the eager API

_EAGER = textwrap.dedent("""
    import sys
    rank, n, store, backend, root = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
    sys.path.insert(0, root)
    import chip_smoke
    import horovod_tpu_torch as hvd
    hvd.init("cuda", init_method="file://" + store, rank=rank, size=n, backend=backend,
             timeout_s=100)
    try:
        rec = chip_smoke.eager_checks(n)
    finally:
        hvd.shutdown()
    print("EAGER OK", rank, rec["backend"], rec["captured"], flush=True)
""")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["world of one", "two cards", "one card shared"])
def test_eager_api_on_the_card(tmp_path, layout):
    """``chip_smoke.eager_checks`` in a world of one (NCCL), of two cards
    (NCCL) and of two ranks sharing one card (gloo): every op of the
    eager API bitwise with the values each rank computes itself on the
    CPU; B1 launched exactly twice by a bf16 allreduce with a pre- and a
    postscale and bitwise with its plain version; on NCCL a captured
    ``allreduce_`` replayed three times bitwise with eager, and ``poll``
    refused under capture."""
    _cuda()
    if layout == "two cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    if layout == "one card shared":
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    n = 1 if layout == "world of one" else 2
    backend = "gloo" if layout == "one card shared" else "nccl"
    procs = [subprocess.Popen([sys.executable, "-c", _EAGER, str(r), str(n),
                               str(tmp_path / "store"), backend, root],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"EAGER OK {r} {backend}" in out, out
        assert ("None" in out.split("EAGER OK")[-1]) == (backend == "gloo"), out


# ------------------------------------------------- the step as one graph


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_rings_captured_and_replayed_bitwise(n):
    """B6 (with the dequant) and B7 captured into one CUDA graph on n
    virtual ranks, after an eager launch of each; three replays on fresh
    inputs copied into the graph's static buffers, then an eager launch
    of each, every one bitwise with the plain versions.  A replay takes a
    new epoch from the window's epoch words on the card; with a frozen
    epoch the second replay would read the first one's flags as landed."""
    _cuda()
    win = peer.PeerWindow.virtual(n)
    try:
        block, c = 512, 512 * 67
        xs = [_ring_input(n, n * c, block, 50 + i) for i in range(5)]

        def held(what, x, shards, acc, deq, out):
            want_acc, want_deq = rk.rs_ring_reference(x, "int8", block, True)
            assert torch.equal(_int_bits(acc), _int_bits(want_acc)), what
            assert torch.equal(_int_bits(deq), _int_bits(want_deq)), what
            want_out = rk.ag_ring_reference(shards, "int8", block)
            assert torch.equal(_int_bits(out), _int_bits(want_out)), what

        x = xs[0].clone()
        shards = x[:, :c].contiguous()
        held("eager before", x, shards, *rk.rs_ring(x, win, "int8", block, True),
             rk.ag_ring(shards, win, "int8", block))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            acc, deq = rk.rs_ring(x, win, "int8", block, True)
            out = rk.ag_ring(shards, win, "int8", block)
        for i in (1, 2, 3):
            x.copy_(xs[i])
            shards.copy_(xs[i][:, :c])
            graph.replay()
            torch.cuda.synchronize()
            held(f"replay {i}", x, shards, acc, deq, out)
        x = xs[4]
        shards = x[:, :c].contiguous()
        held("eager after", x, shards, *rk.rs_ring(x, win, "int8", block, True),
             rk.ag_ring(shards, win, "int8", block))
        graph.reset()
    finally:
        win.close()


def _small_run(onestep, steps=5, before_step=None, rows=lambda i: 4, after_run=None):
    """``steps`` steps of a narrow float32 ResNet at world one on the card
    (``build_dp_step``, one batch per step, each new, of ``rows(i)``
    images), with ``HVD_TPU_ONESTEP`` at ``onestep`` and
    ``before_step(i, opt)`` called before step i when given: the losses,
    the final weights and buffers, the residuals, the kernels' launches,
    the captures, whether every ``p.grad`` was None after each step and
    what ``after_run(step)`` returns (None without it)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.utils.benchmarks import build_dp_step

    os.environ["HVD_TPU_ONESTEP"] = onestep
    metrics.reset("xir.")
    counters = (kernels.scale_cast, qk.quant_packed, qk.dequant_accum, qk.dequant_rows)
    before = [c.launches for c in counters]
    hvd.init("cuda")
    try:
        model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
                       seed=3, device="cuda")
        step, opt = build_dp_step(hvd, model)
        g = torch.Generator(device="cuda").manual_seed(4)
        losses, no_grads = [], True
        for i in range(steps):
            if before_step is not None:
                before_step(i, opt)
            batch = (torch.randn(rows(i), 32, 32, 3, generator=g, device="cuda"),
                     torch.randint(0, 10, (rows(i),), generator=g, device="cuda"))
            losses.append(step(batch))
            no_grads &= all(p.grad is None for p in model.parameters())
        torch.cuda.synchronize()
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        residuals = [r.clone() for r in opt.residuals or []]
        return {"losses": torch.stack(losses), "state": state, "residuals": residuals,
                "launches": [c.launches - b for c, b in zip(counters, before)],
                "captures": metrics.get_counter("xir.onestep.steps"),
                "no_grads": no_grads,
                "after": after_run(step) if after_run is not None else None}
    finally:
        hvd.shutdown()
        os.environ.pop("HVD_TPU_ONESTEP")


@pytest.mark.cuda
@pytest.mark.parametrize("barriers", ["0", "1"])
@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_captured_step_is_bitwise_with_eager(monkeypatch, wire, barriers):
    """Five steps of a narrow ResNet, eager and captured as one CUDA
    graph (two eager warm-up steps, the capture, two more replays, each
    step on a new batch), from one seed: bitwise-equal losses, weights,
    BatchNorm statistics and error-feedback residuals (written in place,
    so every replay carries them on), the same kernel launches (the
    replays' counted), one capture, and no ``p.grad`` left after a step
    in either mode.  cuDNN is held to its deterministic algorithms, so
    two eager runs are bitwise too."""
    _cuda()
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)
    monkeypatch.setenv("HVD_TPU_SCHED_BARRIERS", barriers)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    eager, captured = _small_run("off"), _small_run("on")
    assert torch.equal(_int_bits(captured["losses"]), _int_bits(eager["losses"]))
    for k, v in eager["state"].items():
        got = captured["state"][k]
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k
    assert len(captured["residuals"]) == len(eager["residuals"])
    assert bool(eager["residuals"]) == (wire == "int8")
    for r, want in zip(captured["residuals"], eager["residuals"]):
        assert torch.equal(_int_bits(r), _int_bits(want))
    if wire == "int8":
        assert any(bool(r.abs().sum() > 0) for r in captured["residuals"])
    assert captured["launches"] == eager["launches"] and sum(eager["launches"]) > 0
    assert (eager["captures"], captured["captures"]) == (0, 1)
    assert eager["no_grads"] and captured["no_grads"]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_captured_step_follows_a_changed_learning_rate(monkeypatch, wire):
    """Ten steps of the narrow ResNet, eager and under ``on``: after the
    capture and a replay, the learning rate changes through
    ``param_groups`` (as a schedule changes it), and at step 8
    ``HVD_TPU_QUANT_BLOCK`` goes from 512 to 256.  Each change drops the
    graph and the next calls warm up and capture anew, so the losses,
    weights, statistics and residuals stay bitwise with the eager
    step's, which reads both anew on every call; a graph kept across
    the change would go on at the old rate, or the old block."""
    _cuda()
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)
    monkeypatch.delenv("HVD_TPU_QUANT_BLOCK", raising=False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def before_step(i, opt):
        if i == 4:
            for group in opt.param_groups:
                group["lr"] *= 0.1
        if i == 8:
            os.environ["HVD_TPU_QUANT_BLOCK"] = "256"

    runs = []
    for mode in ("off", "on"):
        try:
            runs.append(_small_run(mode, steps=10, before_step=before_step))
        finally:
            os.environ.pop("HVD_TPU_QUANT_BLOCK", None)
    eager, captured = runs
    assert torch.equal(_int_bits(captured["losses"]), _int_bits(eager["losses"]))
    for k, v in eager["state"].items():
        got = captured["state"][k]
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k
    for r, want in zip(captured["residuals"], eager["residuals"]):
        assert torch.equal(_int_bits(r), _int_bits(want))
    assert captured["launches"] == eager["launches"]
    assert (eager["captures"], captured["captures"]) == (0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_alternating_batch_shapes_replay_bitwise_with_eager(monkeypatch, wire):
    """Epochs of three batches of 4 and a short one of 2, eager and under
    ``on``: each shape warms up and captures once (two captures in all)
    and its graph replays whenever the shape comes back, bitwise with the
    eager step, with the same launches.  ``drop()`` then gives both
    pools back: reserved memory after it is no more than before the
    first capture."""
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP

    _cuda()
    monkeypatch.setenv("HVD_TPU_SCHED_WIRE", wire)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    reserved = {}

    def before_step(i, opt):
        if i == CAPTURE_WARMUP:
            torch.cuda.synchronize()
            reserved["before"] = torch.cuda.memory_reserved()

    def after_run(step):
        graphs = len(step._graphs)
        step.drop()
        torch.cuda.synchronize()
        return graphs, torch.cuda.memory_reserved()

    def rows(i):
        return 2 if i % 4 == 3 else 4

    eager = _small_run("off", steps=16, rows=rows)
    captured = _small_run("on", steps=16, rows=rows, before_step=before_step,
                          after_run=after_run)
    assert torch.equal(_int_bits(captured["losses"]), _int_bits(eager["losses"]))
    for k, v in eager["state"].items():
        got = captured["state"][k]
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k
    for r, want in zip(captured["residuals"], eager["residuals"]):
        assert torch.equal(_int_bits(r), _int_bits(want))
    assert captured["launches"] == eager["launches"]
    assert (eager["captures"], captured["captures"]) == (0, 2)
    graphs, after = captured["after"]
    assert graphs == 2
    assert after <= reserved["before"], (after, reserved["before"])


@pytest.mark.cuda
def test_onestep_on_refuses_a_step_it_cannot_capture(monkeypatch):
    """Under ``HVD_TPU_ONESTEP=on`` on the card, a step that cannot be
    captured raises, naming why, before it runs: two backward passes per
    step, a sparse-gradient module, a gloo process group.  Under
    ``auto`` the gloo step runs eagerly (nothing captured)."""
    import horovod_tpu_torch as hvd
    import torch.nn.functional as F
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.exceptions import HorovodTpuError
    from horovod_tpu_torch.models import ResNet

    _cuda()
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    batch = (torch.randn(2, 32, 32, 3, device="cuda"), torch.randint(0, 10, (2,), device="cuda"))

    def loss_fn(m, b):
        return F.cross_entropy(m(b[0]), b[1])

    def resnet():
        return ResNet([1, 1, 1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
                      seed=3, device="cuda")

    hvd.init("cuda")
    try:
        model = resnet()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                       backward_passes_per_step=2)
        with pytest.raises(HorovodTpuError, match="backward_passes_per_step is 2.*A12a"):
            hvd.TrainStep(model, opt, loss_fn)(batch)
        emb = torch.nn.Sequential(torch.nn.Embedding(10, 4, sparse=True)).cuda()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.1),
                                       sparse_as_dense=True)
        with pytest.raises(HorovodTpuError, match="sparse"):
            hvd.TrainStep(emb, opt, lambda m, b: m(b[1]).sum())(batch)
    finally:
        hvd.shutdown()
    hvd.init("cuda", backend="gloo")
    try:
        model = resnet()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        step = hvd.TrainStep(model, opt, loss_fn)
        with pytest.raises(HorovodTpuError, match="gloo"):
            step(batch)
        monkeypatch.setenv("HVD_TPU_ONESTEP", "auto")
        metrics.reset("xir.")
        assert all(torch.isfinite(step(batch)) for _ in range(4))
        assert metrics.get_counter("xir.onestep.steps") == 0
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_dropping_the_captured_step_releases_its_memory(monkeypatch):
    """Five rounds of warm-up, capture, a replay and a drop (each round
    on another wire, so each captures anew): the memory allocated at rest
    after a drop does not grow from one round to the next, and the drop
    gives the graph's pool back to the card: reserved memory after it is
    no more than before the capture."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP
    from horovod_tpu_torch.utils.benchmarks import build_dp_step

    _cuda()
    monkeypatch.setenv("HVD_TPU_ONESTEP", "on")
    hvd.init("cuda")
    try:
        model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
                       seed=3, device="cuda")
        step, _ = build_dp_step(hvd, model)
        batch = (torch.randn(4, 32, 32, 3, device="cuda"),
                 torch.randint(0, 10, (4,), device="cuda"))
        at_rest, reserved = [], []
        for i in range(5):
            monkeypatch.setenv("HVD_TPU_SCHED_WIRE", "bf16" if i % 2 else "off")
            for _ in range(CAPTURE_WARMUP):
                float(step(batch))
            before_capture = torch.cuda.memory_reserved()
            for _ in range(2):
                loss = step(batch)
            assert torch.isfinite(loss) and step._graphs
            del loss
            step.drop()
            torch.cuda.synchronize()
            at_rest.append(torch.cuda.memory_allocated())
            reserved.append((torch.cuda.memory_reserved(), before_capture))
        assert max(at_rest[1:]) <= at_rest[1], at_rest
        assert all(after <= before for after, before in reserved), reserved
    finally:
        hvd.shutdown()


_SHUTDOWN = textwrap.dedent("""
    import sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.optim.distributed_optimizer import CAPTURE_WARMUP
    from horovod_tpu_torch.utils.benchmarks import build_dp_step

    rank, store = int(sys.argv[1]), sys.argv[2]
    hvd.init("cuda", init_method="file://" + store, rank=rank, size=2, timeout_s=100)
    model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
                   seed=rank, device=hvd.device())
    step, _ = build_dp_step(hvd, model)
    batch = (torch.randn(4, 32, 32, 3, device=hvd.device()),
             torch.randint(0, 10, (4,), device=hvd.device()))
    for _ in range(CAPTURE_WARMUP + 3):
        loss = float(step(batch))
    assert step._graphs
    hvd.shutdown()  # the captured step is still alive here
    assert not step._graphs
    print("SHUTDOWN OK", rank, loss, flush=True)
""")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_shutdown_returns_with_a_captured_step_alive(tmp_path, wire):
    """Two ranks on two cards (NCCL), each with a captured step still
    alive (on the int8 wire B6 and B7 in the graph, on bf16 NCCL), leave
    the process group through ``hvd.shutdown()`` within the time limit:
    a graph that captured NCCL operations holds its communicator, so
    ``shutdown()`` drops every captured step first."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, HVD_TPU_ONESTEP="on",
               HVD_TPU_SCHED_WIRE=wire, HVD_TPU_QUANT_BACKEND="fused")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _SHUTDOWN, str(r),
                               str(tmp_path / "store")],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"SHUTDOWN OK {r}" in out, out


_SET_CAPTURE = textwrap.dedent("""
    import os, sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.utils.benchmarks import build_dp_step

    rank, n, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    members = [0, 1] if n == 4 else [1]
    ps = hvd.ProcessSet(members)
    hvd.init("cuda", init_method="file://" + store, rank=rank, size=n, timeout_s=100,
             process_sets=[ps])
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for wire in ("bf16", "int8"):
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            runs = []
            for mode in ("off", "on"):
                os.environ["HVD_TPU_ONESTEP"] = mode
                metrics.reset("xir.")
                model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                               dtype=torch.float32, seed=0, device=hvd.device())
                step, _ = build_dp_step(hvd, model, process_set=ps)
                g = torch.Generator(device="cuda").manual_seed(10 + rank)
                losses = []
                for _ in range(5):
                    batch = (torch.randn(4, 32, 32, 3, generator=g, device="cuda"),
                             torch.randint(0, 10, (4,), generator=g, device="cuda"))
                    losses.append(step(batch))
                torch.cuda.synchronize()
                runs.append((torch.stack(losses).cpu(),
                             [p.detach().cpu().clone() for p in model.parameters()],
                             metrics.get_counter("xir.onestep.steps")))
                step.drop()
            (l0, p0, c0), (l1, p1, c1) = runs
            assert (c0, c1) == (0, 1), (c0, c1)
            assert torch.equal(l0.view(torch.int32), l1.view(torch.int32)), wire
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(p0, p1)), wire
            print("SET CAPTURE OK", rank, wire, flush=True)
    finally:
        hvd.shutdown()
""")


@pytest.mark.cuda
def test_captured_step_on_a_process_set_is_bitwise_with_eager(tmp_path):
    """A world of two cards ({1} on the set, rank 0 off it) or four ({0, 1}
    on it), NCCL: the narrow ResNet's step with
    ``DistributedOptimizer(process_set=...)`` on the bf16 and int8 wires,
    five steps eager and five under ``HVD_TPU_ONESTEP=on`` (one capture,
    the set's communicators made in the warm-up steps), from one seed:
    every rank's losses and weights bitwise equal across the two."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL refuses two ranks on one card")
    n = 4 if torch.cuda.device_count() >= 4 else 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, HVD_TPU_QUANT_BACKEND="fused")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _SET_CAPTURE, str(r), str(n),
                               str(tmp_path / "store")],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"SET CAPTURE OK {r} int8" in out, out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_captured_and_replayed_on_fresh_inputs_bitwise(d):
    """B2's wgmma route captured into a CUDA graph (its q, k and v tensor
    maps are encoded on the host at capture, for the capture's static
    buffers, and kept by the graph), then three replays on fresh inputs
    copied into those buffers, each bitwise with an eager launch on the
    same inputs; the chunked backward's loop captured in the same graph,
    bitwise with its eager run."""
    _cuda()
    b, t, h = 2, 1000, 128 // d * 3
    static = [torch.empty(b, t, h, d, device="cuda", dtype=torch.bfloat16)
              for _ in range(4)]  # q, k, v, the output's cotangent
    q, k, v, do = static
    for x in static:
        x.copy_(torch.randn(b, t, h, d, device="cuda"))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # Build and load the library, and make cuBLAS's handle, first.
        o, l = flash.flash_forward(q, k, v, True, d ** -0.5)
        flash.flash_backward_chunked(q, k, v, o, l, do, True, d ** -0.5, 256)
        with torch.cuda.graph(graph):
            out, lse = flash.flash_forward(q, k, v, True, d ** -0.5)
            grads = flash.flash_backward_chunked(q, k, v, out, lse, do, True, d ** -0.5, 256)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.Generator(device="cuda").manual_seed(9)
    for _ in range(3):
        fresh = [torch.randn(b, t, h, d, generator=g, device="cuda").to(torch.bfloat16)
                 for _ in range(4)]
        for s, f in zip(static, fresh):
            s.copy_(f)
        graph.replay()
        want_o, want_l = flash.flash_forward(*fresh[:3], True, d ** -0.5)
        want_g = flash.flash_backward_chunked(*fresh[:3], want_o, want_l, fresh[3], True,
                                              d ** -0.5, 256)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(want_o))
        assert torch.equal(lse.view(torch.int32), want_l.view(torch.int32))
        for got, want in zip(grads, want_g):
            assert torch.equal(_bits(got), _bits(want))


_GPT_CAPTURE = textwrap.dedent("""
    import os, sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import flash
    from horovod_tpu_torch.utils.benchmarks import build_lm_step, packed_lm_batch

    packed = sys.argv[1] == "packed"
    os.environ["HVD_TPU_SCHED_WIRE"] = "off"
    cfg = tt.TransformerConfig(vocab_size=512, num_layers=2, model_dim=128, num_heads=2,
                               head_dim=64, ff_dim=512, max_len=256)
    g = torch.Generator(device="cuda").manual_seed(4)
    if packed:
        toks, segs = packed_lm_batch(4, 256, 512, seed=3)
        batch = (torch.from_numpy(toks).cuda(), torch.from_numpy(segs).cuda())
    else:
        batch = torch.randint(0, 512, (4, 256), generator=g, device="cuda")
    runs = {}
    hvd.init("cuda")
    try:
        for mode in ("off", "on"):
            os.environ["HVD_TPU_ONESTEP"] = mode
            model = tt.Transformer(cfg, seed=5, device="cuda")
            step, opt = build_lm_step(hvd, model, packed=packed)
            assert all(g["capturable"] for g in opt.param_groups)
            metrics.reset("xir.")
            flash.flash_forward.launches = 0
            losses = [float(step(batch)) for _ in range(5)]
            runs[mode] = (losses, [p.detach().clone() for p in model.parameters()],
                          metrics.get_counter("xir.onestep.steps"),
                          flash.flash_forward.launches)
    finally:
        hvd.shutdown()
    (le, we, ce, fe), (lc, wc, cc, fc) = runs["off"], runs["on"]
    assert le == lc, (le, lc)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(we, wc))
    assert (ce, cc) == (0, 1) and fe == fc == 2 * 5, (ce, cc, fe, fc)
    print("GPT CAPTURE OK", sys.argv[1])
""")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["dense", "packed"])
def test_captured_gpt_step_is_bitwise_with_eager(rows):
    """``build_lm_step`` on a small bf16 GPT (2 layers, 2 heads x 64, 256
    positions), AdamW ``capturable=True`` on the card: five steps eager
    and five under ``HVD_TPU_ONESTEP=on`` (two warm-up steps, one
    capture, replays) from one seed, losses and weights bitwise equal,
    B2 counted twice per step on the replays (in a process of its own:
    the port's runtime is process-wide)."""
    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", _GPT_CAPTURE, rows], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and f"GPT CAPTURE OK {rows}" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])


@pytest.mark.cuda
def test_hybrid_meshes_on_the_card():
    """``chip_smoke.py --only hybrid``: GPT-2 small over dp2 x tp2 (flash),
    sp2 x tp2 (ring) and sp4 (Ulysses) in a world of four, one rank per
    card on NCCL with four cards, else four ranks sharing one on gloo:
    the first loss and the synced gradients of each mesh against the
    unsharded model, B1 (and B3-B5) on the mesh's groups bitwise with
    their plain versions, replicas bitwise, exact launches of B2 (and B1,
    B3-B5)."""
    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"), "--only",
                           "hybrid"], cwd=root, env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for mesh in ("dp2_tp2 (flash)", "sp2_tp2 (ring)", "sp4 (ulysses)"):
        assert f"phase slice hybrid {mesh}: " in proc.stdout, proc.stdout[-3000:]
    assert proc.stdout.count("gradients after sync_gradients") == 3, proc.stdout[-3000:]


_HIER_CAPTURE = textwrap.dedent("""
    import os, sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.utils.benchmarks import build_dp_step

    rank, n, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["HVD_TPU_TOPO"] = "2x2"
    hvd.init("cuda", init_method="file://" + store, rank=rank, size=n, timeout_s=100)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for label, wire, lowering, op in (("hier bf16", "bf16", "hier", hvd.Average),
                                          ("hier int8", "int8", "hier", hvd.Average),
                                          ("hier_adasum bf16", "bf16", None, hvd.Adasum)):
            os.environ["HVD_TPU_SCHED_WIRE"] = wire
            runs = []
            for mode in ("off", "on"):
                os.environ["HVD_TPU_ONESTEP"] = mode
                metrics.reset("xir.")
                model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                               dtype=torch.float32, seed=0, device=hvd.device())
                step, opt = build_dp_step(hvd, model, op=op, lowering=lowering)
                g = torch.Generator(device="cuda").manual_seed(10 + rank)
                losses = []
                for _ in range(5):
                    batch = (torch.randn(4, 32, 32, 3, generator=g, device="cuda"),
                             torch.randint(0, 10, (4,), generator=g, device="cuda"))
                    losses.append(step(batch))
                torch.cuda.synchronize()
                runs.append((torch.stack(losses).cpu(),
                             [p.detach().cpu().clone() for p in model.parameters()],
                             metrics.get_counter("xir.onestep.steps"),
                             {b.lowering for b in opt.schedule.buckets}))
                step.drop()
            (l0, p0, c0, lo0), (l1, p1, c1, lo1) = runs
            want = {"hier_adasum" if op == hvd.Adasum else "hier"}
            assert lo0 == lo1 == want, (label, lo0, lo1)
            assert (c0, c1) == (0, 1), (label, c0, c1)
            assert torch.equal(l0.view(torch.int32), l1.view(torch.int32)), label
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(p0, p1)), label
            print("HIER CAPTURE OK", rank, label, flush=True)
    finally:
        hvd.shutdown()
""")


@pytest.mark.cuda
def test_hierarchical_buckets_captured_bitwise_with_eager(tmp_path):
    """Four cards, NCCL, ``HVD_TPU_TOPO=2x2``: the narrow ResNet's step
    with every bucket ``hier`` (bf16 and int8 cross-domain hops) and with
    ``op=Adasum`` (every bucket ``hier_adasum``), five steps eager and
    five under ``HVD_TPU_ONESTEP=on`` (one capture; the intra and cross
    groups made by the first warm-up step's plan), from one seed: every
    rank's losses and weights bitwise equal across the two.  Below four
    cards it skips: a ``2x1`` topology is not multi-domain
    (``topo/model.py`` ``multi_slice``), so every bucket would be flat."""
    _cuda()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: two domains of two ranks, one rank a card")
    n = 4
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, HVD_TPU_QUANT_BACKEND="fused")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HVD_TPU_TOPO_LOWER"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", _HIER_CAPTURE, str(r), str(n),
                               str(tmp_path / "store")],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"HIER CAPTURE OK {r} hier_adasum bf16" in out, out
