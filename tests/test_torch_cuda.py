"""Kernels B1, B2, B3, B4 and B5 on the card: each CUDA kernel against
its plain version.

These tests need an NVIDIA GPU and skip with a reason elsewhere.  They
import nothing of JAX or ``horovod_tpu``, so on the GPU machine they run
without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

The comparison is bitwise for B1, B3, B4 and B5: B1's conversions are
the same round-to-nearest-even instructions PyTorch's CUDA casts use;
B3-B5 round every product, quotient and sum to float32 as PyTorch's
separate operations do, and define the wire values of a non-finite block
(0).  B2, flash attention, sums its dot products and row sums in another
order than the plain version's matmuls, so it is held to tolerances
(``FLASH_TOL``): in bfloat16 a score that moves by a float32 ulp can
round its p, and the output, to the other bf16 neighbour, so out agrees
to 2^-7 of itself + 2^-9; lse (about 7 at these lengths) to 1e-4, some
100 float32 ulps, since the row sums of up to 1024 terms and the
maxima's exp go in another order; float32 to 1e-5 on out and lse.
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash, kernels
from horovod_tpu_torch.ops import quant_kernels as qk

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


def _check_flash(q, k, v, causal, seg=None):
    scale = q.shape[-1] ** -0.5
    before = flash.flash_forward.launches
    out, lse = flash.flash_forward(q, k, v, causal, scale, seg)
    assert flash.flash_forward.launches == before + 1
    want_o, want_l = flash.flash_forward_reference(
        q, k, v, causal, scale, seg, block_k=flash.KERNEL_BLOCK)
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
