"""Kernels B1, B3, B4 and B5 on the card: each CUDA kernel against its
plain version.

These tests need an NVIDIA GPU and skip with a reason elsewhere.  They
import nothing of JAX or ``horovod_tpu``, so on the GPU machine they run
without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

The comparison is bitwise: B1's conversions are the same
round-to-nearest-even instructions PyTorch's CUDA casts use; B3-B5 round
every product, quotient and sum to float32 as PyTorch's separate
operations do, and define the wire values of a non-finite block (0).
"""

import pytest
import torch

from horovod_tpu_torch.ops import kernels
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
