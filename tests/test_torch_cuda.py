"""Kernel B1 on the card: the CUDA kernel against its plain version.

These tests need an NVIDIA GPU and skip with a reason elsewhere.  They
import nothing of JAX or ``horovod_tpu``, so on the GPU machine they run
without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

The comparison is bitwise: the kernel's conversions are the same
round-to-nearest-even instructions PyTorch's CUDA casts use.
"""

import pytest
import torch

from horovod_tpu_torch.ops import kernels

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
