"""Kernel B1 (scale/cast): the port against the JAX Pallas kernel.

The port's wrapper on a CPU tensor computes B1's plain version; it is
held bitwise against ``horovod_tpu.ops.pallas_kernels.scale_buffer`` /
``cast_buffer`` run in Pallas interpret mode.  The CUDA kernel itself is
held bitwise against the plain version on the card (``chip_smoke.py``
and ``tests/test_torch_cuda.py``, which skips without a card).

Two properties of XLA's CPU backend, not of the kernel, are outside the
bitwise contract: NaN payloads (XLA keeps the sign and quiets, torch's
CPU cast gives 0xffff; positions of NaN must agree) and float32
subnormals, which XLA:CPU flushes to zero on input and on the product.
The kernel keeps them, as ``torch.Tensor.to`` does; f16 subnormal
results are bitwise in both packages.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_kernels import cast_buffer, scale_buffer
from horovod_tpu_torch.ops import kernels

torch.set_num_threads(2)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
_UINT = {"float32": np.uint32, "bfloat16": np.uint16, "float16": np.uint16}

# float32 values with the special cases: NaN, infinities, overflow to
# inf in f16, results that are f16 subnormals, tiny normals, ties.
_SPECIALS = np.array(
    [np.nan, np.inf, -np.inf, 0.0, -0.0, 65504.0, 65520.0, -7e4, 1e5,
     3.0e38, 6e-8, -3e-6, 1e-7, 1.2e-38, -1.18e-38, 1 / 3, 1.00390625,
     1.01171875, 0.1, 2.0 ** -14],
    np.float32,
)


def _inputs(n: int, in_dtype: str, specials: bool) -> np.ndarray:
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(
        np.float32
    )
    if specials:
        k = min(n, len(_SPECIALS))
        x[:k] = _SPECIALS[:k]
    if in_dtype == "float32":
        return x
    # Round through torch so both packages see the same half-width input.
    return torch.from_numpy(x).to(_TORCH[in_dtype]).float().numpy()


def _jax(x32: np.ndarray, in_dtype, out_dtype, scale):
    xj = jnp.asarray(x32).astype(_JNP[in_dtype])
    if scale == 1.0:
        out = cast_buffer(xj, _JNP[out_dtype])
    else:
        out = scale_buffer(xj, scale, _JNP[out_dtype])
    return np.asarray(out).view(_UINT[out_dtype])


def _port(x32: np.ndarray, in_dtype, out_dtype, scale):
    xt = torch.from_numpy(x32).to(_TORCH[in_dtype])
    if scale == 1.0:
        out = kernels.cast_buffer(xt, _TORCH[out_dtype])
    else:
        out = kernels.scale_buffer(xt, scale, _TORCH[out_dtype])
    assert out.dtype == _TORCH[out_dtype] and out.shape == xt.shape
    return out.view(torch.int16 if out.element_size() == 2 else torch.int32) \
        .numpy().view(_UINT[out_dtype])


def _is_nan(bits: np.ndarray, out_dtype: str) -> np.ndarray:
    if out_dtype == "bfloat16":
        return (bits & 0x7FFF) > 0x7F80
    return np.isnan(bits.view(np.float32 if out_dtype == "float32" else np.float16))


def _assert_bitwise(got, want, x32, scale, out_dtype):
    """Bitwise, except NaN payloads and where XLA:CPU flushed a float32
    subnormal input or product to zero.  There JAX must give a signed
    zero and the port the round-to-nearest cast of the true product."""
    np.testing.assert_array_equal(_is_nan(got, out_dtype), _is_nan(want, out_dtype))
    prod = x32 * np.float32(scale)
    tiny = np.finfo(np.float32).tiny
    flushed = ((x32 != 0) & (np.abs(x32) < tiny)) | (
        (prod != 0) & (np.abs(prod) < tiny)
    )
    keep = ~_is_nan(got, out_dtype) & ~flushed
    np.testing.assert_array_equal(got[keep], want[keep])
    if flushed.any():
        zero = want[flushed].astype(np.uint32) & ~np.uint32(
            0x80000000 if out_dtype == "float32" else 0x8000
        )
        assert not zero.any()
        true = torch.from_numpy(prod[flushed]).to(_TORCH[out_dtype])
        np.testing.assert_array_equal(
            got[flushed],
            true.view(torch.int16 if true.element_size() == 2 else torch.int32)
            .numpy().view(_UINT[out_dtype]),
        )


CASES = [
    ("float32", "bfloat16", 1.0),
    ("float32", "float16", 1.0),
    ("bfloat16", "float32", 1.0),
    ("bfloat16", "bfloat16", 1.0 / 3.0),
]


@pytest.mark.parametrize("n", [1, 127, 65537])
@pytest.mark.parametrize("in_dtype,out_dtype,scale", CASES)
def test_plain_matches_jax_bitwise(n, in_dtype, out_dtype, scale):
    x = _inputs(n, in_dtype, specials=True)
    _assert_bitwise(
        _port(x, in_dtype, out_dtype, scale),
        _jax(x, in_dtype, out_dtype, scale),
        x, scale, out_dtype,
    )


# The CUDA kernel's bounds on an H100 (csrc/scale_cast.cu): one full
# wave is 132 SMs x 2048 threads x 4 units of 4 elements (a cast to or
# from float32) or 8 (bf16 -> bf16).
_ROUND_UNITS = 132 * 2048 * 4


def _bound_sizes(unit):
    r = _ROUND_UNITS * unit
    return [r, r - unit, r + unit, r - 1, r + 1]


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("in_dtype,out_dtype,scale", CASES)
def test_plain_matches_jax_at_the_kernels_loop_bounds(in_dtype, out_dtype, scale, k):
    unit = 4 if "float32" in (in_dtype, out_dtype) else 8
    n = _bound_sizes(unit)[k]
    x = _inputs(n, in_dtype, specials=True)
    _assert_bitwise(
        _port(x, in_dtype, out_dtype, scale),
        _jax(x, in_dtype, out_dtype, scale),
        x, scale, out_dtype,
    )


def test_launch_scale_rounds_as_float32():
    """The wrapper hands the scale to the kernel as a ctypes ``c_float``;
    that conversion rounds to nearest even, as ``np.float32`` (the plain
    version's rounding) does."""
    import ctypes

    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.standard_normal(2000) * 10.0 ** rng.integers(-40, 38, 2000),
        [0.1, 1 / 3, 1 / 7, 1e-40, -3e-39, 3.4028234e38, 1.0 + 2.0 ** -24,
         1.0 + 3 * 2.0 ** -24, 0.0, -0.0],
    ])
    for v in vals:
        want = np.float32(v)
        got = np.float32(ctypes.c_float(float(v)).value)
        assert got.view(np.uint32) == want.view(np.uint32), v


def test_float32_subnormal_inputs_follow_torch_cast():
    """XLA:CPU flushes f32 subnormal inputs; the kernel keeps them, as
    ``torch.Tensor.to`` does (the card's cvt.rn does too)."""
    x = torch.tensor([1e-40, -3e-39, 1.4e-45], dtype=torch.float32)
    got = kernels.cast_buffer(x, torch.bfloat16)
    assert torch.equal(got.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))
    assert got[0].item() != 0.0


def test_scale_is_rounded_to_float32_first():
    x = torch.tensor([3.0, 1e-3, 7.0], dtype=torch.float32)
    want = scale_buffer(jnp.asarray(x.numpy()), 0.1, jnp.float32)
    got = kernels.scale_buffer(x, 0.1, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32"), ("float32", "float32"),
])
def test_gradient_matches_jax(in_dtype, out_dtype):
    """dx = g·scale through the kernel (bitwise); dscale = Σ g·x in f32
    (rtol 1e-6: the two packages sum in different orders)."""
    import jax

    rng = np.random.default_rng(7)
    x = _inputs(1000, in_dtype, specials=False)
    g = _inputs(1000, out_dtype, specials=False)
    g = (g * rng.uniform(0.5, 2.0, g.shape)).astype(np.float32)
    g = torch.from_numpy(g).to(_TORCH[out_dtype]).float().numpy()
    scale = 0.375

    def f(xj, s, gj):
        return jnp.sum(
            scale_buffer(xj, s, _JNP[out_dtype]).astype(jnp.float32)
            * gj.astype(jnp.float32)
        )

    xj = jnp.asarray(x).astype(_JNP[in_dtype])
    gj = jnp.asarray(g).astype(_JNP[out_dtype])
    dx_j, ds_j = jax.grad(f, argnums=(0, 1))(xj, jnp.float32(scale), gj)

    xt = torch.from_numpy(x).to(_TORCH[in_dtype]).requires_grad_()
    st = torch.tensor(scale, dtype=torch.float32, requires_grad=True)
    out = kernels.scale_buffer(xt, st, _TORCH[out_dtype])
    out.backward(torch.from_numpy(g).to(_TORCH[out_dtype]))
    np.testing.assert_array_equal(
        xt.grad.float().numpy(), np.asarray(dx_j.astype(jnp.float32))
    )
    np.testing.assert_allclose(float(st.grad), float(ds_j), rtol=1e-6)


def test_cast_buffer_identity_and_type_checks():
    x = torch.ones(4, dtype=torch.bfloat16)
    assert kernels.cast_buffer(x, torch.bfloat16) is x
    with pytest.raises(TypeError):
        kernels.scale_cast(torch.ones(4, dtype=torch.float64), 2.0)
    with pytest.raises(TypeError):
        kernels.scale_cast(torch.ones(4), 2.0, torch.int32)


def test_cpu_path_launches_no_kernel():
    before = kernels.scale_cast.launches
    kernels.cast_buffer(torch.ones(300), torch.bfloat16)
    assert kernels.scale_cast.launches == before


def test_import_pulls_in_no_jax():
    code = (
        "import sys, horovod_tpu_torch, horovod_tpu_torch.models, "
        "horovod_tpu_torch.utils.benchmarks\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=root,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "horovod_tpu_torch.ops.kernels", "horovod_tpu_torch.ops.ring_kernels",
    "horovod_tpu_torch.ops.peer", "chip_smoke",
])
def test_kernel_modules_and_the_card_check_pull_in_no_jax(module):
    """The kernel wrappers and ``chip_smoke.py`` import neither ``jax``
    nor ``horovod_tpu`` (the card machine runs them without either)."""
    code = (
        f"import sys, {module}\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=root,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
