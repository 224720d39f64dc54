"""Kernel B1, the fused scale/cast, and its plain PyTorch version.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py`` (``scale_buffer``,
``cast_buffer``, ``_scale_buffer_impl`` and its custom VJP).  The Pallas
kernel becomes ``csrc/scale_cast.cu``, built with ``nvcc`` for
``sm_90a`` at first use and called through ctypes on PyTorch's current
stream.

``out = (x.float() * scale).to(dtype)`` for x and out in float32,
bfloat16 or float16; the scale is rounded to float32 first, as the JAX
kernel keeps it.  On a CPU tensor the wrapper computes the plain version
(:func:`scale_cast_reference`); on a CUDA tensor it launches the kernel
or raises.  ``scale_cast.launches`` counts kernel launches as the device
runs them: a launch recorded into a CUDA graph is not counted at
capture, and is counted once on each replay (``TrainStep``,
``optim/distributed_optimizer.py``, over the wrappers in
``ops.LAUNCH_COUNTED``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build, counted

# dtype codes of csrc/scale_cast.cu
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def scale_cast_reference(
    x: torch.Tensor, scale: float, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Plain version of B1: ``(x.float() * float32(scale)).to(dtype)``."""
    dtype = x.dtype if dtype is None else dtype
    return (x.float() * float(np.float32(scale))).to(dtype)


_entry = None  # the bound C function, after the first launch


def _current_stream(index: int) -> int:
    """The address of device ``index``'s current stream, without making a
    ``torch.cuda.Stream`` (PyTorch's own generated kernels read it so)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _bind():
    """``hvd_scale_cast`` of ``csrc/scale_cast.cu``, built on first use."""
    global _entry
    if _entry is None:
        fn = build.load("scale_cast").hvd_scale_cast
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def scale_cast(
    x: torch.Tensor, scale: float, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """B1 without autograd: one pass ``out = cvt_rn(float(x) * scale)``.

    CPU tensors take :func:`scale_cast_reference`.  CUDA tensors must be
    contiguous and of a supported dtype; the output comes from
    ``torch.empty_like`` and the kernel runs on the current stream of
    ``x``'s device.  The scale is rounded to float32 by the call itself
    (ctypes' ``c_float``: round to nearest even, as ``np.float32``).
    ``scale_cast.launches`` counts kernel launches."""
    dtype = x.dtype if dtype is None else dtype
    kind_in, kind_out = _KIND.get(x.dtype), _KIND.get(dtype)
    if kind_in is None or kind_out is None:
        raise TypeError(
            f"scale_cast supports float32/bfloat16/float16, got "
            f"{x.dtype} -> {dtype}"
        )
    device = x.device
    if device.type == "cpu":
        return scale_cast_reference(x, scale, dtype)
    if device.type != "cuda":
        raise ValueError(f"scale_cast: unsupported device {device}")
    if not x.is_contiguous():
        raise ValueError("scale_cast: input must be contiguous")
    out = torch.empty_like(x, dtype=dtype)
    n = x.numel()
    if n == 0:
        return out
    fn = _bind()
    args = (x.data_ptr(), kind_in, out.data_ptr(), kind_out, n, float(scale))
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, _current_stream(index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, _current_stream(index))
    if rc != 0:
        raise RuntimeError(f"scale_cast kernel launch failed: cudaError {rc}")
    scale_cast.launches += 1
    return out


counted(scale_cast)


class _ScaleBuffer(torch.autograd.Function):
    """``dx = g * scale`` through the same kernel; ``dscale = Σ g·x`` in
    float32 (``pallas_kernels.py`` ``_scale_buffer_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, dtype):
        ctx.save_for_backward(x, scale)
        return scale_cast(x, float(scale), dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dx = scale_cast(g.contiguous(), float(scale), x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (g.float() * x.float()).sum().to(scale.dtype)
        return dx, dscale, None


def scale_buffer(
    x: torch.Tensor, scale, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """``out = (x * scale).to(dtype)`` through B1, differentiable in ``x``
    and, when ``scale`` is a tensor, in ``scale``."""
    dtype = x.dtype if dtype is None else dtype
    scale_t = torch.is_tensor(scale)
    if torch.is_grad_enabled() and (
        x.requires_grad or (scale_t and scale.requires_grad)
    ):
        if not scale_t:
            scale = torch.tensor(scale, dtype=torch.float32)
        return _ScaleBuffer.apply(x, scale, dtype)
    return scale_cast(x, float(scale), dtype)


def cast_buffer(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` through B1 at scale 1 (the bf16 wire's casts);
    identity when the dtype already matches."""
    if x.dtype == dtype:
        return x
    return scale_buffer(x, 1.0, dtype)
