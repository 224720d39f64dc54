"""Kernels B3 (quantize and pack), B4 (dequant-accumulate) and B5
(dequant rows), and their plain PyTorch versions.

Counterpart of ``horovod_tpu/ops/pallas_quant.py``: ``_quant_math``
(``:79``), ``_pack_math`` / ``_unpack_math`` (``:114``, ``:126``),
``_quant_packed`` (``:150``), ``_rs_accum`` (``:174``) and
``_dequant_rows_kernel`` (``:197``), and of their Triton-lowered twins
in ``ops/mosaic_quant.py`` (``:152-205``).  The Pallas kernels become
``csrc/quant.cu``, built with ``nvcc`` for ``sm_90a`` at first use and
called through ctypes on PyTorch's current stream.

The packed wire row of one quantization block is ``block + 4`` int8
bytes: the block's int8 values (or float8_e4m3fn bit patterns), then
its float32 scale, little-endian.  Chunks and scales travel together.

The grid is the jitted JAX grid: ``amax = max|x|`` per block, divisor
``safe = amax * float32(1/qmax)`` (XLA rewrites ``amax / qmax`` into
that product under ``jit``), ``x / safe`` as an IEEE division, then
int8 round-half-to-even and clip to ±127, or the float8_e4m3fn cast
(qmax 448).  An all-zero block gets divisor 1.0 and scale 1.0; a block
holding an infinity or a NaN gets a NaN scale, so its dequant is NaN.
Its int8/fp8 values are not defined alike across XLA, PyTorch and CUDA,
so here they are 0, in the kernel and its plain version alike.  Where
``amax * (1/qmax)`` underflows to 0 (amax below qmax·2^-149) the block
is quantized as a zero block, where the JAX guard would divide by 0.

On a CPU tensor each wrapper computes its plain version; on a CUDA
tensor it launches its kernel or raises.  ``<wrapper>.launches`` counts
kernel launches as the device runs them: a launch recorded into a CUDA
graph is not counted at capture, and is counted once on each replay
(``TrainStep``, ``optim/distributed_optimizer.py``, over the wrappers in
``ops.LAUNCH_COUNTED``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, counted
from .collectives import f32_reciprocal

# wire name -> (storage dtype, qmax); codes shared with csrc/quant.cu.
WIRE_FORMATS = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
_WIRE_CODE = {"int8": 0, "fp8": 1}


def _block_scale(amax: torch.Tensor, qmax: float):
    """Per-block ``(wire_scale, safe_divisor)`` with the zero and
    non-finite guard (``horovod_tpu/ops/quantized.py:178``): a zero
    block divides by 1.0; a non-finite block (``amax`` inf or NaN) gets
    a NaN wire scale."""
    finite = torch.isfinite(amax)
    cand = amax * f32_reciprocal(qmax)
    safe = torch.where(finite & (cand > 0), cand, 1.0)
    return torch.where(finite, safe, float("nan")), safe


def quant_math_reference(x: torch.Tensor, wire: str):
    """Plain quantize of ``(..., nb, block)``: returns (q in the wire
    dtype, scale ``(..., nb, 1)`` float32, dequant float32)."""
    qdtype, qmax = WIRE_FORMATS[wire]
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)  # NaN propagates
    scale, safe = _block_scale(amax, qmax)
    finite = torch.isfinite(amax)
    scaled = xf / safe
    if wire == "int8":
        scaled = torch.clamp(torch.round(scaled), -qmax, qmax)
    q = torch.where(finite, scaled, 0.0).to(qdtype)
    return q, scale, q.float() * scale


def pack_reference(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(..., nb, block)`` wire values + ``(..., nb, 1)`` float32 scales
    -> ``(..., nb, block + 4)`` int8 rows."""
    return torch.cat([q.view(torch.int8), s.contiguous().view(torch.int8)],
                     dim=-1)


def unpack_reference(p: torch.Tensor, wire: str):
    """Inverse of :func:`pack_reference`: (q in the wire dtype, scale
    ``(..., nb, 1)`` float32)."""
    block = p.shape[-1] - 4
    q = p[..., :block].view(WIRE_FORMATS[wire][0])
    s = p[..., block:].contiguous().view(torch.float32)
    return q, s


def quant_packed_reference(x3: torch.Tensor, wire: str, want_deq: bool = False):
    """Plain version of B3: ``(m, nb, block)`` -> packed ``(m, nb,
    block + 4)`` int8 and, when ``want_deq``, the float32 dequant."""
    q, s, deq = quant_math_reference(x3, wire)
    return pack_reference(q, s), (deq if want_deq else None)


def dequant_accum_reference(recv: torch.Tensor, wire: str) -> torch.Tensor:
    """Plain version of B4: ``(n, nb, block + 4)`` arrivals -> ``(nb,
    block)`` float32 ``Σ q·s``, in arrival order, each product and each
    sum rounded to float32."""
    q, s = unpack_reference(recv, wire)
    acc = q[0].float() * s[0]
    for i in range(1, recv.shape[0]):
        acc = acc + q[i].float() * s[i]
    return acc


def dequant_rows_reference(p: torch.Tensor, wire: str) -> torch.Tensor:
    """Plain version of B5: ``(n, nb, block + 4)`` -> ``(n, nb, block)``
    float32 ``q·s``."""
    q, s = unpack_reference(p, wire)
    return q.float() * s


# ---------------------------------------------------------------- CUDA


def _library() -> ctypes.CDLL:
    lib = build.load("quant")
    if lib.hvd_quant_pack.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hvd_quant_pack.argtypes = [vp, vp, vp, ll, i, i, ctypes.c_float, vp]
        lib.hvd_dequant_accum.argtypes = [vp, vp, i, ll, i, i, vp]
        lib.hvd_dequant_rows.argtypes = [vp, vp, ll, i, i, vp]
        for fn in (lib.hvd_quant_pack, lib.hvd_dequant_accum,
                   lib.hvd_dequant_rows):
            fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, wire: str) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises on anything else."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"{name}: unknown wire {wire!r}")
    if x.dim() != 3:
        raise ValueError(f"{name}: expected a 3-D tensor, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    return True


def _launched(fn, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError {rc}")
    fn.launches += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def quant_packed(x3: torch.Tensor, wire: str, want_deq: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B3: quantize ``(m, nb, block)`` float32 into packed ``(m, nb,
    block + 4)`` int8 rows and, when ``want_deq``, the float32 dequant
    the error-feedback residual needs."""
    if not _check(x3, "quant_packed", torch.float32, wire):
        return quant_packed_reference(x3, wire, want_deq)
    m, nb, block = x3.shape
    packed = torch.empty((m, nb, block + 4), dtype=torch.int8, device=x3.device)
    deq = torch.empty_like(x3) if want_deq else None
    if x3.numel() == 0:
        return packed, deq
    with torch.cuda.device(x3.device):
        rc = _library().hvd_quant_pack(
            x3.data_ptr(), packed.data_ptr(),
            deq.data_ptr() if want_deq else None, m * nb, block,
            _WIRE_CODE[wire], f32_reciprocal(WIRE_FORMATS[wire][1]), _stream(x3),
        )
    _launched(quant_packed, rc)
    return packed, deq


def dequant_accum(recv: torch.Tensor, wire: str) -> torch.Tensor:
    """B4: ``(n, nb, block + 4)`` packed arrivals, source order -> ``(nb,
    block)`` float32 ``Σ q·s``."""
    if not _check(recv, "dequant_accum", torch.int8, wire):
        return dequant_accum_reference(recv, wire)
    n, nb, row = recv.shape
    out = torch.empty((nb, row - 4), dtype=torch.float32, device=recv.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(recv.device):
        rc = _library().hvd_dequant_accum(
            recv.data_ptr(), out.data_ptr(), n, nb, row - 4,
            _WIRE_CODE[wire], _stream(recv),
        )
    _launched(dequant_accum, rc)
    return out


def dequant_rows(p: torch.Tensor, wire: str) -> torch.Tensor:
    """B5: ``(n, nb, block + 4)`` packed rows -> ``(n, nb, block)``
    float32 ``q·s``."""
    if not _check(p, "dequant_rows", torch.int8, wire):
        return dequant_rows_reference(p, wire)
    n, nb, row = p.shape
    out = torch.empty((n, nb, row - 4), dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(p.device):
        rc = _library().hvd_dequant_rows(
            p.data_ptr(), out.data_ptr(), n * nb, row - 4,
            _WIRE_CODE[wire], _stream(p),
        )
    _launched(dequant_rows, rc)
    return out


for _fn in (quant_packed, dequant_accum, dequant_rows):
    counted(_fn)
