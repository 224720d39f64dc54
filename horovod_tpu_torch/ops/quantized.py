"""The quantized gradient wire (int8 / fp8) over the global process group.

Counterpart of ``horovod_tpu/ops/quantized.py``: the knobs
(``quant_block`` ``:97``, ``quant_backend`` ``:103``), ``_block_scale``
(``:178``), ``quantized_reduce_scatter`` (``:298``),
``quantized_all_gather`` (``:388``), ``quantized_allreduce`` (``:442``),
``quantized_allreduce_ef`` (``:476``) and the marker compressors
(``:510``).

The lowering is the JAX GPU family's fused one over NCCL
(``ops/mosaic_quant.py:210-299``), with the collectives of
``torch.distributed``:

* reduce-scatter: pad the flat buffer to ``n·c`` (``c`` a multiple of
  the block), quantize the n chunks straight into the packed wire
  layout (kernel B3), one ``all_to_all_single`` of the packed payload
  (wire chunk and block scales together), then dequant-accumulate the
  arrivals in float32 in source-rank order 0..n-1 (kernel B4);
* all-gather: quantize the shard (B3), one all-gather of the packed
  row, dequantize every source row (kernel B5).

Each contribution is quantized once and summed in float32, the numbers
of the phase backend, which is interchangeable with the fused one per
bucket by contract (``horovod_tpu/ops/quantized.py:157-175``).  So
``HVD_TPU_QUANT_BACKEND=phase`` and ``fused`` are both accepted and both
take this lowering.  At a world of one the collectives are identities
and are skipped; the kernels still run.  Process sets are not ported: a
``process_set`` raises :class:`QuantizedWireError`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import metrics, runtime
from ..exceptions import QuantizedWireError
from ..utils import env
from . import quant_kernels
from .collectives import Average, Sum, f32_reciprocal
from .quant_kernels import WIRE_FORMATS, _block_scale  # noqa: F401

BLOCK = 512  # elements per quantization block (HVD_TPU_QUANT_BLOCK)
BACKENDS = ("phase", "fused")


def quant_block() -> int:
    """Quantization block size (``HVD_TPU_QUANT_BLOCK``, default 512)."""
    b = env.get_int(env.QUANT_BLOCK, BLOCK)
    return b if b > 0 else BLOCK


def _canon_backend(backend: Optional[str]) -> str:
    b = (backend or "phase").strip().lower()
    if b in ("", "off", "0", "none", "xla"):
        b = "phase"
    if b in ("pallas", "ring"):
        b = "fused"
    if b not in BACKENDS:
        raise QuantizedWireError(
            f"HVD_TPU_QUANT_BACKEND must be one of {BACKENDS}, "
            f"got {backend!r}"
        )
    return b


def quant_backend() -> str:
    """``HVD_TPU_QUANT_BACKEND`` when set, else ``fused`` (the JAX GPU
    family's default).  Both values take the one lowering above."""
    raw = env.get_env(env.QUANT_BACKEND)
    return "fused" if raw is None else _canon_backend(raw)


def _canon_wire(wire: str) -> str:
    w = (wire or "int8").strip().lower()
    if w == "e4m3":
        w = "fp8"
    if w not in WIRE_FORMATS:
        raise QuantizedWireError(
            f"unknown quantized wire format {wire!r}; "
            f"supported: {sorted(WIRE_FORMATS)}"
        )
    return w


def wire_itemsize(wire: str) -> int:
    """Storage bytes per element of a wire format (both are 1)."""
    return torch.empty(0, dtype=WIRE_FORMATS[_canon_wire(wire)][0]).element_size()


def _world(process_set, backend: Optional[str]) -> int:
    """Validate the set and the backend knob; the world size."""
    if process_set is not None:
        raise QuantizedWireError(
            "process sets are not ported to horovod_tpu_torch: the "
            "quantized wire serves the global set only"
        )
    if backend is None:
        quant_backend()
    else:
        _canon_backend(backend)
    return runtime.size()


def _account(n: int, c: int, block: int, wire: str) -> None:
    """``quant.fused_collectives`` / ``quant.fused_bytes``
    (``horovod_tpu/ops/pallas_quant.py:253``)."""
    metrics.inc_counter("quant.fused_collectives")
    metrics.inc_counter(
        "quant.fused_bytes", n * (c * wire_itemsize(wire) + 4 * (c // block))
    )


def quantized_reduce_scatter(
    x: torch.Tensor,
    op: int = Average,
    process_set=None,
    *,
    wire: str = "int8",
    block: Optional[int] = None,
    ef: bool = False,
    backend: Optional[str] = None,
):
    """Reduce-scatter with a quantized wire.  ``x`` is flattened; rank
    *j* returns the float32 sum (or average) of chunk *j*, of length
    ``c = ceil(V / (n·block))·block``.

    ``ef=True`` also returns the local residual ``x − dequant(quantize(x))``
    in ``x``'s shape and dtype."""
    if op not in (Sum, Average):
        raise QuantizedWireError("quantized_reduce_scatter supports Sum/Average")
    wire = _canon_wire(wire)
    block = quant_block() if block is None else block
    n = _world(process_set, backend)
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    V = flat.numel()
    c = -(-V // (n * block)) * block  # chunk length, block-aligned
    if c * n != V:
        flat = F.pad(flat, (0, c * n - V))
    packed, deq = quant_kernels.quant_packed(
        flat.view(n, c // block, block), wire, want_deq=ef
    )
    if n > 1:
        recv = torch.empty_like(packed)
        dist.all_to_all_single(recv, packed)
        _account(n, c, block, wire)
    else:
        recv = packed
    mine = quant_kernels.dequant_accum(recv, wire).view(c)
    if op == Average:
        mine = mine * f32_reciprocal(n)
    if ef:
        residual = (flat[:V] - deq.view(-1)[:V]).view(shape).to(dtype)
        return mine, residual
    return mine


def quantized_all_gather(
    shard: torch.Tensor,
    process_set=None,
    *,
    wire: str = "int8",
    block: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """All-gather with a quantized wire: quantize this rank's shard (a
    multiple of ``block`` long), gather every rank's packed row,
    dequantize.  Returns the float32 concatenation in rank order."""
    wire = _canon_wire(wire)
    block = quant_block() if block is None else block
    n = _world(process_set, backend)
    flat = shard.reshape(-1).float()
    c = flat.numel()
    if c % block != 0:
        raise QuantizedWireError(
            f"quantized_all_gather shard length {c} is not a multiple "
            f"of the quantization block ({block}); align the shard "
            "layout (HVD_TPU_QUANT_BLOCK) before gathering"
        )
    packed, _ = quant_kernels.quant_packed(
        flat.view(1, c // block, block), wire, want_deq=False
    )
    if n > 1:
        rows = torch.empty((n,) + packed.shape[1:], dtype=torch.int8,
                           device=packed.device)
        # all_gather_single is all_gather_into_tensor's newer name.
        getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
            rows, packed
        )
        _account(n, c, block, wire)
    else:
        rows = packed
    return quant_kernels.dequant_rows(rows, wire).view(-1)


def quantized_allreduce(
    x: torch.Tensor,
    op: int = Average,
    process_set=None,
    *,
    wire: str = "int8",
    block: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Quantized-wire allreduce: the two primitives composed."""
    if op not in (Sum, Average):
        raise QuantizedWireError("quantized_allreduce supports Sum/Average")
    shard = quantized_reduce_scatter(
        x, Sum, process_set, wire=wire, block=block, backend=backend
    )
    out = quantized_all_gather(
        shard, process_set, wire=wire, block=block, backend=backend
    )[:x.numel()]
    if op == Average:
        out = out * f32_reciprocal(runtime.size())
    return out.view(x.shape).to(x.dtype)


def quantized_allreduce_ef(
    x: torch.Tensor,
    residual: torch.Tensor,
    op: int = Average,
    process_set=None,
    *,
    wire: str = "int8",
    block: Optional[int] = None,
    backend: Optional[str] = None,
):
    """Error-feedback allreduce: quantize ``e = x + residual`` on the
    wire; returns ``(allreduced(e), e − dequant(quantize(e)))``."""
    e = x.float() + residual.float()
    shard, r_new = quantized_reduce_scatter(
        e, Sum, process_set, wire=wire, block=block, ef=True,
        backend=backend,
    )
    out = quantized_all_gather(
        shard, process_set, wire=wire, block=block, backend=backend
    )[:x.numel()]
    if op == Average:
        out = out * f32_reciprocal(runtime.size())
    return out.view(x.shape).to(x.dtype), r_new.view(x.shape).to(residual.dtype)


class Int8Compressor:
    """``Compression.int8``: a marker selecting the quantized wire in
    ``DistributedOptimizer``.  The quantization lives inside the
    two-phase reduction, so compress/decompress are identities."""

    quantized_wire = True
    wire_format = "int8"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class Fp8Compressor(Int8Compressor):
    """``Compression.fp8``: the float8_e4m3fn wire."""

    wire_format = "fp8"
