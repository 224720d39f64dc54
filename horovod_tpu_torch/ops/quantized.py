"""The quantized gradient wire (int8 / fp8) over the global process group.

Counterpart of ``horovod_tpu/ops/quantized.py``: the knobs
(``quant_block`` ``:97``, ``quant_backend`` ``:103``), ``_fused_mode``
(``:157``), ``_block_scale`` (``:178``), ``quantized_reduce_scatter``
(``:298``), ``quantized_all_gather`` (``:388``), ``quantized_allreduce``
(``:442``), ``quantized_allreduce_ef`` (``:476``) and the marker
compressors (``:510``); and of ``ops/pallas_quant.py``'s
``dispatch_mode`` (``:229``) and ``_account`` (``:253``).

Each collective takes one of three lowerings (:func:`dispatch`):

* ``"ring"``, the fused backend on the card: one kernel per collective,
  B6 (reduce-scatter) or B7 (all-gather) of ``ops/ring_kernels.py``,
  which quantizes each outgoing chunk and stores it straight into the
  receiving rank's window over NVLink (``ops/peer.py``), and sums the
  arrivals in float32 in hop order: the rank's own chunk, then sources
  r - 1, r - 2, ... (mod n).  It serves a world of n > 1 ranks on
  CUDA, every rank on one host, every pair of cards able to reach each
  other's memory, and a packed payload ``n·(c + 4·c/block)`` of at most
  ``peer.CAP`` bytes: the conditions of the reference's ``"tpu"`` mode.
* ``"interp"``, the fused backend off the card (gloo), as the JAX
  package's interpret path: quantize the n chunks into the packed wire
  layout (B3), one ``all_to_all_single``, the arrivals put in hop order,
  then dequant-accumulate them (B4); the all-gather is B3, one
  all-gather of the packed rows and B5 (order-free, so the same as the
  phase lowering).
* the NCCL lowering, which is the phase backend's contract and what a
  fused collective falls back to (counted in ``quant.fused_fallback``,
  as the reference counts it, a world of one included): B3, one
  ``all_to_all_single`` of the packed payload, B4 in source order
  0..n-1; B3, one all-gather, B5.  At a world of one the collectives
  are identities and are skipped; the kernels still run.

Every contribution is quantized once and summed in float32, so the
lowerings differ only in the order of the float32 sum, and the
error-feedback residual, which comes from the quantizer's dequant (B3's,
or B6's on the ring), is bitwise the same in all three.
``quant.fused_collectives`` and ``quant.fused_bytes`` count the
collectives the fused backend serves (ring or interp).  Process sets are
not ported: a ``process_set`` raises :class:`QuantizedWireError`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import metrics, runtime
from ..exceptions import QuantizedWireError
from ..utils import env
from . import peer, quant_kernels, ring_kernels
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
    family's default)."""
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


def dispatch_mode(n: int, wire_nbytes: int, on_cuda: bool, one_host: bool,
                  peers_reach: bool) -> Optional[str]:
    """How (whether) the fused backend serves a collective of ``n``
    ranks moving ``wire_nbytes`` packed bytes per rank: ``"interp"`` off
    the card, ``"ring"`` for B6/B7, ``None`` when the caller must take
    the NCCL lowering (``pallas_quant.dispatch_mode``, ``:229``: its
    ``"tpu"`` is ``"ring"``, one slice is one host, and the ICI links are
    the cards' peer access).  A world larger than the kernels' pointer
    tables (``peer.MAX_RANKS``) falls back as any other ineligible
    collective does (``_fused_mode``, ``quantized.py:157``)."""
    if n <= 1:
        return None
    if not on_cuda:
        return "interp"
    if not one_host or not peers_reach or n > peer.MAX_RANKS:
        return None
    if wire_nbytes > peer.CAP:
        return None
    return "ring"


def _peers_reach(rt) -> bool:
    """Every pair of the world's cards can reach each other's memory
    (ranks on one card need nothing).  Asked once per world."""
    if rt.peers_reach is None:
        uuids = {str(torch.cuda.get_device_properties(i).uuid): i
                 for i in range(torch.cuda.device_count())}
        index = [uuids.get(u) for u in dict.fromkeys(rt.cards)]
        rt.peers_reach = None not in index and all(
            a == b or torch.cuda.can_device_access_peer(a, b)
            for a in index for b in index
        )
    return rt.peers_reach


def dispatch(n: int, c: int, block: int, wire: str, device: torch.device,
             backend: Optional[str]) -> Optional[str]:
    """The lowering of one collective (``_fused_mode``, ``:157``): the
    fused mode when the fused backend serves it, accounted as
    ``_account`` (``pallas_quant.py:253``) accounts it, else None,
    counting ``quant.fused_fallback`` where the fused backend was asked
    for and cannot serve it."""
    resolved = quant_backend() if backend is None else _canon_backend(backend)
    if resolved != "fused":
        return None
    nbytes = n * (c * wire_itemsize(wire) + 4 * (c // block))
    on_cuda = device.type == "cuda"
    one_host = peers_reach = False
    if n > 1 and on_cuda:
        rt = runtime.get_runtime()
        one_host, peers_reach = rt.cross_size == 1, _peers_reach(rt)
    mode = dispatch_mode(n, nbytes, on_cuda, one_host, peers_reach)
    if mode is None:
        metrics.inc_counter("quant.fused_fallback")
    else:
        metrics.inc_counter("quant.fused_collectives")
        metrics.inc_counter("quant.fused_bytes", nbytes)
    return mode


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
    mode = dispatch(n, c, block, wire, flat.device, backend)
    if mode == "ring":
        window = peer.world_window(runtime.get_runtime())
        acc, deq = ring_kernels.rs_ring(flat.view(1, n * c), window, wire, block,
                                        want_deq=ef)
        mine = acc.view(c)
    else:
        packed, deq = quant_kernels.quant_packed(
            flat.view(n, c // block, block), wire, want_deq=ef
        )
        recv = packed
        if n > 1:
            recv = torch.empty_like(packed)
            dist.all_to_all_single(recv, packed)
            if mode == "interp":  # hop order: own chunk, then r-1, r-2, ...
                r = runtime.rank()
                recv = recv[[(r - t) % n for t in range(n)]]
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
    mode = dispatch(n, c, block, wire, flat.device, backend)
    if mode == "ring":
        window = peer.world_window(runtime.get_runtime())
        return ring_kernels.ag_ring(flat.view(1, c), window, wire, block).view(-1)
    packed, _ = quant_kernels.quant_packed(
        flat.view(1, c // block, block), wire, want_deq=False
    )
    rows = packed
    if n > 1:
        rows = torch.empty((n,) + packed.shape[1:], dtype=torch.int8,
                           device=packed.device)
        # all_gather_single is all_gather_into_tensor's newer name.
        getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
            rows, packed
        )
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
