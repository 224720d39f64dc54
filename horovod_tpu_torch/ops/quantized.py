"""The quantized gradient wire (int8 / fp8) over the world or the groups
of a process set.

Counterpart of ``horovod_tpu/ops/quantized.py``: the knobs
(``quant_block`` ``:97``, ``quant_backend`` ``:103``), ``_fused_mode``
(``:157``), ``_block_scale`` (``:178``), ``_axis_groups`` (``:247``),
``quantized_reduce_scatter``
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
collectives the fused backend serves (ring or interp).

Groups (:func:`_axis_groups`): each collective runs over the world, over
explicit equal-size ``groups=`` (lists of ranks covering the world), or
over a process set that tiles the world into equal groups
(``process_sets.tiling_groups``).  There is no mask: on a tiling set
every rank reduces within its own group, members and non-members alike
(``quantized.py:339-386``), ``n`` is the group's size, the interp hop
order runs over the rank's position in its group, and an Average
divides by ``n``.  A set that does not tile raises
:class:`ProcessSetTilingError`.  On the card groups never take the
ring, whose peer window spans the world (``pallas_quant.py:242``): the
collective takes the NCCL lowering on the group, counted in
``quant.fused_fallback``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import metrics, runtime
from ..exceptions import ProcessSetTilingError, QuantizedWireError
from ..process_sets import resolve
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


class Groups:
    """Where one quantized collective runs: ``tiles`` (the equal groups of
    ranks covering the world, None for the world itself), ``n`` (the
    group's size), ``group`` (this rank's ``torch.distributed`` group;
    None for the default group) and ``pos`` (this rank's position in
    it)."""

    __slots__ = ("tiles", "n", "group", "pos")

    def __init__(self, tiles, n: int, group, pos: int):
        self.tiles, self.n, self.group, self.pos = tiles, n, group, pos


def _explicit_groups(rt, groups: Sequence[Sequence[int]]) -> Groups:
    """Explicit equal-size ``groups``: validated as the JAX package does
    (``quantized.py:266-276``), their ``torch.distributed`` groups made
    on every rank at first use and kept by the runtime."""
    tiles = [sorted(int(r) for r in g) for g in groups]
    sizes = {len(g) for g in tiles}
    flat = sorted(r for g in tiles for r in g)
    if len(sizes) != 1 or flat != list(range(rt.size)):
        raise ProcessSetTilingError(
            groups[0] if groups else (), rt.size, "quantized wire explicit groups")
    key = tuple(tuple(g) for g in tiles)
    made = rt.wire_groups.get(key)
    if made is None:
        made = rt.wire_groups[key] = [
            dist.new_group(g) if rt.size > 1 else None for g in tiles]
    for g, group in zip(tiles, made):
        if rt.rank in g:
            return Groups(tiles, len(g), group, g.index(rt.rank))
    raise AssertionError("the groups cover every rank")


def _axis_groups(process_set, groups=None) -> Groups:
    """Resolve where a quantized collective runs (``quantized.py:247``
    ``_axis_groups``): explicit equal-size ``groups`` (lists of ranks, or
    a :class:`Groups` whose ``torch.distributed`` group its caller owns,
    as a mesh does), else the process set through its tiles (the
    table's, ``process_sets.tiling_groups``), else the world.  Raises
    :class:`QuantizedWireError` for both arguments together and
    :class:`ProcessSetTilingError` for a set that does not tile the
    world."""
    rt = runtime.get_runtime()
    if groups is not None:
        if process_set is not None:
            raise QuantizedWireError("pass either groups= or process_set=, not both")
        if isinstance(groups, Groups):
            return groups
        return _explicit_groups(rt, groups)
    ps = resolve(process_set)
    if ps is None:
        return Groups(None, rt.size, None, rt.rank)
    sg = rt.process_set_table.groups(ps.process_set_id)
    if sg.tiles is None:
        raise ProcessSetTilingError(ps.ranks, rt.size,
                                    "quantized wire over the 'hvd' axis")
    return Groups(sg.tiles, len(sg.tile_ranks), sg.tile, sg.tile_ranks.index(rt.rank))


def _check_backend(backend: Optional[str]) -> None:
    if backend is None:
        quant_backend()
    else:
        _canon_backend(backend)


def dispatch_mode(n: int, wire_nbytes: int, on_cuda: bool, one_host: bool,
                  peers_reach: bool, grouped: bool = False) -> Optional[str]:
    """How (whether) the fused backend serves a collective of ``n``
    ranks moving ``wire_nbytes`` packed bytes per rank: ``"interp"`` off
    the card, ``"ring"`` for B6/B7, ``None`` when the caller must take
    the NCCL lowering (``pallas_quant.dispatch_mode``, ``:229``: its
    ``"tpu"`` is ``"ring"``, one slice is one host, and the ICI links are
    the cards' peer access).  A world larger than the kernels' pointer
    tables (``peer.MAX_RANKS``) falls back as any other ineligible
    collective does (``_fused_mode``, ``quantized.py:157``), and so does
    a collective on groups (``grouped``: a process set's tiles or
    explicit groups, ``:242``), since the ring's peer window spans the
    world."""
    if n <= 1:
        return None
    if not on_cuda:
        return "interp"
    if grouped:
        return None
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
             backend: Optional[str], grouped: bool = False) -> Optional[str]:
    """The lowering of one collective (``_fused_mode``, ``:157``): the
    fused mode when the fused backend serves it, accounted as
    ``_account`` (``pallas_quant.py:253``) accounts it, else None,
    counting ``quant.fused_fallback`` where the fused backend was asked
    for and cannot serve it (``grouped``: on groups, not the world)."""
    resolved = quant_backend() if backend is None else _canon_backend(backend)
    if resolved != "fused":
        return None
    nbytes = n * (c * wire_itemsize(wire) + 4 * (c // block))
    on_cuda = device.type == "cuda"
    one_host = peers_reach = False
    if n > 1 and on_cuda and not grouped:
        rt = runtime.get_runtime()
        one_host, peers_reach = rt.cross_size == 1, _peers_reach(rt)
    mode = dispatch_mode(n, nbytes, on_cuda, one_host, peers_reach, grouped)
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
    groups: Optional[Sequence[Sequence[int]]] = None,
):
    """Reduce-scatter with a quantized wire over the world, explicit
    equal-size ``groups`` or the tiles of ``process_set``
    (:func:`_axis_groups`).  ``x`` is flattened; the rank at position
    *j* of its group returns the float32 sum (or average) of chunk *j*
    over the group, of length ``c = ceil(V / (n·block))·block``.

    ``ef=True`` also returns the local residual ``x − dequant(quantize(x))``
    in ``x``'s shape and dtype."""
    if op not in (Sum, Average):
        raise QuantizedWireError("quantized_reduce_scatter supports Sum/Average")
    wire = _canon_wire(wire)
    block = quant_block() if block is None else block
    _check_backend(backend)
    where = _axis_groups(process_set, groups)
    n, grouped = where.n, where.tiles is not None
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    V = flat.numel()
    c = -(-V // (n * block)) * block  # chunk length, block-aligned
    if c * n != V:
        flat = F.pad(flat, (0, c * n - V))
    mode = dispatch(n, c, block, wire, flat.device, backend, grouped)
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
            dist.all_to_all_single(recv, packed, group=where.group)
            if mode == "interp":  # hop order: own chunk, then p-1, p-2, ...
                p = where.pos
                recv = recv[[(p - t) % n for t in range(n)]]
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
    groups: Optional[Sequence[Sequence[int]]] = None,
) -> torch.Tensor:
    """All-gather with a quantized wire over the world or this rank's
    group (:func:`_axis_groups`): quantize this rank's shard (a multiple
    of ``block`` long), gather every group member's packed row,
    dequantize.  Returns the float32 concatenation in group order."""
    wire = _canon_wire(wire)
    block = quant_block() if block is None else block
    _check_backend(backend)
    where = _axis_groups(process_set, groups)
    n = where.n
    flat = shard.reshape(-1).float()
    c = flat.numel()
    if c % block != 0:
        raise QuantizedWireError(
            f"quantized_all_gather shard length {c} is not a multiple "
            f"of the quantization block ({block}); align the shard "
            "layout (HVD_TPU_QUANT_BLOCK) before gathering"
        )
    mode = dispatch(n, c, block, wire, flat.device, backend, where.tiles is not None)
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
            rows, packed, group=where.group
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
    groups: Optional[Sequence[Sequence[int]]] = None,
) -> torch.Tensor:
    """Quantized-wire allreduce: the two primitives composed, averaged
    over the group's size."""
    if op not in (Sum, Average):
        raise QuantizedWireError("quantized_allreduce supports Sum/Average")
    shard = quantized_reduce_scatter(
        x, Sum, process_set, wire=wire, block=block, backend=backend, groups=groups
    )
    out = quantized_all_gather(
        shard, process_set, wire=wire, block=block, backend=backend, groups=groups
    )[:x.numel()]
    if op == Average:
        out = out * f32_reciprocal(_axis_groups(process_set, groups).n)
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
        out = out * f32_reciprocal(_axis_groups(process_set).n)
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
