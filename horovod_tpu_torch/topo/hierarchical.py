"""Phase-primitive hierarchical collectives over a factored world.

Counterpart of ``horovod_tpu/topo/hierarchical.py``.  The two-level
decomposition (reference ``NCCLHierarchicalAllreduce``,
``nccl_operations.cc:234``):

    intra-domain reduce_scatter (ici: NVLink)   1/k shard, domain-summed
    cross-domain all_reduce     (dcn: IB, 1/k)  the only slow-network hop
    intra-domain all_gather     (ici)           full buffer back

Each dcn link carries ``1/k`` of the flat lowering's payload (k = ranks
per domain).  Two addressing modes, as in the JAX package
(``_hier_ctx`` ``:66``):

* **groups** (``axis`` a name): the world (``"hvd"``), or one axis of a
  ``parallel/mesh.py`` mesh (``mesh=``), factored by the topology
  (``topo/model.py`` ``factor_axis``, ``axis_groups``).  The intra and
  cross groups of every tile of the axis are ``torch.distributed``
  groups, made on every rank, in one order, the first time a context
  for that layout is asked for (:func:`phase_context`; the plan of
  ``DistributedOptimizer`` asks on the calling thread, never the
  exchange worker or a backward hook), and kept by the runtime until
  ``shutdown``.
* **axes** (``axis`` a pair of names, ``mesh=`` required): two axes of
  the mesh, the outer the dcn hop and the inner the ici phases, as made
  by ``parallel/mesh.py`` ``split_axis``; the mesh's own groups.

The quantized wire composes per hop: ``wire="int8"|"fp8"`` quantizes
only the cross-domain collective (``ops/quantized.py`` on the cross
groups: kernels B3-B5; B6 and B7 fall back on groups, counted in
``quant.fused_fallback``); ``wire="bf16"`` casts just that hop (kernel
B1 down and back).  A single-domain topology, or an axis that does not
factor, lowers flat, bitwise the collective it replaces.

:func:`hierarchical_adasum_all_reduce`, the ``hier_adasum`` lowering,
keeps the same three phases but combines across domains with Adasum's
adaptive summation (arXiv:2006.02924) on the 1/k shard: one all_gather
of every domain's shard over the cross group, then the pair tree on
local compute with the full-vector dot products and norms summed by one
3-scalar-per-pair all_reduce per level.  Every collective here is a
collective (no point-to-point hop), so a hierarchical bucket is
captured into a CUDA graph on NCCL as the flat one is.

Every cross-domain hop fires the ``topo.dcn_phase`` fault site
(``faults.py``; ``phase=``, ``wire=`` and ``rank=`` context) on the host
before it issues its collective, as the JAX package fires it inside the
hop's trace span (``:123-136``): an armed ``slow`` fault delays exactly
the injected rank's hop.  The JAX package's ``trace.span`` around each
phase has no counterpart here yet (the port has no tracer).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import runtime
from ..exceptions import HorovodTpuError
from ..ops.adasum import coefficients
from ..ops.collectives import Average, Sum, f32_reciprocal
from . import model

Axis = Union[str, Tuple[str, str], Sequence[str]]
WORLD_AXIS = "hvd"


class HierContext:
    """Where each phase of one rank's hierarchical collective runs: ``s``
    domains of ``k`` ranks; the ``torch.distributed`` groups of this
    rank's domain (``intra``), of its rail across domains (``cross``,
    with ``cross_where``, the quantized wire's ``Groups`` of it) and of
    the whole axis (``axis_group``; None: the default group).
    ``cross_ranks`` lists the global ranks of this rank's rail."""

    __slots__ = ("s", "k", "intra", "cross", "cross_where", "axis_group", "cross_ranks")

    def __init__(self, s, k, intra, cross, cross_where, axis_group, cross_ranks):
        self.s, self.k = s, k
        self.intra, self.cross, self.cross_where = intra, cross, cross_where
        self.axis_group, self.cross_ranks = axis_group, cross_ranks


def _new_group(rt, ranks):
    import datetime

    return dist.new_group(ranks, timeout=datetime.timedelta(seconds=rt.timeout_s))


def _groups_ctx(tiles: List[List[int]], s: int, k: int, intra_pos, cross_pos,
                axis_group) -> HierContext:
    """The context of a factored layout: ``tiles`` (each a list of global
    ranks in axis order) split by the position lists ``intra_pos`` and
    ``cross_pos``.  The groups of every tile are made on every rank, in
    tile order, intra first, at the first call for this layout.  Each
    list must be in rank order: a ``torch.distributed`` group orders its
    members by rank, and the collectives' chunks follow that order as
    the JAX package's follow the listed one."""
    from ..ops.quantized import Groups

    rt = runtime.get_runtime()
    key = (tuple(tuple(t) for t in tiles), s, k)
    made = rt.topo_groups.get(key)
    if made is None:
        made = {}
        for tile in tiles:
            for kind, lists in (("intra", intra_pos), ("cross", cross_pos)):
                for pos in lists:
                    ranks = [tile[p] for p in pos]
                    if ranks != sorted(ranks):
                        raise HorovodTpuError(f"hierarchical group {ranks} is not in "
                                              "rank order")
                    group = _new_group(rt, ranks)
                    if rt.rank in ranks:
                        made[kind] = (group, ranks)
                    made.setdefault("all_" + kind, []).append(ranks)
        rt.topo_groups[key] = made
    cross_group, cross_ranks = made["cross"]
    where = Groups([sorted(r) for r in made["all_cross"]], s, cross_group,
                   cross_ranks.index(rt.rank))
    return HierContext(s, k, made["intra"][0], cross_group, where, axis_group,
                       cross_ranks)


def grid_context(local_groups: List[List[int]], cross_groups: List[List[int]]
                 ) -> HierContext:
    """The context of an explicit world grid: ``local_groups`` (each
    domain's ranks) and ``cross_groups`` (the i-th rank of every domain),
    as ``ops/adasum.py``'s two-level schedule gives them."""
    n = runtime.size()
    return _groups_ctx([list(range(n))], len(local_groups), len(local_groups[0]),
                       local_groups, cross_groups, None)


def _hier_ctx(axis: Axis, topo: Optional[model.Topology], mesh=None
              ) -> Optional[HierContext]:
    """The hierarchy of ``axis`` (``horovod_tpu/topo/hierarchical.py:66``),
    or None when it does not factor (single domain or indivisible) and
    callers lower flat."""
    if isinstance(axis, (tuple, list)):
        names = tuple(axis)
        if len(names) != 2 or not all(isinstance(a, str) for a in names):
            raise HorovodTpuError(
                "factored-axis hierarchical collectives take exactly "
                f"two sub-axis names (outer=DCN, inner=ICI); got {axis!r}"
            )
        if mesh is None:
            raise HorovodTpuError("factored-axis hierarchical collectives need mesh=")
        from ..ops.quantized import Groups

        outer, inner = names
        s, k = mesh.axis_size(outer), mesh.axis_size(inner)
        if s == 1 or k == 1:
            return None
        where = Groups(mesh.tiles(outer), s, mesh.group(outer),
                       mesh.ranks(outer).index(mesh.rank))
        return HierContext(s, k, mesh.group(inner), mesh.group(outer), where,
                           mesh.group((outer, inner)), mesh.ranks(outer))
    topo = topo if topo is not None else model.current()
    if mesh is None:
        if axis != WORLD_AXIS:
            raise HorovodTpuError(f"axis {axis!r} needs mesh= (the world is {WORLD_AXIS!r})")
        tiles = [list(range(runtime.size()))]
        axis_group = None
    else:
        tiles = mesh.tiles(axis)
        axis_group = mesh.group(axis)
    n = len(tiles[0])
    s, k = topo.factor_axis(n)
    if s == 1 or k == 1:
        return None
    intra, cross = topo.axis_groups(n)
    return _groups_ctx(tiles, s, k, intra, cross, axis_group)


def _axis_size(axis: Axis, mesh) -> int:
    if mesh is None:
        return runtime.size()
    if isinstance(axis, (tuple, list)):
        return mesh.axis_size(axis[0]) * mesh.axis_size(axis[1])
    return mesh.axis_size(axis)


def _flat_sum(x: torch.Tensor, axis: Axis, mesh) -> torch.Tensor:
    group = None if mesh is None else mesh.group(tuple(axis) if isinstance(
        axis, (tuple, list)) else axis)
    y = x.contiguous().clone()
    if _axis_size(axis, mesh) > 1:
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _ici_reduce_scatter(flat: torch.Tensor, ctx: HierContext) -> torch.Tensor:
    from ..ops.collectives import _reduce_scatter

    out = flat.new_empty((flat.numel() // ctx.k,))
    _reduce_scatter(out, flat.contiguous(), op=dist.ReduceOp.SUM, group=ctx.intra)
    return out


def _ici_all_gather(shard: torch.Tensor, ctx: HierContext) -> torch.Tensor:
    from ..ops.collectives import _all_gather

    out = shard.new_empty((shard.numel() * ctx.k,))
    _all_gather(out, shard.contiguous(), group=ctx.intra)
    return out


def _dcn_sum_dense(shard: torch.Tensor, ctx: HierContext) -> torch.Tensor:
    out = shard.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.cross)
    return out


def _quantized(wire: str, t: torch.Tensor) -> bool:
    return (wire or "off").lower() in ("int8", "fp8") and t.is_floating_point()


def _bf16(wire: str, t: torch.Tensor) -> bool:
    return ((wire or "off").lower() == "bf16" and t.is_floating_point()
            and t.dtype != torch.bfloat16)


def _dcn_fault(phase: str, wire: str) -> None:
    """The ``topo.dcn_phase`` fault site of one cross-domain hop (JAX
    ``_dcn_trace`` ``:123``)."""
    from .. import faults

    faults.inject("topo.dcn_phase", phase=phase, wire=wire, rank=runtime.rank())


# --------------------------------------------------------- phase API
#
# The exact primitives the monolithic entry points below are built
# from (``:159-235``): same groups, same op order, same padding.

def phase_context(axis: Axis = WORLD_AXIS, topo: Optional[model.Topology] = None,
                  mesh=None) -> Optional[HierContext]:
    """The hierarchy of ``axis`` for phase-at-a-time emission, or None
    when it does not factor (callers lower flat).  Makes the layout's
    groups on first use (every rank must call it alike)."""
    return _hier_ctx(axis, topo, mesh)


def ici_reduce_scatter_phase(flat: torch.Tensor, ctx: HierContext) -> torch.Tensor:
    """Intra-domain reduce_scatter: full buffer -> domain-summed 1/k
    shard.  ``flat`` must be 1-D and k-divisible (callers pad)."""
    return _ici_reduce_scatter(flat, ctx)


def ici_all_gather_phase(shard: torch.Tensor, ctx: HierContext) -> torch.Tensor:
    """Intra-domain all_gather: 1/k shard -> full buffer."""
    return _ici_all_gather(shard, ctx)


def dcn_sum_phase(shard: torch.Tensor, ctx: HierContext, wire: str = "off") -> torch.Tensor:
    """Cross-domain all_reduce of the 1/k shard; ``wire`` compresses only
    this leg."""
    return _dcn_sum(shard, ctx, wire)


def dcn_reduce_scatter_phase(shard_k: torch.Tensor, ctx: HierContext,
                             wire: str = "off") -> torch.Tensor:
    """Cross-domain reduce_scatter of the domain-summed 1/k shard."""
    _dcn_fault("dcn_rs", wire)
    if _quantized(wire, shard_k):
        from ..ops.quantized import quantized_reduce_scatter

        return quantized_reduce_scatter(shard_k, Sum, wire=wire,
                                        groups=ctx.cross_where).to(shard_k.dtype)
    from ..ops.collectives import _reduce_scatter

    out = shard_k.new_empty((shard_k.numel() // ctx.s,))
    _reduce_scatter(out, shard_k.contiguous(), op=dist.ReduceOp.SUM, group=ctx.cross)
    return out


def dcn_all_gather_phase(shard: torch.Tensor, ctx: HierContext,
                         wire: str = "off") -> torch.Tensor:
    """Cross-domain all_gather, inverse of :func:`dcn_reduce_scatter_phase`."""
    _dcn_fault("dcn_ag", wire)
    if _quantized(wire, shard):
        from ..ops.quantized import quantized_all_gather

        return quantized_all_gather(shard, wire=wire,
                                    groups=ctx.cross_where).to(shard.dtype)
    from ..ops.collectives import _all_gather

    out = shard.new_empty((shard.numel() * ctx.s,))
    _all_gather(out, shard.contiguous(), group=ctx.cross)
    return out


def dcn_all_reduce(shard: torch.Tensor, axis: Axis = WORLD_AXIS,
                   topo: Optional[model.Topology] = None, *, wire: str = "off",
                   mesh=None) -> torch.Tensor:
    """Sum ``shard`` across domains only (the dcn hop on its own);
    identity on a single-domain topology."""
    ctx = _hier_ctx(axis, topo, mesh)
    if ctx is None:
        return shard
    return _dcn_sum(shard, ctx, wire)


def _dcn_sum(shard: torch.Tensor, ctx: HierContext, wire: str) -> torch.Tensor:
    """``:254``: dense; bf16 through kernel B1 (down, sum, up); int8/fp8
    through the quantized allreduce on the cross groups (B3-B5)."""
    _dcn_fault("dcn_ar", wire)
    if _quantized(wire, shard):
        from ..ops.quantized import quantized_allreduce

        return quantized_allreduce(shard, Sum, wire=wire,
                                   groups=ctx.cross_where).to(shard.dtype)
    if _bf16(wire, shard):
        from ..ops.kernels import cast_buffer

        return cast_buffer(_dcn_sum_dense(cast_buffer(shard, torch.bfloat16), ctx),
                           shard.dtype)
    return _dcn_sum_dense(shard, ctx)


def _psum_all(v: torch.Tensor, ctx: HierContext) -> torch.Tensor:
    dist.all_reduce(v, op=dist.ReduceOp.SUM, group=ctx.axis_group)
    return v


def _adasum_tree(parts: List[torch.Tensor], ctx: HierContext) -> torch.Tensor:
    """Adasum binary tree over the per-domain float32 rail shards
    (``:282``): each level batches its pairs' ``[dot, |a|², |b|²]`` into
    one ``(npairs, 3)`` all_reduce over the whole axis; every rail's
    scalars are replicated on the ``s`` members of its cross group, so
    the sum overcounts by exactly ``s`` and is divided back.  A
    non-power-of-two domain count folds its stragglers first."""
    s = len(parts)

    def combine(pairs):
        scal = torch.stack([
            torch.stack([torch.sum(a * b), torch.sum(a * a), torch.sum(b * b)])
            for a, b in pairs
        ])
        sums = _psum_all(scal, ctx) / s
        ca, cb = coefficients(sums)
        return [ca[i] * a + cb[i] * b for i, (a, b) in enumerate(pairs)]

    vals = list(parts)
    p = 1 << (s.bit_length() - 1)
    extras = s - p
    if extras:
        folded = combine([(vals[i], vals[p + i]) for i in range(extras)])
        vals = folded + vals[extras:p]
    while len(vals) > 1:
        vals = combine([(vals[2 * i], vals[2 * i + 1]) for i in range(len(vals) // 2)])
    return vals[0]


def _dcn_adasum(shard: torch.Tensor, ctx: HierContext, wire: str) -> torch.Tensor:
    """Cross-domain adaptive summation on the 1/k shard (``:328``): one
    all_gather of every domain's shard over the cross group (the only
    bulk dcn payload, and the only leg a quantized or bf16 ``wire``
    compresses), then :func:`_adasum_tree` in float32 on local compute."""
    s, dtype, L = ctx.s, shard.dtype, shard.numel()
    _dcn_fault("dcn_adasum", (wire or "off").lower())
    if _quantized(wire, shard):
        from ..ops.quantized import quantized_all_gather

        gathered = quantized_all_gather(shard.float(), wire=wire,
                                        groups=ctx.cross_where)[: s * L]
    else:
        from ..ops.collectives import _all_gather
        from ..ops.kernels import cast_buffer

        g = cast_buffer(shard, torch.bfloat16) if _bf16(wire, shard) else shard
        gathered = g.new_empty((s * L,))
        _all_gather(gathered, g.contiguous(), group=ctx.cross)
        if g.dtype != dtype:
            gathered = cast_buffer(gathered, torch.float32)
    parts = gathered.float().view(s, L)
    out = _adasum_tree([parts[j] for j in range(s)], ctx)
    return out.to(dtype)


def dcn_adasum(shard: torch.Tensor, axis: Axis = WORLD_AXIS,
               topo: Optional[model.Topology] = None, *, wire: str = "off",
               mesh=None) -> torch.Tensor:
    """Adaptively combine ``shard`` across domains only (``:370``);
    identity on a single-domain topology."""
    ctx = _hier_ctx(axis, topo, mesh)
    if ctx is None:
        return shard
    return _dcn_adasum(shard, ctx, wire)


def _pad(flat: torch.Tensor, unit: int) -> torch.Tensor:
    pad = (-flat.numel()) % unit
    return F.pad(flat, (0, pad)) if pad else flat


def _average(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y / n``: times float32(1/n) (``collectives.f32_reciprocal``), an
    integer ``y`` truncated."""
    if y.is_floating_point():
        return y * f32_reciprocal(n)
    return torch.div(y, n, rounding_mode="trunc")


def hierarchical_adasum_all_reduce(x: torch.Tensor, axis: Axis = WORLD_AXIS,
                                   op: int = Average,
                                   topo: Optional[model.Topology] = None, *,
                                   wire: str = "off", mesh=None) -> torch.Tensor:
    """Two-level adaptive-summation allreduce, the ``hier_adasum``
    lowering (``:388``): intra-domain reduce_scatter, Adasum across
    domains on the 1/k shard, intra-domain all_gather.  ``op=Average``
    returns the Adasum of per-domain *mean* gradients (the reference's
    ``AdasumGpuAllreduceOp`` postscale), ``op=Sum`` of per-domain sums.
    On an int8/fp8 ``wire`` the buffer is padded to k·block, so each
    rank's shard quantizes in whole blocks.  A single-domain topology
    lowers to the flat sum (mean)."""
    if op not in (Sum, Average):
        raise HorovodTpuError(
            "hierarchical_adasum_all_reduce supports Sum/Average slice "
            "reductions (the cross-slice combine is always Adasum)"
        )
    if not x.is_floating_point():
        raise HorovodTpuError(
            "hier_adasum needs a floating dtype: the pair coefficients "
            "divide by gradient norms (integer buckets lower flat)"
        )
    ctx = _hier_ctx(axis, topo, mesh)
    if ctx is None:
        y = _flat_sum(x, axis, mesh)
        if op == Average:
            y = _average(y, _axis_size(axis, mesh))
        return y.to(x.dtype)
    shape, dtype, V = x.shape, x.dtype, x.numel()
    unit = ctx.k
    if _quantized(wire, x):
        from ..ops.quantized import quant_block

        unit *= quant_block()
    shard = _ici_reduce_scatter(_pad(x.reshape(-1), unit), ctx)
    if op == Average:
        shard = _average(shard, ctx.k)  # slice mean: Adasum combines averages
    shard = _dcn_adasum(shard, ctx, wire)
    return _ici_all_gather(shard, ctx)[:V].view(shape).to(dtype)


def hierarchical_all_reduce(x: torch.Tensor, axis: Axis = WORLD_AXIS, op: int = Average,
                            topo: Optional[model.Topology] = None, *,
                            wire: str = "off", mesh=None) -> torch.Tensor:
    """Two-level allreduce (``:449``): ici reduce_scatter, dcn all_reduce
    on the 1/k shard, ici all_gather.  Equal to the flat sum up to the
    order of the float sums (bitwise on exactly representable sums);
    the buffer is padded to k (a quantized dcn hop pads its shard to
    its own blocks).  Lowers flat when the axis does not factor."""
    if op not in (Sum, Average):
        raise HorovodTpuError(
            "hierarchical_all_reduce supports Sum/Average (min/max "
            "gain nothing from staging — use the flat collective)"
        )
    ctx = _hier_ctx(axis, topo, mesh)
    if ctx is None:
        y = _flat_sum(x, axis, mesh)
        return _average(y, _axis_size(axis, mesh)) if op == Average else y
    shape, dtype, V = x.shape, x.dtype, x.numel()
    shard = _ici_reduce_scatter(_pad(x.reshape(-1), ctx.k), ctx)
    shard = _dcn_sum(shard, ctx, wire)
    out = _ici_all_gather(shard, ctx)[:V].view(shape)
    if op == Average:
        out = _average(out, ctx.s * ctx.k)
    return out.to(dtype)


def hierarchical_reduce_scatter(x: torch.Tensor, axis: Axis = WORLD_AXIS, op: int = Sum,
                                topo: Optional[model.Topology] = None, *,
                                wire: str = "off", mesh=None) -> torch.Tensor:
    """Two-level reduce-scatter to a 1/(s·k) shard (``:490``): ici
    reduce_scatter to 1/k, then dcn reduce_scatter over the rails.  The
    shard layout is the hierarchy's own, inverted exactly by
    :func:`hierarchical_all_gather`."""
    if op not in (Sum, Average):
        raise HorovodTpuError("hierarchical_reduce_scatter supports Sum/Average")
    ctx = _hier_ctx(axis, topo, mesh)
    flat = x.reshape(-1)
    if ctx is None:
        from ..ops.collectives import _reduce_scatter

        n = _axis_size(axis, mesh)
        flat = _pad(flat, n)
        shard = flat.new_empty((flat.numel() // n,))
        group = None if mesh is None else mesh.group(axis)
        _reduce_scatter(shard, flat.contiguous(), op=dist.ReduceOp.SUM, group=group)
        return _average(shard, n) if op == Average else shard
    unit = ctx.k * ctx.s
    if _quantized(wire, x):
        from ..ops.quantized import quant_block

        unit *= quant_block()
    shard_k = _ici_reduce_scatter(_pad(flat, unit), ctx)
    shard = dcn_reduce_scatter_phase(shard_k, ctx, wire)
    return _average(shard, ctx.s * ctx.k) if op == Average else shard


def hierarchical_all_gather(shard: torch.Tensor, axis: Axis = WORLD_AXIS,
                            topo: Optional[model.Topology] = None, *,
                            wire: str = "off", mesh=None) -> torch.Tensor:
    """Inverse of :func:`hierarchical_reduce_scatter` (``:541``): dcn
    all_gather over the rails, then ici all_gather; the full (padded)
    buffer."""
    ctx = _hier_ctx(axis, topo, mesh)
    if ctx is None:
        from ..ops.collectives import _all_gather

        n = _axis_size(axis, mesh)
        out = shard.new_empty((shard.numel() * n,))
        group = None if mesh is None else mesh.group(axis)
        _all_gather(out, shard.contiguous(), group=group)
        return out
    return _ici_all_gather(dcn_all_gather_phase(shard, ctx, wire), ctx)
