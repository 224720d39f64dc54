"""Collectives over the global process group or a process set's group.

Counterpart of ``horovod_tpu/ops/traced.py``: the
reduce ops (``:49-63``), ``_scale`` (``:94-105``), ``allreduce_`` over
every op (``:313-400``; Adasum through ``ops/adasum.py``, ``:338-345``),
``allgather`` (``:439``),
``broadcast_`` (``:479``), ``reducescatter`` (``:526-566``), ``alltoall``
(``:569-600``), ``barrier`` (``:603``) and ``join_average``
(``:610-633``).  Where the JAX package emits XLA collectives inside the
compiled step, these are ``torch.distributed`` calls on this rank's
tensor (NCCL on the card, gloo on the CPU).  Each may be started with
``async_op=True``, which returns a :class:`Pending` in place of the
result; ``ops/eager.py`` builds the eager API's handles on it.

``HVD_TPU_HIERARCHICAL_ALLREDUCE`` (``:328-357``), or ``hierarchical=True``
(what a tuned optimizer passes; the JAX package's
``set_hierarchical_override`` has no counterpart), stages a
world Sum or Average as an intra-host reduce-scatter, a cross-host sum
of the shard and an intra-host all-gather (:func:`_hierarchical_sum`,
``:281``), on the host grid of :func:`host_groups`; anything that is not
a full-world homogeneous grid stays flat.

Average is SUM followed by a postscale of ``1/size``, as the reference
rewrites it (``operations.cc:1396-1399``) and the JAX package keeps it:
``ReduceOp.AVG`` is never used, since gloo refuses it for a world above
one and it would round differently from ``_scale``.  Product gathers
every rank's tensor and multiplies the rows in rank order, in float32
for f16/bf16, as ``jnp.prod`` does on the JAX package's gather
(``traced.py:384-393``): ``ReduceOp.PRODUCT`` would multiply in the
ring's order.

Each op takes a ``process_set`` (``process_sets.py``; None or id 0 is
the world).  A member runs the collective on the set's group: Average
divides by the set's size, a broadcast's ``root_rank`` is the set's
rank (the group's ``src`` is the global rank ``ranks[root_rank]``), and
rows gather in set order.  A non-member enters no collective and
returns its row of the JAX op (``traced.py``): its own input for
allreduce and broadcast (``:397-399``, ``:519-523``), zeros for
allgather, reducescatter and alltoall (``:479-480``, ``:554-556``,
``:592-597``, the rows of a set that tiles the world).  The JAX
package's rows for a set that does not tile, below its
``HVD_TPU_SET_RING_THRESHOLD``, come out of a masked whole-world sum
instead (``:487-492``, ``:560-565``); the port has a group per set, as
the reference has a communicator per set, so it has no such lowering
(ROADMAP Queue C, standing divergence).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..process_sets import member_group, resolve
from ..utils import env
from . import kernels


class ReduceOp:
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OPS = {Sum: dist.ReduceOp.SUM, Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}

def hierarchical_enabled() -> bool:
    """``HVD_TPU_HIERARCHICAL_ALLREDUCE``."""
    return env.get_bool(env.HIERARCHICAL_ALLREDUCE, False)


# The newer names of all_gather_into_tensor and reduce_scatter_tensor,
# where this torch has them (the older ones warn there).
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


class Pending:
    """A collective in flight: the ``torch.distributed`` works it started
    and ``finish``, which makes the result from their outputs once they
    are done.  ``is_completed()`` polls the works; ``wait()`` waits for
    them (on NCCL the current stream waits, not the host) and returns
    ``finish()``."""

    def __init__(self, works: Sequence, finish: Callable):
        self.works = [w for w in works if w is not None]
        self.finish = finish

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self.works)

    def wait(self):
        for w in self.works:
            w.wait()
        return self.finish()


def _run(works: Sequence, finish: Callable, async_op: bool):
    """The result, or with ``async_op`` the :class:`Pending` that makes it
    (a synchronous call's works are None: it is done)."""
    pending = Pending(works, finish)
    return pending if async_op else pending.wait()


def f32_reciprocal(n: float) -> float:
    """``float32(1 / n)``.  Under ``jit`` XLA turns ``x / n`` by a
    constant (``lax.pmean``, the quantized wire's averages and scales)
    into ``x * float32(1 / n)``; multiplying by this keeps the port
    bitwise with the JAX package at any world size."""
    return float(np.float32(1.0) / np.float32(n))


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * factor`` in the JAX package's precision rules: f16/bf16 scale
    in float32 and round back (kernel B1 on the card), integers scale in
    float32 and truncate, float32 multiplies by ``float32(factor)``."""
    if factor == 1.0:
        return x
    if x.dtype in (torch.float16, torch.bfloat16):
        return kernels.scale_buffer(x, factor, x.dtype)
    if not x.dtype.is_floating_point:
        return (x.float() * factor).to(x.dtype)
    return x * factor


def _product(rows: torch.Tensor) -> torch.Tensor:
    """The product of ``rows`` along dim 0, in rank order; f16/bf16 in
    float32, rounded once."""
    acc = rows[0].float() if rows.dtype in (torch.float16, torch.bfloat16) else rows[0]
    for row in rows[1:]:
        acc = acc * row
    return acc.to(rows.dtype)


def host_groups():
    """``(local_groups, cross_groups)`` of the world's host grid, or None
    (``traced.py:247``): each host's ranks and the i-th rank of every
    host, when every host holds the same number of ranks; else the
    domains of a multi-domain topology (``HVD_TPU_TOPO`` forces one on a
    single host, as the Adasum schedule takes it, ``ops/adasum.py``)."""
    from .adasum import _host_grid, _topo_slice_grid

    return _host_grid() or _topo_slice_grid()


def _hierarchical_sum(x: torch.Tensor) -> Optional[torch.Tensor]:
    """Two-stage sum over the world (``traced.py:281``; reference
    ``NCCLHierarchicalAllreduce``, ``nccl_operations.cc:234``): the
    topology's ``hierarchical_all_reduce`` (a reduce-scatter within each
    host, a cross-host sum of the shards, an all-gather within each
    host; ``topo/hierarchical.py``, on the groups its plan-time context
    made).  None where there is no host grid (the caller sums flat)."""
    if host_groups() is None:
        return None
    from ..topo import hierarchical

    return hierarchical.hierarchical_all_reduce(x, op=Sum)


def allreduce_(
    x: torch.Tensor,
    op: int = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    async_op: bool = False,
    process_set=None,
    hierarchical: Optional[bool] = None,
):
    """Allreduce over the world or ``process_set``; may reduce ``x`` in
    place.  Returns the result, which is ``x`` itself unless a scale or
    the op (Product, Adasum) produced a new tensor; ``x`` unchanged on a
    non-member.  Adasum scales, combines (``ops/adasum.py``
    ``adasum_allreduce``, which runs at once: an ``async_op`` gets a
    finished :class:`Pending`) and scales again, with no average.
    ``hierarchical`` (default :func:`hierarchical_enabled`) stages a
    world Sum or Average on the host grid (:func:`_hierarchical_sum`;
    it runs at once, so an ``async_op`` gets a finished :class:`Pending`)
    and Adasum as its two-level schedule."""
    if op not in (Average, Sum, Adasum, Min, Max, Product):
        raise ValueError(f"unknown reduce op {op}")
    if hierarchical is None:
        hierarchical = hierarchical_enabled()
    group, ranks, member = member_group(resolve(process_set))
    if not member:
        return _run([], lambda: x, async_op)
    if op == Adasum:
        from .adasum import adasum_allreduce

        y = adasum_allreduce(_scale(x, prescale_factor), process_set=process_set,
                             hierarchical=hierarchical)
        return _run([], lambda: _scale(y, postscale_factor), async_op)
    size = runtime.size() if ranks is None else len(ranks)
    x = _scale(x, prescale_factor)
    if op == Average:
        postscale_factor = postscale_factor / size
        op = Sum
    if op == Product:
        rows = x.new_empty((size * x.numel(),))
        work = _all_gather(rows, x.reshape(-1), group=group, async_op=async_op)
        return _run([work], lambda: _scale(_product(rows.view((size,) + tuple(x.shape))),
                                           postscale_factor), async_op)
    if op == Sum and hierarchical and ranks is None and size > 1:
        y = _hierarchical_sum(x)
        if y is not None:
            return _run([], lambda: _scale(y, postscale_factor), async_op)
    work = dist.all_reduce(x, op=_DIST_OPS[op], group=group, async_op=async_op)
    return _run([work], lambda: _scale(x, postscale_factor), async_op)


def allgather(x: torch.Tensor, async_op: bool = False, process_set=None):
    """Every member's ``x`` (one shape on every rank) concatenated along
    dim 0 in rank order; zeros of that shape on a non-member."""
    if x.dim() == 0:
        raise ValueError("allgather takes a tensor of at least one dimension")
    group, ranks, member = member_group(resolve(process_set))
    size = runtime.size() if ranks is None else len(ranks)
    shape = (size * x.shape[0],) + tuple(x.shape[1:])
    if not member:
        return _run([], lambda: x.new_zeros(shape), async_op)
    out = x.new_empty(shape)
    work = _all_gather(out, x.contiguous(), group=group, async_op=async_op)
    return _run([work], lambda: out, async_op)


def broadcast_(x: torch.Tensor, root_rank: int = 0, async_op: bool = False,
               process_set=None):
    """Overwrite ``x`` with the value of ``root_rank`` (the set's rank on
    a set), in place; ``x`` unchanged on a non-member."""
    group, ranks, member = member_group(resolve(process_set))
    size = runtime.size() if ranks is None else len(ranks)
    if ranks is not None and not 0 <= root_rank < size:
        raise ValueError(f"root_rank {root_rank} out of range for set size {size}")
    work = None
    if member and size > 1:
        src = root_rank if ranks is None else ranks[root_rank]
        work = dist.broadcast(x, src=src, group=group, async_op=async_op)
    return _run([work], lambda: x, async_op)


def reducescatter(
    x: torch.Tensor,
    op: int = Sum,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    async_op: bool = False,
    process_set=None,
):
    """Sum (or Average) every member's ``x`` and keep this rank's
    ``1/size`` of it along dim 0, which the set's size must divide;
    zeros of that shape on a non-member."""
    group, ranks, member = member_group(resolve(process_set))
    size = runtime.size() if ranks is None else len(ranks)
    rows = x.shape[0] if x.dim() else 0
    if x.dim() == 0 or rows % size != 0:
        raise ValueError(
            f"reducescatter dim 0 ({rows}) must be divisible by set size {size}"
        )
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports SUM/AVERAGE")
    shape = (rows // size,) + tuple(x.shape[1:])
    if not member:
        return _run([], lambda: x.new_zeros(shape), async_op)
    x = _scale(x, prescale_factor)
    if op == Average:
        postscale_factor = postscale_factor / size
    out = x.new_empty(shape)
    work = _reduce_scatter(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)
    return _run([work], lambda: _scale(out, postscale_factor), async_op)


def alltoall(
    x: torch.Tensor,
    send_splits: Optional[List[int]] = None,
    recv_splits: Optional[List[int]] = None,
    async_op: bool = False,
    process_set=None,
):
    """Member i's j-th chunk of ``x`` (along dim 0) becomes member j's
    i-th chunk.  Without splits the chunks are equal, so the set's size
    must divide dim 0; with them, ``send_splits[j]`` rows go to member j
    and ``recv_splits[j]`` rows come from it (every member's
    ``recv_splits`` the column of the others' ``send_splits``, which
    ``ops/eager.py`` exchanges first).  A non-member gets zeros like
    ``x`` (no rows with splits)."""
    group, ranks, member = member_group(resolve(process_set))
    if send_splits is None:
        size = runtime.size() if ranks is None else len(ranks)
        rows = x.shape[0] if x.dim() else 0
        if x.dim() == 0 or rows % size != 0:
            raise ValueError(
                f"alltoall dim 0 ({rows}) must be divisible by set size {size}"
            )
        if not member:
            return _run([], lambda: torch.zeros_like(x), async_op)
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    else:
        if not member:
            return _run([], lambda: x.new_zeros((0,) + tuple(x.shape[1:])), async_op)
        out = x.new_empty((sum(recv_splits),) + tuple(x.shape[1:]))
    work = dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv_splits,
                                  input_split_sizes=send_splits, group=group,
                                  async_op=async_op)
    return _run([work], lambda: out, async_op)


def barrier(device: Optional[torch.device] = None, process_set=None) -> torch.Tensor:
    """A synchronization token: a Sum allreduce of a zero int32 scalar,
    which depends on every member (a non-member's is its own zero).
    Nothing waits for it here (``ops/eager.py`` ``barrier`` waits on the
    host)."""
    token = torch.zeros((), dtype=torch.int32,
                        device=runtime.device() if device is None else device)
    group, _, member = member_group(resolve(process_set))
    if member:
        dist.all_reduce(token, op=dist.ReduceOp.SUM, group=group)
    return token


def join_average(x: torch.Tensor, active) -> torch.Tensor:
    """``x`` averaged over the world's ranks (the JAX package's takes no
    process set) whose ``active`` is true (a joined
    rank keeps stepping with a padding batch and contributes nothing);
    zero when no rank is active.  The sum is divided by the count of
    active ranks, in ``x``'s dtype (an integer ``x`` divides to
    float32)."""
    active_f = torch.as_tensor(active, dtype=torch.float32, device=x.device).reshape(())
    n_active = active_f.clone()
    dist.all_reduce(n_active, op=dist.ReduceOp.SUM)
    contrib = torch.where(active_f > 0, x, torch.zeros_like(x))
    dist.all_reduce(contrib, op=dist.ReduceOp.SUM)
    denom = torch.clamp(n_active, min=1.0).to(contrib.dtype)
    return contrib / denom
