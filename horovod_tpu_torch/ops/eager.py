"""Eager collective API: each rank passes its own tensor.

Counterpart of ``horovod_tpu/ops/eager.py`` in the reference's call
shape (``horovod/torch/mpi_ops.py``): every rank calls the op with its
own tensor and gets its own result, which is row r of what the JAX
eager op returns on the stacked per-rank inputs (its multi-process
"local rows" form, ``_stacked`` ``:270-304``).  The collectives are
``ops/collectives.py``'s (NCCL on the card, gloo on the CPU); this
module adds what the JAX eager layer adds around them:

- handles: each ``*_async`` op returns a :class:`Handle` over
  ``torch.distributed``'s async work (``synchronize``/``poll``,
  ``:37-74``); the ``*_async_`` forms write the result into their input
  when it is waited for, as ``interop/torch.py`` ``TorchHandle`` does;
- the ops of ``:389-817``: ``allreduce`` over every op (Adasum through
  ``ops/adasum.py``; its point-to-point hops refuse under a capture),
  ``grouped_allreduce`` (one fused buffer per dtype, or one op per
  tensor under ``HVD_TPU_DISABLE_GROUP_FUSION``), ``allgather``,
  ``allgather_v`` (first dims may differ: the row counts are gathered
  first), ``broadcast``, ``reducescatter``, ``alltoall`` (uneven splits:
  the counts are exchanged first), ``barrier`` and ``join``;
- the counters ``collective.<op>.dispatches`` and ``collective.<op>.bytes``
  and the ``collective.<op>.bytes_hist`` histogram (``_record``
  ``:81-93``; this rank's bytes, where the JAX package's single
  controller counts the stacked array's);
- ``collective.<op>.dispatch_seconds`` (``_timed`` ``:102-123``): the
  host time of the call that issues the collective, as in the JAX
  package.  On NCCL that call returns once the collective is queued on
  the stream, so on a card it is the enqueue cost, not the transfer; on
  gloo it includes the transfer.  The world's allreduce, grouped
  allreduce, allgather and reducescatter also feed it, with this rank's
  payload bytes, into the measured cost model's flat cells
  (``topo/fit.py`` ``record_observation``), except while a CUDA graph
  is being captured (a capture issues nothing);
- the opt-in consistency check (``HVD_TPU_CONSISTENCY_CHECK``,
  ``:136-241``): each rank's request is encoded with the native core's
  wire codec (``native.encode_request``, ``cpp/src/wire.cc``) and the
  coordinator's response with ``native.encode_response``, as in the JAX
  package; the pure-Python record where the native core is not built;
- the gradients of ``interop/_grads.py:57-168``: allreduce, allgather,
  broadcast, alltoall and grouped allreduce are differentiable when
  their input requires grad (``interop/torch.py:92-197``).

Every op but ``join`` takes a ``process_set``, validated as the JAX
package's ``_ps_id`` validates it (``:244-267``; ``process_sets.resolve``:
a registered ``ProcessSet`` whose ranks match its registration, else
``HorovodTpuError``).  On a set, members run the collective on the
set's group and non-members return their row of the JAX op without
entering it (``ops/collectives.py``): their own input for allreduce,
grouped allreduce and broadcast, zeros for allgather, reducescatter and
alltoall.  ``allgather_v`` and an uneven ``alltoall`` exchange their
counts within the set (a non-member gets no rows), a broadcast's
``root_rank`` is the set's rank, and the consistency check records the
set's ranks.  The gradients follow ``interop/_grads.py`` on the set; an
uneven alltoall on a set has none (``ensure_alltoall_differentiable``).

A synchronous op may run inside a captured CUDA graph on NCCL.  What
waits on the host refuses there (``runtime.refuse_in_capture``): an
async op, ``synchronize``, ``poll``, ``barrier``, ``join``, the
consistency check, and the count exchanges of ``allgather_v`` and of an
uneven ``alltoall``, and Adasum's point-to-point hops.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .. import functions, metrics, runtime
from ..exceptions import HorovodTpuError
from ..process_sets import ProcessSet, member_group, resolve
from ..utils import env
from . import collectives, fusion
from .collectives import (  # re-exported
    Adasum,
    Average,
    Max,
    Min,
    Pending,
    Product,
    ReduceOp,
    Sum,
)

# The consistency check's request types and error response type (the
# JAX package's ``native.REQUEST_*`` and ``RESPONSE_ERROR``), and its
# dtype ids (``eager.py`` ``_WIRE_DTYPES``).
_REQUEST = {"ALLREDUCE": 0, "ALLGATHER": 1, "BROADCAST": 2, "ALLTOALL": 5,
            "REDUCESCATTER": 6}
_RESPONSE_ERROR = 8
_WIRE_DTYPES = [
    "float32", "float64", "float16", "bfloat16", "int32", "int64",
    "int16", "int8", "uint8", "uint16", "uint32", "uint64", "bool",
]


class Handle:
    """An eager collective in flight (reference ``HandleManager``,
    ``torch/handle_manager.{h,cc}``).  ``done()`` polls its works;
    ``wait()`` waits for them and returns the result (written into the
    input first for the ``*_async_`` forms), kept for later waits."""

    __slots__ = ("_pending", "name", "_target", "_result", "_done")

    def __init__(self, pending: Pending, name: Optional[str] = None, target=None):
        self._pending = pending
        self.name = name
        self._target = target
        self._result = None
        self._done = False

    def done(self) -> bool:
        runtime.refuse_in_capture("poll")
        return self._done or self._pending.is_completed()

    def wait(self):
        runtime.refuse_in_capture("synchronize")
        if not self._done:
            out = self._pending.wait()
            if self._target is not None:
                out = _write_back(self._target, out)
            self._result, self._done = out, True
        return self._result


def synchronize(handle: Handle):
    """Wait for ``handle``'s collective and return its result (reference
    ``torch/mpi_ops.py:865``)."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """Whether ``handle``'s collective is done, without waiting (reference
    ``torch/mpi_ops.py:849``)."""
    return handle.done()


def _write_back(target, out):
    """Copy ``out`` into ``target`` (a tensor, or a list of them) where it
    is not already there; returns ``target``."""
    with torch.no_grad():
        if isinstance(target, list):
            for t, o in zip(target, out):
                if o is not t:
                    t.copy_(o)
        elif out is not target:
            target.copy_(out)
    return target


def _start(name: str):
    """Refuse an async op under capture: its handle waits on the host."""
    runtime.refuse_in_capture(f"{name} (an async handle)")


def _members(ps: Optional[ProcessSet]) -> List[int]:
    return list(range(runtime.size())) if ps is None else list(ps.ranks)


def _reduce_op(average: Optional[bool], op: Optional[int]) -> int:
    """``average``/``op`` as the reference takes them: exclusive, Average
    by default."""
    if average is not None and op is not None:
        raise ValueError("specify either average or op, not both")
    if op is None:
        op = Average if (average is None or average) else Sum
    return op


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _record(name: Optional[str], op: str, nbytes: int) -> None:
    key = op.lower()
    metrics.inc_counter(f"collective.{key}.dispatches")
    metrics.inc_counter(f"collective.{key}.bytes", int(nbytes))
    metrics.observe(f"collective.{key}.bytes_hist", float(nbytes),
                    buckets=metrics.BYTES_BUCKETS)


# Eager ops whose dispatch times feed the measured cost model
# (topo/fit.py), and their ring-model collective class.
_FIT_OPS = {
    "ALLREDUCE": "all_reduce",
    "GROUPED_ALLREDUCE": "all_reduce",
    "ALLGATHER": "all_gather",
    "REDUCESCATTER": "reduce_scatter",
}


def _timed(op: str, dispatch, nbytes: int = 0):
    """Run ``dispatch()`` and observe its host time in
    ``collective.<op>.dispatch_seconds``; a ring-priced op of ``nbytes``
    payload bytes (0: none, e.g. on a process set) also lands in its
    ``topo.obs.*`` cell (module docstring: on NCCL the time is the
    enqueue's)."""
    t0 = time.perf_counter()
    out = dispatch()
    dt = time.perf_counter() - t0
    metrics.observe(f"collective.{op.lower()}.dispatch_seconds", dt)
    collective = _FIT_OPS.get(op)
    if collective is not None and nbytes > 0 and not runtime.capturing():
        from ..topo import fit as topo_fit

        topo_fit.record_observation(collective, "flat", nbytes,
                                    axis_size=runtime.size(), seconds=dt)
    return out


def _consistency_check(op: str, x: torch.Tensor, name: Optional[str],
                       root: int = -1, extra: str = "",
                       ps: Optional[ProcessSet] = None) -> None:
    """Under ``HVD_TPU_CONSISTENCY_CHECK``, gather every rank's request
    (type, dtype, shape, name with the set's ranks, root); rank 0
    validates them and broadcasts one response, and a mismatch raises
    ``HorovodTpuError`` on every rank (the reference controller's
    validation, ``controller.cc`` ``ConstructResponse``).  Every rank
    of the world takes part, members of ``ps`` or not, as in the JAX
    package."""
    if not env.get_bool(env.CONSISTENCY_CHECK):
        return
    rt = runtime.get_runtime()
    if rt.size <= 1:
        return
    runtime.refuse_in_capture("the collective consistency check")
    from .. import native

    dt = str(x.dtype).replace("torch.", "")
    ps_tag = "world" if ps is None else ",".join(map(str, ps.ranks))
    wire_name = f"{name or ''}|ps={ps_tag}|{extra}"
    dtype_id = _WIRE_DTYPES.index(dt) if dt in _WIRE_DTYPES else 255
    dims = list(x.shape)
    use_native = native.available()
    if use_native:
        blob = native.encode_request(rt.rank, _REQUEST[op], dtype_id, root, dims,
                                     wire_name)
        records = [native.decode_request(b) for b in functions.allgather_object(blob)]
    else:
        records = functions.allgather_object({
            "rank": rt.rank, "type": _REQUEST[op], "dtype": dtype_id,
            "root": root, "dims": dims, "name": wire_name,
        })

    def sig(r):
        return (r["type"], r["dtype"], tuple(r["dims"]), r["name"], r["root"])

    response = None
    if rt.rank == 0:
        base, error = records[0], ""
        for r in records[1:]:
            if sig(r) != sig(base):
                error = (f"process {r['rank']} submitted {sig(r)} but process "
                         f"{base['rank']} submitted {sig(base)} (reference "
                         "controller.cc mismatched-collective error)")
                break
        try:
            if use_native:
                response = (native.encode_response(_RESPONSE_ERROR, [], error) if error
                            else native.encode_response(_REQUEST[op], [wire_name],
                                                        sizes=dims))
            else:
                response = {"type": _RESPONSE_ERROR if error else _REQUEST[op],
                            "names": [] if error else [wire_name], "error": error,
                            "sizes": dims}
        except Exception as e:
            # An encoding failure (a name over the codec's cap) reaches
            # every rank as an ERROR response, never a stranded broadcast.
            err = f"coordinator failed to encode response: {e}"
            response = (native.encode_response(_RESPONSE_ERROR, [], err) if use_native
                        else {"type": _RESPONSE_ERROR, "names": [], "error": err,
                              "sizes": dims})
    response = runtime.broadcast_object(response, 0)
    if use_native:
        response = native.decode_response(response)
    if response["type"] == _RESPONSE_ERROR:
        raise HorovodTpuError(f"collective consistency check failed: {response['error']}")


def _wants_grad(x) -> bool:
    return torch.is_tensor(x) and x.requires_grad and torch.is_grad_enabled()


# ------------------------------------------------------------ the ops


def _allreduce(x, op, pre, post, name, async_op=False, inplace=False, ps=None):
    nbytes = _nbytes([x])
    _record(name, "ALLREDUCE", nbytes)
    _consistency_check("ALLREDUCE", x, name, ps=ps)
    return _timed("ALLREDUCE", lambda: collectives.allreduce_(
        x if inplace else x.clone(), op, pre, post, async_op=async_op, process_set=ps),
        nbytes if ps is None else 0)


def _grouped(xs, op, pre, post, name, async_op=False, ps=None):
    """One allreduce per dtype over a fused buffer (``fusion.flatten_group``),
    or one per tensor, in order, under ``HVD_TPU_DISABLE_GROUP_FUSION``;
    a :class:`Pending` for all of them when ``async_op``.  A non-member
    of ``ps`` gets its tensors back unchanged (a fused buffer's views)."""
    if env.get_bool(env.DISABLE_GROUP_FUSION):
        parts = [_allreduce(x, op, pre, post, f"{name}.{i}" if name else None, True,
                            ps=ps)
                 for i, x in enumerate(xs)]
        pending = Pending([w for p in parts for w in p.works],
                          lambda: [p.finish() for p in parts])
    else:
        nbytes = _nbytes(xs)
        _record(name, "GROUPED_ALLREDUCE", nbytes)
        flats, meta = fusion.flatten_group(xs)
        parts = _timed("GROUPED_ALLREDUCE", lambda: [
            collectives.allreduce_(f, op, pre, post, async_op=True, process_set=ps)
            for f in flats], nbytes if ps is None else 0)
        pending = Pending([w for p in parts for w in p.works],
                          lambda: fusion.unflatten_group([p.finish() for p in parts], meta))
    return pending if async_op else pending.wait()


def _allgather(x, name, async_op=False, ps=None):
    nbytes = _nbytes([x])
    _record(name, "ALLGATHER", nbytes)
    _consistency_check("ALLGATHER", x, name, ps=ps)
    return _timed("ALLGATHER", lambda: collectives.allgather(x, async_op, process_set=ps),
                  nbytes if ps is None else 0)


def _broadcast(x, root_rank, name, async_op=False, inplace=False, ps=None):
    _record(name, "BROADCAST", _nbytes([x]))
    _consistency_check("BROADCAST", x, name, root=int(root_rank), ps=ps)
    return _timed("BROADCAST", lambda: collectives.broadcast_(
        x if inplace else x.clone(), root_rank, async_op, process_set=ps))


def _reducescatter(x, op, pre, post, name, async_op=False, ps=None):
    nbytes = _nbytes([x])
    _record(name, "REDUCESCATTER", nbytes)
    _consistency_check("REDUCESCATTER", x, name, ps=ps)
    return _timed("REDUCESCATTER", lambda: collectives.reducescatter(
        x, op, pre, post, async_op, process_set=ps), nbytes if ps is None else 0)


def _send_splits(splits, x: torch.Tensor, n: int) -> List[int]:
    send = [int(s) for s in (splits.tolist() if torch.is_tensor(splits) else splits)]
    if len(send) != n:
        raise HorovodTpuError(
            f"splits must have one entry per rank of the set ({n}); got {len(send)}")
    if min(send) < 0 or sum(send) != (x.shape[0] if x.dim() else 0):
        raise HorovodTpuError("each rank's splits must sum to its row count")
    return send


def _alltoall(x, splits, name, async_op=False, ps=None):
    """Even or, with ``splits`` (this rank's send counts, one per member),
    uneven; the uneven form exchanges the counts within the set first
    (each member's receive counts are the others' send counts to it)
    and returns ``(output, received_splits)``; a non-member receives no
    rows and zero counts."""
    _record(name, "ALLTOALL", _nbytes([x]))
    _consistency_check("ALLTOALL", x, name, extra="" if splits is None else "splits",
                       ps=ps)
    if splits is None:
        return _timed("ALLTOALL", lambda: collectives.alltoall(
            x, async_op=async_op, process_set=ps))
    group, ranks, member = member_group(ps)
    k = runtime.size() if ranks is None else len(ranks)
    send = _send_splits(splits, x, k)
    if not member:
        empty = x.new_zeros((0,) + tuple(x.shape[1:]))
        received = torch.zeros(k, dtype=torch.int64)
        return Pending([], lambda: (empty, received)) if async_op else (empty, received)
    runtime.refuse_in_capture("alltoall's split-count exchange")
    counts = torch.tensor(send, dtype=torch.int64, device=x.device)
    got = torch.empty_like(counts)
    dist.all_to_all_single(got, counts, group=group)
    recv = got.tolist()
    out = _timed("ALLTOALL", lambda: collectives.alltoall(x, send, recv, async_op,
                                                          process_set=ps))
    received = torch.tensor(recv, dtype=torch.int64)
    if async_op:
        return Pending(out.works, lambda: (out.finish(), received))
    return out, received


# ------------------------------------------------------------ gradients


class _AllreduceFn(torch.autograd.Function):
    """``_grads.allreduce_grad``: the gradient is an allreduce with the
    same op, scale factors and set."""

    @staticmethod
    def forward(ctx, x, op, pre, post, name, ps):
        ctx.meta = (op, pre, post, ps)
        return _allreduce(x, op, pre, post, name, ps=ps)

    @staticmethod
    def backward(ctx, dy):
        op, pre, post, ps = ctx.meta
        return (_allreduce(dy.contiguous(), op, pre, post, None, ps=ps),
                None, None, None, None, None)


class _AllgatherFn(torch.autograd.Function):
    """``_grads.allgather_grad``: the Average allreduce of the gradient
    over the set, this member's rows of it; zeros on a non-member."""

    @staticmethod
    def forward(ctx, x, name, ps):
        ctx.rows, ctx.ps = x.shape[0], ps
        return _allgather(x, name, ps=ps)

    @staticmethod
    def backward(ctx, dy):
        g = _allreduce(dy.contiguous(), Average, 1.0, 1.0, None, ps=ctx.ps)
        members, d = _members(ctx.ps), ctx.rows
        if runtime.rank() not in members:
            return g.new_zeros((d,) + tuple(g.shape[1:])), None, None
        p = members.index(runtime.rank())
        return g[p * d:(p + 1) * d], None, None


class _BroadcastFn(torch.autograd.Function):
    """``_grads.broadcast_grad``: the Average allreduce of the gradient
    over the set on the root, zero on the other members; a non-member
    (an identity forward) passes the gradient through."""

    @staticmethod
    def forward(ctx, x, root_rank, name, ps):
        ctx.root, ctx.ps = root_rank, ps
        return _broadcast(x, root_rank, name, ps=ps)

    @staticmethod
    def backward(ctx, dy):
        g = _allreduce(dy.contiguous(), Average, 1.0, 1.0, None, ps=ctx.ps)
        members = _members(ctx.ps)
        if runtime.rank() not in members:
            return dy, None, None, None
        root = members[ctx.root]
        return (g if runtime.rank() == root else torch.zeros_like(g)), None, None, None


class _AlltoallFn(torch.autograd.Function):
    """``_grads.alltoall_grad``: the reverse alltoall, each received chunk
    sent back to its sender (equal splits are their own reverse)."""

    @staticmethod
    def forward(ctx, x, splits, name, ps):
        ctx.ps = ps
        out = _alltoall(x, splits, name, ps=ps)
        if splits is None:
            ctx.splits = None
            return out
        y, recv = out
        ctx.splits = (_send_splits(splits, x, len(_members(ps))), recv.tolist())
        ctx.mark_non_differentiable(recv)
        return y, recv

    @staticmethod
    def backward(ctx, dy, *unused):
        dy = dy.contiguous()
        if ctx.splits is None:
            return collectives.alltoall(dy, process_set=ctx.ps), None, None, None
        send, recv = ctx.splits
        return collectives.alltoall(dy, recv, send), None, None, None


class _GroupedAllreduceFn(torch.autograd.Function):
    """Reference ``HorovodGroupedAllreduce`` (``torch/mpi_ops.py:383``):
    one grouped allreduce each way, with the same op, scale factors and
    set."""

    @staticmethod
    def forward(ctx, op, pre, post, name, ps, *xs):
        ctx.meta = (op, pre, post, ps)
        return tuple(_grouped(list(xs), op, pre, post, name, ps=ps))

    @staticmethod
    def backward(ctx, *dys):
        op, pre, post, ps = ctx.meta
        gs = _grouped([d.contiguous() for d in dys], op, pre, post, None, ps=ps)
        return (None, None, None, None, None) + tuple(gs)


# ------------------------------------------------------------ the API


def allreduce(x: torch.Tensor, average: Optional[bool] = None, op: Optional[int] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None, name: Optional[str] = None) -> torch.Tensor:
    """Every member's ``x`` reduced by ``op`` (Average, Sum, Min, Max,
    Product; ``average`` and ``op`` are exclusive, Average by default),
    ``x`` scaled by ``prescale_factor`` first and the result by
    ``postscale_factor`` (in float32 for f16/bf16: kernel B1 on the
    card).  A non-member of ``process_set`` gets ``x`` back unchanged.
    Differentiable: the gradient is the same allreduce."""
    op = _reduce_op(average, op)
    ps = resolve(process_set)
    if _wants_grad(x):
        return _AllreduceFn.apply(x, op, prescale_factor, postscale_factor, name, ps)
    return _allreduce(x, op, prescale_factor, postscale_factor, name, ps=ps)


def allreduce_(x: torch.Tensor, average: Optional[bool] = None, op: Optional[int] = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set=None, name: Optional[str] = None) -> torch.Tensor:
    """:func:`allreduce` written into ``x``; returns ``x``."""
    op = _reduce_op(average, op)
    ps = resolve(process_set)
    if _wants_grad(x):
        return _write_back(x, allreduce(x, op=op, prescale_factor=prescale_factor,
                                        postscale_factor=postscale_factor,
                                        process_set=ps, name=name))
    return _write_back(x, _allreduce(x, op, prescale_factor, postscale_factor, name,
                                     inplace=True, ps=ps))


def allreduce_async(x: torch.Tensor, average: Optional[bool] = None,
                    op: Optional[int] = None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, process_set=None,
                    name: Optional[str] = None) -> Handle:
    op = _reduce_op(average, op)
    ps = resolve(process_set)
    _start("allreduce_async")
    return Handle(_allreduce(x, op, prescale_factor, postscale_factor, name, True, ps=ps),
                  name)


def allreduce_async_(x: torch.Tensor, average: Optional[bool] = None,
                     op: Optional[int] = None, prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0, process_set=None,
                     name: Optional[str] = None) -> Handle:
    op = _reduce_op(average, op)
    ps = resolve(process_set)
    _start("allreduce_async_")
    return Handle(_allreduce(x, op, prescale_factor, postscale_factor, name, True,
                             inplace=True, ps=ps), name, target=x)


def grouped_allreduce(xs: Sequence[torch.Tensor], average: Optional[bool] = None,
                      op: Optional[int] = None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, process_set=None,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`allreduce` of each tensor of ``xs``, as one collective per
    dtype over a fused buffer (one per tensor, in order, under
    ``HVD_TPU_DISABLE_GROUP_FUSION``).  Differentiable."""
    op = _reduce_op(average, op)
    ps = resolve(process_set)
    xs = list(xs)
    if any(_wants_grad(x) for x in xs):
        return list(_GroupedAllreduceFn.apply(op, prescale_factor, postscale_factor,
                                              name, ps, *xs))
    return _grouped(xs, op, prescale_factor, postscale_factor, name, ps=ps)


def grouped_allreduce_(xs: Sequence[torch.Tensor], average: Optional[bool] = None,
                       op: Optional[int] = None, prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0, process_set=None,
                       name: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`grouped_allreduce` written into ``xs``; returns them."""
    xs = list(xs)
    return _write_back(xs, grouped_allreduce(xs, average, op, prescale_factor,
                                             postscale_factor, process_set, name))


def grouped_allreduce_async(xs: Sequence[torch.Tensor], average: Optional[bool] = None,
                            op: Optional[int] = None, prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0, process_set=None,
                            name: Optional[str] = None) -> Handle:
    op = _reduce_op(average, op)
    ps = resolve(process_set)
    _start("grouped_allreduce_async")
    return Handle(_grouped(list(xs), op, prescale_factor, postscale_factor, name, True,
                           ps=ps), name)


def grouped_allreduce_async_(xs: Sequence[torch.Tensor], average: Optional[bool] = None,
                             op: Optional[int] = None, prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0, process_set=None,
                             name: Optional[str] = None) -> Handle:
    op = _reduce_op(average, op)
    ps = resolve(process_set)
    _start("grouped_allreduce_async_")
    xs = list(xs)
    return Handle(_grouped(xs, op, prescale_factor, postscale_factor, name, True, ps=ps),
                  name, target=xs)


def allgather(x: torch.Tensor, process_set=None, name: Optional[str] = None) -> torch.Tensor:
    """Every member's ``x`` (one shape on every rank) concatenated along
    dim 0 in rank order; zeros of that shape on a non-member.
    Differentiable: the gradient is this member's rows of the Average
    allreduce of the incoming gradient."""
    ps = resolve(process_set)
    if _wants_grad(x):
        return _AllgatherFn.apply(x, name, ps)
    return _allgather(x, name, ps=ps)


def allgather_async(x: torch.Tensor, process_set=None,
                    name: Optional[str] = None) -> Handle:
    ps = resolve(process_set)
    _start("allgather_async")
    return Handle(_allgather(x, name, True, ps=ps), name)


def allgather_v(x: torch.Tensor, process_set=None, name: Optional[str] = None) -> torch.Tensor:
    """Every member's ``x`` concatenated along dim 0 in rank order, where
    the first dims may differ (the trailing ones may not): the row counts
    are gathered within the set first, every member's rows padded to the
    largest count, gathered once and trimmed (``eager.py:501-586``).  A
    non-member takes part in nothing and gets no rows."""
    ps = resolve(process_set)
    if x.dim() == 0:
        raise HorovodTpuError("allgather_v takes a tensor of at least one dimension")
    if runtime.rank() not in _members(ps):
        return x.new_zeros((0,) + tuple(x.shape[1:]))
    runtime.refuse_in_capture("allgather_v's row-count negotiation")
    count = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = collectives.allgather(count, process_set=ps).tolist()
    rows = max(counts)
    padded = x.new_zeros((rows,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    gathered = _allgather(padded, name, ps=ps)
    return torch.cat([gathered[r * rows:r * rows + c] for r, c in enumerate(counts)])


def broadcast(x: torch.Tensor, root_rank: int = 0, process_set=None,
              name: Optional[str] = None) -> torch.Tensor:
    """The value of ``root_rank`` (the set's rank on a set) on every
    member; ``x`` unchanged on a non-member.  Differentiable: the
    gradient is the Average allreduce of the incoming gradient on the
    root, zero on the other members."""
    ps = resolve(process_set)
    if _wants_grad(x):
        return _BroadcastFn.apply(x, root_rank, name, ps)
    return _broadcast(x, root_rank, name, ps=ps)


def broadcast_(x: torch.Tensor, root_rank: int = 0, process_set=None,
               name: Optional[str] = None) -> torch.Tensor:
    """:func:`broadcast` written into ``x``; returns ``x``."""
    ps = resolve(process_set)
    if _wants_grad(x):
        return _write_back(x, broadcast(x, root_rank, ps, name=name))
    return _broadcast(x, root_rank, name, inplace=True, ps=ps)


def broadcast_async(x: torch.Tensor, root_rank: int = 0, process_set=None,
                    name: Optional[str] = None) -> Handle:
    ps = resolve(process_set)
    _start("broadcast_async")
    return Handle(_broadcast(x, root_rank, name, True, ps=ps), name)


def broadcast_async_(x: torch.Tensor, root_rank: int = 0, process_set=None,
                     name: Optional[str] = None) -> Handle:
    ps = resolve(process_set)
    _start("broadcast_async_")
    return Handle(_broadcast(x, root_rank, name, True, inplace=True, ps=ps), name,
                  target=x)


def reducescatter(x: torch.Tensor, op: int = Sum, prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0, process_set=None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Every member's ``x`` summed (``op=Sum``, the JAX package's default)
    or averaged, this member's ``1/size`` of it along dim 0, which the
    set's size must divide; zeros of that shape on a non-member."""
    ps = resolve(process_set)
    return _reducescatter(x, op, prescale_factor, postscale_factor, name, ps=ps)


def reducescatter_async(x: torch.Tensor, op: int = Sum, prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0, process_set=None,
                        name: Optional[str] = None) -> Handle:
    ps = resolve(process_set)
    _start("reducescatter_async")
    return Handle(_reducescatter(x, op, prescale_factor, postscale_factor, name, True,
                                 ps=ps), name)


def alltoall(x: torch.Tensor, splits: Optional[Union[Sequence[int], torch.Tensor]] = None,
             process_set=None, name: Optional[str] = None):
    """Member i's j-th chunk of ``x`` along dim 0 goes to member j, which
    gets the chunks in rank order.  ``splits=None``: equal chunks (the
    set's size must divide dim 0), returns the output (zeros on a
    non-member).  Otherwise ``splits[j]`` rows go to member j, and the
    result is ``(output, received_splits)``: ``received_splits[j]`` rows
    came from member j.  Differentiable: the gradient is the reverse
    alltoall (not for uneven splits on a set, as in the JAX package)."""
    ps = resolve(process_set)
    if _wants_grad(x):
        if splits is not None and ps is not None:
            raise NotImplementedError(
                "gradients of uneven-splits alltoall on an explicit process "
                "set are not supported; use the global set or equal splits"
            )
        return _AlltoallFn.apply(x, splits, name, ps)
    return _alltoall(x, splits, name, ps=ps)


def alltoall_async(x: torch.Tensor,
                   splits: Optional[Union[Sequence[int], torch.Tensor]] = None,
                   process_set=None, name: Optional[str] = None) -> Handle:
    ps = resolve(process_set)
    _start("alltoall_async")
    return Handle(_alltoall(x, splits, name, True, ps=ps), name)


def barrier(process_set=None) -> None:
    """Return once every member has reached it (at once on a non-member)."""
    ps = resolve(process_set)
    runtime.refuse_in_capture("barrier")
    int(collectives.barrier(process_set=ps))  # the host waits for the token


def join() -> int:
    """Announce that this rank has no more data, wait for every rank to
    do so, and return the rank that joined last (reference ``hvd.join``,
    ``operations.cc:1714``): each rank stamps its arrival time before
    anything blocks, the stamps are gathered and the latest wins, ties
    going to the higher rank (``eager.py:746-817``)."""
    runtime.refuse_in_capture("join")
    arrived = time.time()
    rt = runtime.get_runtime()
    stamp = torch.tensor([arrived], dtype=torch.float64, device=rt.device)
    stamps = collectives.allgather(stamp).tolist()
    return max(zip(stamps, range(rt.size)))[1]
