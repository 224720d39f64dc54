"""Execute stage: run the planned per-bucket collectives.

Counterpart of the flat path of ``horovod_tpu/sched/execute.py``:
``exchange`` (``:392``) with the bucket chain of ``_chain`` (``:40-46``),
``quantized_exchange_flat`` (``:607``), ``bf16_wire`` (``:665``),
``record_wire_metrics`` (``:197``) and the reduce-scatter exchanges of
``HVD_TPU_SCHED_MODE=reduce_scatter``, ``reduce_scatter_flat`` (``:686``)
and ``hier_reduce_scatter_flat`` (``:772``).  The reduce-scatter
exchanges and ``quantized_exchange_flat`` take ``shard_update``, the
ZeRO-1 hook: a function of this rank's float32 shard of the reduced
buffer, run between the reduce-scatter and the all-gather.

The JAX package ties each bucket to the previous one with an
optimization barrier, so XLA issues the collectives in schedule order
and overlaps bucket k's exchange with the backward that still produces
bucket k+1's gradients.  Here a :class:`BucketChain` runs one step's
buckets, each when the caller launches it (``sched/hooks.py``
``ScheduleLauncher`` keeps the order).  Launched from the backward, a
bucket runs on one exchange worker thread, in launch order, so the
hook only queues it and the backward's own launches go on: the bucket's
flatten, compression and dispatch Python runs beside them.  On a card
it runs on the device's one exchange stream, which first waits for an
event recorded on the launching stream (the backward's, where the
gradients were written), then flattens the bucket, runs its kernels
(B1, or B3-B7) and its NCCL calls; every kernel wrapper launches on the
current stream, so they run there unchanged.  Buckets stay in launch
order on that one stream, which is what the quantized ring's slot reuse
rests on (``csrc/quant_ring.cu``).  ``finish`` waits for the worker and
makes the current stream wait for the exchange stream.  Tensors that
cross streams are recorded on the stream that uses them
(``Tensor.record_stream``).  Launched after the backward, a bucket runs
at once on the calling thread and the current stream.

While a CUDA graph is being captured (``TrainStep`` under
``HVD_TPU_ONESTEP``), a bucket launched from the backward runs at once
on the hook's own thread, not the worker's: the capture records what
the capturing thread issues.  It still runs on the exchange stream,
forked from the capturing stream by the event the launch records and
joined by :meth:`BucketChain.finish`, so the graph holds the fork and the
join, and a replay overlaps each bucket with the backward on the device
with no host work.  ``record_stream`` works there too: PyTorch's
allocator keeps a block used on two streams out of reuse until the
capture has ended, so no later node of the graph overwrites it.  Such a
chain keeps its launch ``log`` but records no timing events (a graph's
events cannot be timed from the host).

Besides the ``sched.*`` counters and gauges, each chain observes the
histograms ``sched.bytes_per_bucket`` (one observation per bucket,
``:381``, ``:581``) and ``sched.exchange_seconds`` (host seconds from
the chain's creation to :meth:`BucketChain.finish`, ``:601``).  Like
every ``sched.*`` metric they are recorded in Python, so a captured
step records them once, at its capture.
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import metrics, runtime
from ..ops import fusion
from ..ops.collectives import Sum, _all_gather, _reduce_scatter, _scale
from ..ops.kernels import cast_buffer, scale_cast
from ..ops.quantized import _axis_groups, quantized_all_gather, quantized_reduce_scatter
from .plan import Bucket, BucketSchedule, wire_bytes

_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_WORKER: Optional[Tuple[int, ThreadPoolExecutor]] = None
_TRACED: Optional[List["BucketChain"]] = None


def exchange_stream(device: torch.device) -> "torch.cuda.Stream":
    """The exchange stream of a card: one per device, made on first use."""
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def _worker() -> ThreadPoolExecutor:
    """The process's one exchange worker thread (made anew after a fork)."""
    global _WORKER
    if _WORKER is None or _WORKER[0] != os.getpid():
        _WORKER = (os.getpid(), ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hvd-exchange"))
    return _WORKER[1]


@contextlib.contextmanager
def traced():
    """Within the block, every :class:`BucketChain` made is appended to
    the yielded list, and on a card times each bucket on CUDA events
    (:meth:`BucketChain.timeline`)."""
    global _TRACED
    saved, _TRACED = _TRACED, []
    try:
        yield _TRACED
    finally:
        _TRACED = saved


def record_wire_metrics(schedule: BucketSchedule) -> None:
    """Publish ``sched.wire_bytes{wire=}`` (bytes per step on each wire
    format), the ``sched.wire_bytes.<wire>`` running counters and
    ``sched.compression_ratio`` (dense bytes / wire bytes)."""
    per_wire: dict = {}
    for b in schedule.buckets:
        per_wire[b.wire] = per_wire.get(b.wire, 0) + wire_bytes(b)
    for w, nbytes in per_wire.items():
        metrics.set_gauge("sched.wire_bytes", nbytes, {"wire": w})
        metrics.inc_counter(f"sched.wire_bytes.{w}", nbytes)
    total_wire = sum(per_wire.values())
    if total_wire > 0:
        metrics.set_gauge(
            "sched.compression_ratio", schedule.total_bytes / total_wire
        )


def record_exchange_metrics(schedule: BucketSchedule) -> None:
    """The ``sched.*`` counters and gauges of one exchanged schedule."""
    metrics.inc_counter("sched.plans")
    metrics.inc_counter("sched.buckets", len(schedule))
    metrics.inc_counter("sched.exchange_bytes", schedule.total_bytes)
    metrics.set_gauge("sched.buckets_per_step", len(schedule))
    metrics.set_gauge("sched.bytes_per_step", schedule.total_bytes)
    record_wire_metrics(schedule)


class BucketChain:
    """One step's exchange of ``schedule``, bucket by bucket.

    ``launch(k, leaves)`` runs bucket ``k`` over ``leaves()`` (its
    members' wire tensors, in ``bucket.indices`` order, made where the
    bucket runs): flatten into one buffer per dtype, ``reduce_flat(flat,
    bucket)`` each, slice back.  With ``side`` every bucket runs on the
    exchange worker thread and, on a CUDA ``device``, on the exchange
    stream after the launching stream's work so far; else at once.
    ``finish()`` waits for every launched bucket (raising the first
    error), orders the current stream after them and returns every leaf
    of the schedule reduced, in index order (views of the reduced flat
    buffers).  ``log`` lists ``(position, from_hook)`` in launch order.
    Made inside :func:`traced`, on a card, each bucket's start and end
    are CUDA events on the stream it ran on (:meth:`timeline`), except
    in a chain made during a CUDA graph's capture, whose side buckets run
    on the launching thread (module docstring)."""

    def __init__(self, schedule: BucketSchedule,
                 reduce_flat: Callable[[torch.Tensor, Bucket], torch.Tensor],
                 device: Optional[torch.device] = None, *, side: bool = False):
        self.schedule = schedule
        self._reduce = reduce_flat
        on_card = device is not None and device.type == "cuda"
        self._side = side
        self._stream = exchange_stream(device) if side and on_card else None
        self._capturing = on_card and runtime.capturing()
        self._timing = _TRACED is not None and on_card and not self._capturing
        if _TRACED is not None:
            _TRACED.append(self)
        self.log: List[Tuple[int, bool]] = []
        self._futures: list = []
        self._reduced: Dict[int, torch.Tensor] = {}
        self._events: Dict[int, Tuple] = {}
        self._base = self._backward_end = None
        self._t0 = time.perf_counter()

    def launch(self, k: int, leaves: Callable[[], Sequence[torch.Tensor]],
               from_hook: bool = False) -> None:
        self.log.append((k, from_hook))
        if self._base is None:
            self._base = self._event()
        if not self._side:
            self._run(k, leaves())
            return
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record()  # the launching stream's work so far
        if self._capturing:
            self._run_side(k, leaves, ready)
            return
        self._futures.append(_worker().submit(self._run_side, k, leaves, ready))

    @torch.no_grad()
    def _run_side(self, k: int, leaves, ready) -> None:
        stream = self._stream
        if stream is None:
            self._run(k, leaves())
            return
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            ts = leaves()
            for t in ts:
                t.record_stream(stream)
            self._run(k, ts)

    def _run(self, k: int, leaves: Sequence[torch.Tensor]) -> None:
        bucket = self.schedule.buckets[k]
        start = self._event()
        flats, meta = fusion.flatten_group(leaves)
        outs = [self._reduce(f, bucket) for f in flats]
        for i, t in zip(bucket.indices, fusion.unflatten_group(outs, meta)):
            self._reduced[i] = t
        metrics.observe("sched.bytes_per_bucket", bucket.nbytes,
                        buckets=metrics.BYTES_BUCKETS)
        if start is not None:
            self._events[k] = (start, self._event())

    def _event(self):
        if not self._timing:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark_backward_end(self) -> None:
        """Record, on the current stream, the end of the backward's
        kernels: :meth:`timeline`'s zero."""
        self._backward_end = self._event()
        if self._base is None:
            self._base = self._backward_end

    def finish(self) -> List[torch.Tensor]:
        futures, self._futures = self._futures, []
        error = None
        for f in futures:  # every one, so nothing runs on after a raise
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                error = error or e
        if self._stream is not None:
            main = torch.cuda.current_stream(self._stream.device)
            main.wait_stream(self._stream)
            for t in self._reduced.values():
                t.record_stream(main)
        if error is not None:
            raise error
        reduced, self._reduced = self._reduced, {}
        record_exchange_metrics(self.schedule)
        metrics.observe("sched.exchange_seconds", time.perf_counter() - self._t0)
        return [reduced[i] for i in range(len(reduced))]

    def timeline(self) -> List[Tuple[float, float]]:
        """Per bucket in schedule order, its exchange's (start, end) in ms
        from the backward's end (negative: before it); empty outside
        :func:`traced`, off a card, for a chain made during a CUDA graph's
        capture or before :meth:`mark_backward_end`.  Waits for the
        events."""
        zero = self._backward_end
        if zero is None or len(self._events) != len(self.schedule):
            return []
        zero.synchronize()
        at = self._base.elapsed_time  # every event is later than the base
        out = []
        for k in range(len(self.schedule)):
            start, end = self._events[k]
            end.synchronize()
            out.append((at(start) - at(zero), at(end) - at(zero)))
        return out


def bf16_wire(reduce_dense: Callable[[torch.Tensor], torch.Tensor]):
    """Wrap a dense flat reducer with a bf16 cast around the wire: kernel
    B1 down-casts, the reducer runs on the bf16 buffer, B1 up-casts.  A
    non-floating or already-bf16 buffer goes to the reducer unchanged."""

    def reduce(f: torch.Tensor) -> torch.Tensor:
        if not f.dtype.is_floating_point or f.dtype == torch.bfloat16:
            return reduce_dense(f)
        return cast_buffer(reduce_dense(cast_buffer(f, torch.bfloat16)), f.dtype)

    return reduce


def _scale_f32(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * float32(factor)`` on a float32 buffer through kernel B1
    (``horovod_tpu/ops/traced.py`` ``_scale``); identity at 1.0."""
    return x if factor == 1.0 else scale_cast(x, factor)


def quantized_exchange_flat(
    f: torch.Tensor,
    *,
    average: bool,
    wire: str,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    shard_update: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    residual: Optional[torch.Tensor] = None,
    process_set=None,
    groups=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One bucket's quantized reduce-scatter + all-gather exchange:
    ``g = f·prescale (+ residual)`` in float32, quantized
    reduce-scatter, the shard scaled by ``postscale`` (and ``1/n`` for
    an average, n the size of the rank's group: the world, its tile of
    ``process_set`` or its group of the explicit ``groups``: lists of
    ranks or an ``ops/quantized.py`` ``Groups``), ``shard_update`` on
    that float32 shard (``:657-658``), quantized all-gather, the first
    ``f.numel()`` elements cast back to ``f.dtype``.

    ``residual`` engages error feedback: the wire carries
    ``quantize(g)`` and the new residual ``g − dequant(quantize(g))`` is
    returned alongside; without it the second result is None."""
    g = _scale_f32(f.float(), prescale_factor)
    r_new = None
    if residual is not None:
        g = g + residual.float()
        shard, r_new = quantized_reduce_scatter(g, Sum, process_set, wire=wire, ef=True,
                                                groups=groups)
    else:
        shard = quantized_reduce_scatter(g, Sum, process_set, wire=wire, groups=groups)
    if average:
        postscale_factor = postscale_factor / _axis_groups(process_set, groups).n
    shard = _scale_f32(shard, postscale_factor)
    if shard_update is not None:
        shard = shard_update(shard)
    out = quantized_all_gather(shard, process_set, wire=wire, groups=groups)[:f.numel()]
    return out.to(f.dtype), r_new


def reduce_scatter_flat(
    f: torch.Tensor,
    *,
    average: bool,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    shard_update: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """One bucket's dense reduce-scatter + all-gather exchange over the
    world (``:686-719``, arXiv:2004.13336's decomposition): ``f`` scaled
    by ``prescale``, padded to a multiple of the world, reduce-scattered
    (this rank's 1/N shard of the sum), scaled by ``postscale`` (over
    the world for an average), ``shard_update`` run on the shard, then
    all-gathered and cut back to ``f.numel()``.  The wire carries one
    allreduce's bytes; the scales are the dense path's
    (``collectives._scale``: kernel B1 on a 16-bit buffer)."""
    world = runtime.size()
    n = f.numel()
    g = _scale(f, prescale_factor)
    pad = (-n) % world
    if pad:
        g = F.pad(g, (0, pad))
    shard = g
    if world > 1:
        shard = g.new_empty((g.numel() // world,))
        _reduce_scatter(shard, g.contiguous(), op=dist.ReduceOp.SUM)
    if average:
        postscale_factor = postscale_factor / world
    shard = _scale(shard, postscale_factor)
    if shard_update is not None:
        shard = shard_update(shard)
    out = shard
    if world > 1:
        out = shard.new_empty((shard.numel() * world,))
        _all_gather(out, shard.contiguous())
    return out[:n] if pad else out



def hier_allreduce_flat(
    f: torch.Tensor,
    *,
    average: bool,
    wire: str = "off",
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> torch.Tensor:
    """One bucket's hierarchical allreduce over the world (the
    ``lowering="hier"`` bucket, ``horovod_tpu/sched/execute.py:736``):
    intra-domain reduce_scatter, cross-domain all_reduce of the 1/k
    shard, intra-domain all_gather (``topo/hierarchical.py``); a
    quantized or bf16 ``wire`` compresses only the cross-domain hop.
    The scales are the dense path's (``collectives._scale``).  The
    world's groups were made when the bucket was planned."""
    from ..topo import hierarchical

    out = hierarchical.hierarchical_all_reduce(_scale(f, prescale_factor), op=Sum,
                                               wire=wire)
    if average:
        postscale_factor = postscale_factor / runtime.size()
    return _scale(out, postscale_factor)


def hier_adasum_flat(
    f: torch.Tensor,
    *,
    average: bool,
    wire: str = "off",
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> torch.Tensor:
    """One bucket's hierarchical Adasum exchange (the
    ``lowering="hier_adasum"`` bucket, ``:746``): intra-domain sum,
    Adasum across domains on the 1/k shard, intra-domain all_gather.
    ``average=True`` combines per-domain *mean* gradients (the reference
    postscale semantics); a quantized or bf16 ``wire`` compresses only
    the cross-domain gather."""
    from ..ops.collectives import Average
    from ..topo import hierarchical

    out = hierarchical.hierarchical_adasum_all_reduce(
        _scale(f, prescale_factor), op=Average if average else Sum, wire=wire)
    return _scale(out, postscale_factor)


def hier_reduce_scatter_flat(
    f: torch.Tensor,
    *,
    average: bool,
    wire: str = "off",
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    shard_update: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """One bucket's hierarchical reduce-scatter + all-gather exchange
    (``HVD_TPU_SCHED_MODE=reduce_scatter`` on a ``hier`` bucket,
    ``:772-807``): both phases staged through the domains
    (``topo/hierarchical.py`` ``hierarchical_reduce_scatter`` and
    ``hierarchical_all_gather``), ``shard_update`` on the 1/(s·k) shard
    between them, a compressed ``wire`` on the cross-domain hops only.
    The all-gather inverts the reduce-scatter's shard layout exactly, so
    the result equals the flat exchange's elementwise."""
    from ..topo import hierarchical

    n = f.numel()
    g = _scale(f, prescale_factor)
    shard = hierarchical.hierarchical_reduce_scatter(g, op=Sum, wire=wire)
    if average:
        postscale_factor = postscale_factor / runtime.size()
    shard = _scale(shard, postscale_factor)
    if shard_update is not None:
        shard = shard_update(shard)
    return hierarchical.hierarchical_all_gather(shard, wire=wire)[:n]
