"""Execute stage: run the planned per-bucket collectives.

Counterpart of the flat path of ``horovod_tpu/sched/execute.py``:
``exchange`` (``:392``), ``bf16_wire`` (``:665``) and
``record_wire_metrics`` (``:197``).  Buckets run one after another in
schedule order: the JAX package ties each bucket to the previous one
with an optimization barrier so XLA keeps that order; eager PyTorch
issues the collectives in program order on one stream.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .. import metrics
from ..ops import fusion
from ..ops.kernels import cast_buffer
from .plan import Bucket, BucketSchedule, wire_bytes


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


def exchange(
    wire: Sequence[torch.Tensor],
    schedule: BucketSchedule,
    reduce_flat: Callable[[torch.Tensor, Bucket], torch.Tensor],
) -> List[torch.Tensor]:
    """Run ``schedule`` over the ``wire`` leaves: per bucket, flatten into
    one buffer per dtype, ``reduce_flat(flat, bucket)`` each, slice back
    out.  Returns the reduced leaves in index order (views of the reduced
    flat buffers)."""
    reduced = list(wire)
    for bucket in schedule.buckets:
        flats, meta = fusion.flatten_group([wire[i] for i in bucket.indices])
        outs = [reduce_flat(f, bucket) for f in flats]
        for i, t in zip(bucket.indices, fusion.unflatten_group(outs, meta)):
            reduced[i] = t
    metrics.inc_counter("sched.plans")
    metrics.inc_counter("sched.buckets", len(schedule))
    metrics.inc_counter("sched.exchange_bytes", schedule.total_bytes)
    metrics.set_gauge("sched.buckets_per_step", len(schedule))
    metrics.set_gauge("sched.bytes_per_step", schedule.total_bytes)
    record_wire_metrics(schedule)
    return reduced


def bf16_wire(reduce_dense: Callable[[torch.Tensor], torch.Tensor]):
    """Wrap a dense flat reducer with a bf16 cast around the wire: kernel
    B1 down-casts, the reducer runs on the bf16 buffer, B1 up-casts.  A
    non-floating or already-bf16 buffer goes to the reducer unchanged."""

    def reduce(f: torch.Tensor) -> torch.Tensor:
        if not f.dtype.is_floating_point or f.dtype == torch.bfloat16:
            return reduce_dense(f)
        return cast_buffer(reduce_dense(cast_buffer(f, torch.bfloat16)), f.dtype)

    return reduce
