"""Execute stage: run the planned per-bucket collectives.

Counterpart of the flat path of ``horovod_tpu/sched/execute.py``:
``exchange`` (``:392``), ``quantized_exchange_flat`` (``:607``),
``bf16_wire`` (``:665``) and ``record_wire_metrics`` (``:197``).
Buckets run one after another in schedule order: the JAX package ties
each bucket to the previous one with an optimization barrier so XLA
keeps that order; eager PyTorch issues the collectives in program order
on one stream.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import metrics, runtime
from ..ops import fusion
from ..ops.collectives import Sum
from ..ops.kernels import cast_buffer, scale_cast
from ..ops.quantized import quantized_all_gather, quantized_reduce_scatter
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
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One bucket's quantized reduce-scatter + all-gather exchange:
    ``g = f·prescale (+ residual)`` in float32, quantized
    reduce-scatter, the shard scaled by ``postscale`` (and ``1/world``
    for an average), quantized all-gather, the first ``f.numel()``
    elements cast back to ``f.dtype``.

    ``residual`` engages error feedback: the wire carries
    ``quantize(g)`` and the new residual ``g − dequant(quantize(g))`` is
    returned alongside; without it the second result is None."""
    g = _scale_f32(f.float(), prescale_factor)
    r_new = None
    if residual is not None:
        g = g + residual.float()
        shard, r_new = quantized_reduce_scatter(g, Sum, wire=wire, ef=True)
    else:
        shard = quantized_reduce_scatter(g, Sum, wire=wire)
    if average:
        postscale_factor = postscale_factor / runtime.size()
    shard = _scale_f32(shard, postscale_factor)
    out = quantized_all_gather(shard, wire=wire)[:f.numel()]
    return out.to(f.dtype), r_new
