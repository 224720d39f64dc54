"""Tensor fusion: bucketing small tensors into flat buffers.

Counterpart of ``horovod_tpu/ops/fusion.py`` (``flatten_group`` ``:44``,
``unflatten_group`` ``:66``, ``bucket_plan`` ``:77``,
``pad_to_atomic_unit`` ``:180``): one flat buffer
per dtype per bucket, one collective on it, then views sliced back out.
The bucket plan is the JAX package's greedy in-order plan with the
mixed-precision look-ahead bound, so both packages plan identical
buckets from the same sizes and dtypes: the native core's planner
(``native.fusion_plan``, ``cpp/src/fusion.cc``) where it is built and
its plan keeps the look-ahead bound (``:113-126``), else the same plan
in Python.  The autotune driver's candidate threshold reaches the plan
through the optimizer (``optim/distributed_optimizer.py``), not through
a module override as in the JAX package (``:32-40``).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from ..utils import env

Meta = Tuple[Any, ...]

def flatten_group(xs: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], Meta]:
    """Concatenate tensors into one new flat 1-D buffer per dtype.

    Returns (flat_buffers, meta); order within a dtype follows input
    order.  The buffers never alias the inputs, so a collective may
    reduce them in place."""
    by_dtype: dict = {}
    entries = []  # (dtype, offset, shape, index)
    for i, x in enumerate(xs):
        bufs = by_dtype.setdefault(x.dtype, [])
        offset = sum(b.numel() for b in bufs)
        bufs.append(x.reshape(-1))
        entries.append((x.dtype, offset, tuple(x.shape), i))
    flats = [torch.cat(bufs) for bufs in by_dtype.values()]
    return flats, (list(by_dtype), entries)


def unflatten_group(flats: Sequence[torch.Tensor], meta: Meta) -> List[torch.Tensor]:
    """Views of ``flats`` in the shapes ``flatten_group`` recorded."""
    dtype_order, entries = meta
    by_dtype = dict(zip(dtype_order, flats))
    out: List[torch.Tensor] = [None] * len(entries)  # type: ignore[list-item]
    for dtype, offset, shape, i in entries:
        size = 1
        for d in shape:
            size *= d
        out[i] = by_dtype[dtype][offset:offset + size].view(shape)
    return out


def bucket_plan(
    sizes_bytes: Sequence[int],
    dtypes: Sequence[str],
    threshold_bytes: int | None = None,
    look_ahead: int | None = None,
) -> List[List[int]]:
    """Greedy in-order bucketing under the fusion threshold.

    Consecutive tensors of one dtype share a bucket while the total
    stays within ``threshold_bytes`` (default ``HVD_TPU_FUSION_THRESHOLD``,
    64 MiB); a later same-dtype tensor may join an open bucket across
    interleaved dtypes until a different-dtype bucket has been open more
    than ``look_ahead`` positions (default ``HVD_TPU_SCHED_LOOK_AHEAD``,
    3; negative = unbounded).  A threshold of 0 gives one bucket per
    tensor.  Returns buckets as lists of tensor indices."""
    if threshold_bytes is None:
        threshold_bytes = env.get_int(env.FUSION_THRESHOLD, env.DEFAULT_FUSION_THRESHOLD)
    if look_ahead is None:
        look_ahead = env.get_int(env.SCHED_LOOK_AHEAD, 3)
    if threshold_bytes <= 0:
        return [[i] for i in range(len(sizes_bytes))]
    # The native planner predates the look-ahead bound, so its plan is
    # kept only when no bucket join violates the bound.
    from .. import native

    dtype_ids = {d: i for i, d in enumerate(dict.fromkeys(dtypes))}
    planned = native.fusion_plan(
        list(sizes_bytes), [dtype_ids[d] for d in dtypes], threshold_bytes
    )
    if planned is not None and not _violates_look_ahead(planned, dtypes, look_ahead):
        return planned
    # dtype -> [bucket, bytes, first_foreign_open_pos]
    open_buckets: dict = {}
    buckets: List[List[int]] = []
    for i, (sz, dt) in enumerate(zip(sizes_bytes, dtypes)):
        cur = open_buckets.get(dt)
        if (
            cur is not None
            and 0 <= look_ahead
            and cur[2] is not None
            and i - cur[2] > look_ahead
        ):
            # Stale: a different-dtype bucket opened more than
            # look_ahead positions ago; this bucket is closed for good.
            del open_buckets[dt]
            cur = None
        if cur is not None and cur[1] + sz <= threshold_bytes:
            cur[0].append(i)
            cur[1] += sz
        else:
            b = [i]
            buckets.append(b)
            for other_dt, entry in open_buckets.items():
                if other_dt != dt and entry[2] is None:
                    entry[2] = i
            open_buckets[dt] = [b, sz, None]
    return buckets


def _violates_look_ahead(
    plan: Sequence[Sequence[int]], dtypes: Sequence[str], look_ahead: int
) -> bool:
    """True when a bucket join in ``plan`` reaches across a
    different-dtype bucket opened more than ``look_ahead`` positions
    before the joining tensor (``:163``)."""
    if look_ahead < 0:
        return False
    opens = sorted((b[0], dtypes[b[0]]) for b in plan if b)
    for b in plan:
        if len(b) < 2:
            continue
        first, dt = b[0], dtypes[b[0]]
        for i in b[1:]:
            foreign = [pos for pos, d in opens if first < pos < i and d != dt]
            if foreign and i - foreign[0] > look_ahead:
                return True
    return False


def pad_to_atomic_unit(flat: torch.Tensor,
                       unit_bytes: int | None = None) -> Tuple[torch.Tensor, int]:
    """Pad a flat buffer with zeros so its byte size is a multiple of the
    atomic unit (default ``env.FUSION_BUFFER_ATOMIC_UNIT``; at least one
    element).  Returns (buffer, elements before the padding)."""
    if unit_bytes is None:
        unit_bytes = env.FUSION_BUFFER_ATOMIC_UNIT
    unit_elems = max(1, unit_bytes // flat.element_size())
    n = flat.shape[0]
    padded = -(-n // unit_elems) * unit_elems
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    return flat, n
