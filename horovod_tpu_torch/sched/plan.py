"""Plan stage: build a :class:`BucketSchedule` from gradient metadata.

Counterpart of ``horovod_tpu/sched/plan.py`` (``:80-388``): the same
config, buckets, schedule and wire rules, for the flat lowering and the
``off``/``bf16``/``int8``/``fp8`` wires.  Buckets are emitted in
reverse-backward order: the readiness order ``sched/hooks.py``
observed, else the reversed registration order.  The plan is a pure
function of its arguments, so every rank plans the same collectives in
the same order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import fusion
from ..ops.quantized import quant_block
from ..utils import env

# Per-bucket wire formats: "off" keeps the bucket on the dense (or
# compressor-cast) wire; "bf16" casts the bucket's flat buffer around
# the collective; "int8"/"fp8" route the bucket through the quantized
# exchange (ops/quantized.py).
WIRE_CHOICES = ("off", "bf16", "int8", "fp8")
QUANTIZED_WIRES = ("int8", "fp8")


def _canon_wire_choice(wire: str) -> str:
    w = (wire or "off").strip().lower()
    if w in ("none", "0", "false", "no", ""):
        w = "off"
    if w == "e4m3":
        w = "fp8"
    if w not in WIRE_CHOICES:
        raise ValueError(
            f"HVD_TPU_SCHED_WIRE must be one of {WIRE_CHOICES}, "
            f"got {wire!r}"
        )
    return w


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Knobs of the bucketed scheduler (``HVD_TPU_SCHED*``).

    ``barriers`` (``HVD_TPU_SCHED_BARRIERS``) is the JAX package's
    per-bucket sequencing that lets the exchange overlap the backward:
    on, ``DistributedOptimizer`` launches each bucket from the backward
    in schedule order (``sched/hooks.py``); off, after the backward.
    Off by default here (on in the JAX package): on the H100 the
    host-bound ResNet-50 step measured slower overlapped than after the
    backward (``PERF.md`` §6)."""

    enabled: bool = True
    bucket_bytes: Optional[int] = None  # None -> fusion threshold knob
    look_ahead: int = 3
    barriers: bool = False
    capture_order: bool = True
    wire: str = "off"  # "off" | "bf16" | "int8" | "fp8"
    wire_ef: bool = True  # error-feedback residuals for quantized wires

    def __post_init__(self):
        object.__setattr__(self, "wire", _canon_wire_choice(self.wire))

    @classmethod
    def from_env(cls) -> "SchedConfig":
        raw = (env.get_env(env.SCHED, "on") or "on").strip().lower()
        bucket_bytes = env.get_int(env.SCHED_BUCKET_BYTES, -1)
        return cls(
            enabled=raw not in ("off", "0", "false", "no"),
            bucket_bytes=None if bucket_bytes < 0 else bucket_bytes,
            look_ahead=env.get_int(env.SCHED_LOOK_AHEAD, 3),
            barriers=env.get_bool(env.SCHED_BARRIERS, False),
            capture_order=env.get_bool(env.SCHED_CAPTURE_ORDER, True),
            wire=env.get_env(env.SCHED_WIRE, "off") or "off",
            wire_ef=env.get_bool(env.SCHED_WIRE_EF, True),
        )


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fused exchange: leaf ``indices`` (registration order) sharing
    one collective of ``nbytes`` in total, on wire format ``wire``."""

    indices: Tuple[int, ...]
    nbytes: int
    wire_dtypes: Tuple[str, ...]  # distinct dtypes, index order
    pinned: bool = False  # from an explicit user group
    wire: str = "off"


@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """Ordered exchange plan for one list of gradients."""

    buckets: Tuple[Bucket, ...]
    total_bytes: int

    def __len__(self) -> int:
        return len(self.buckets)

    def signature(self) -> Tuple:
        return tuple(
            (b.indices, b.nbytes, b.wire_dtypes, b.pinned, b.wire)
            for b in self.buckets
        )


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the JAX package's dtype names."""
    return str(dtype).replace("torch.", "")


def build_schedule(
    sizes_bytes: Sequence[int],
    dtypes: Sequence[str],
    cfg: Optional[SchedConfig] = None,
    *,
    order: Optional[Sequence[int]] = None,
    pinned: Sequence[Sequence[int]] = (),
    wire: Optional[str] = None,
) -> BucketSchedule:
    """Plan the exchange for leaves of ``sizes_bytes``/``dtypes``.

    ``order`` is the backward-readiness order of leaf indices (first =
    first gradient ready); ``None``, or an order that does not name every
    leaf exactly once, means the reversed index order.  ``pinned`` groups
    fuse atomically and are emitted where their earliest-ready member
    falls.  ``wire`` overrides ``cfg.wire``; each bucket gets it only when
    :func:`eligible_wire` allows."""
    if cfg is None:
        cfg = SchedConfig.from_env()
    wire = _canon_wire_choice(cfg.wire if wire is None else wire)
    n = len(sizes_bytes)
    if order is None:
        order = range(n - 1, -1, -1)
    order = [i for i in order if 0 <= i < n]
    if len(set(order)) != n:
        order = list(range(n - 1, -1, -1))

    pinned_set = set()
    placed: List[Tuple[int, Bucket]] = []
    rank_of = {leaf: pos for pos, leaf in enumerate(order)}
    for group in pinned:
        idx = tuple(int(i) for i in group)
        if not idx:
            continue
        pinned_set.update(idx)
        placed.append((
            min(rank_of[i] for i in idx),
            _make_bucket(idx, sizes_bytes, dtypes, pinned=True, wire=wire),
        ))

    free = [i for i in order if i not in pinned_set]
    for b in fusion.bucket_plan(
        [sizes_bytes[i] for i in free],
        [dtypes[i] for i in free],
        cfg.bucket_bytes,
        look_ahead=cfg.look_ahead,
    ):
        idx = tuple(sorted(free[j] for j in b))
        placed.append((
            min(rank_of[i] for i in idx),
            _make_bucket(idx, sizes_bytes, dtypes, wire=wire),
        ))

    ordered = [b for _, b in sorted(placed, key=lambda p: p[0])]
    return BucketSchedule(
        buckets=tuple(ordered),
        total_bytes=sum(b.nbytes for b in ordered),
    )


def _is_floating(name: str) -> bool:
    dt = getattr(torch, name, None)
    return isinstance(dt, torch.dtype) and dt.is_floating_point


def eligible_wire(wire: str, wire_dtypes: Sequence[str]) -> str:
    """Downgrade a requested wire to what the bucket supports: bf16 needs
    floating leaves, a quantized wire one floating dtype per bucket;
    an ineligible bucket stays ``off``."""
    if wire == "off":
        return wire
    if not all(_is_floating(d) for d in wire_dtypes):
        return "off"
    if wire in QUANTIZED_WIRES and len(set(wire_dtypes)) != 1:
        return "off"
    return wire


def _make_bucket(
    indices: Tuple[int, ...],
    sizes_bytes: Sequence[int],
    dtypes: Sequence[str],
    pinned: bool = False,
    wire: str = "off",
) -> Bucket:
    wire_dtypes = tuple(dict.fromkeys(dtypes[i] for i in indices))
    return Bucket(
        indices=indices,
        nbytes=sum(int(sizes_bytes[i]) for i in indices),
        wire_dtypes=wire_dtypes,
        pinned=pinned,
        wire=eligible_wire(wire, wire_dtypes),
    )


def wire_bytes(bucket: Bucket) -> int:
    """One-phase wire payload bytes of a bucket: dense bytes for ``off``,
    2 bytes per element for ``bf16``, 1 byte per element plus a float32
    scale per block for the quantized wires."""
    if bucket.wire == "off":
        return bucket.nbytes
    itemsize = getattr(torch, bucket.wire_dtypes[0]).itemsize
    elems = bucket.nbytes // itemsize
    if bucket.wire == "bf16":
        return elems * 2
    return elems + 4 * (-(-elems // quant_block()))
