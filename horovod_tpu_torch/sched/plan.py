"""Plan stage: build a :class:`BucketSchedule` from gradient metadata.

Counterpart of ``horovod_tpu/sched/plan.py`` (``:80-388``): the same
config, buckets, schedule and wire rules, for the ``off``/``bf16``/
``int8``/``fp8`` wires, and each bucket's lowering (``LOWER_CHOICES``
``:45-60``, ``SchedConfig.lowering`` ``:90``, ``resolve_lowering``
``:311``, ``_make_bucket`` ``:346-365``): ``flat``, ``hier`` or
``hier_adasum`` (``topo/hierarchical.py``).  On one host every
request resolves ``flat`` (the topology has one domain), so the
schedule is the one the flat-only plan built.  Buckets are emitted in
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

# Per-bucket lowerings.  "flat" is the single-collective exchange;
# "hier" stages it as intra-domain reduce_scatter -> cross-domain
# all_reduce of the 1/k shard -> intra-domain all_gather
# (topo/hierarchical.py); "hier_adasum" keeps hier's staging but
# combines across domains with Adasum: float buckets on multi-domain
# topologies only, and never picked by "auto" (it changes the
# reduction; it is asked for by the knob, op=Adasum or the Adasum
# optimizer).  Under HVD_TPU_TOPO_LOWER=auto the cost model picks
# between the sum-preserving pair per bucket.
LOWER_CHOICES = ("flat", "hier", "hier_adasum")


def _canon_lowering(lowering: str) -> str:
    lo = (lowering or "auto").strip().lower()
    if lo in ("off", "none", "0", "false", "no", ""):
        lo = "flat"
    if lo in ("on", "1", "true", "yes", "hierarchical"):
        lo = "hier"
    if lo == "adasum":
        lo = "hier_adasum"
    if lo not in LOWER_CHOICES + ("auto",):
        raise ValueError(
            f"HVD_TPU_TOPO_LOWER must be auto|flat|hier|hier_adasum, "
            f"got {lowering!r}"
        )
    return lo


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
    backward (``PERF.md`` §6).  ``mode`` (``HVD_TPU_SCHED_MODE``) is how
    ``DistributedOptimizer`` exchanges a plain world Sum or Average
    bucket: ``allreduce`` or ``reduce_scatter`` (a reduce-scatter and an
    all-gather, ``sched/execute.py`` ``reduce_scatter_flat``)."""

    enabled: bool = True
    mode: str = "allreduce"  # "allreduce" | "reduce_scatter"
    bucket_bytes: Optional[int] = None  # None -> fusion threshold knob
    look_ahead: int = 3
    barriers: bool = False
    capture_order: bool = True
    wire: str = "off"  # "off" | "bf16" | "int8" | "fp8"
    wire_ef: bool = True  # error-feedback residuals for quantized wires
    # "auto" | "flat" | "hier" | "hier_adasum" (HVD_TPU_TOPO_LOWER)
    lowering: str = "auto"

    def __post_init__(self):
        if self.mode not in ("allreduce", "reduce_scatter"):
            raise ValueError(
                f"HVD_TPU_SCHED_MODE must be 'allreduce' or "
                f"'reduce_scatter', got {self.mode!r}"
            )
        object.__setattr__(self, "wire", _canon_wire_choice(self.wire))
        object.__setattr__(self, "lowering", _canon_lowering(self.lowering))

    @classmethod
    def from_env(cls) -> "SchedConfig":
        raw = (env.get_env(env.SCHED, "on") or "on").strip().lower()
        bucket_bytes = env.get_int(env.SCHED_BUCKET_BYTES, -1)
        return cls(
            enabled=raw not in ("off", "0", "false", "no"),
            mode=(env.get_env(env.SCHED_MODE, "allreduce") or "allreduce")
            .strip().lower(),
            bucket_bytes=None if bucket_bytes < 0 else bucket_bytes,
            look_ahead=env.get_int(env.SCHED_LOOK_AHEAD, 3),
            barriers=env.get_bool(env.SCHED_BARRIERS, False),
            capture_order=env.get_bool(env.SCHED_CAPTURE_ORDER, True),
            wire=env.get_env(env.SCHED_WIRE, "off") or "off",
            wire_ef=env.get_bool(env.SCHED_WIRE_EF, True),
            lowering=env.get_env(env.TOPO_LOWER, "auto") or "auto",
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
    lowering: str = "flat"  # "flat" | "hier" | "hier_adasum"


@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """Ordered exchange plan for one list of gradients."""

    buckets: Tuple[Bucket, ...]
    total_bytes: int

    def __len__(self) -> int:
        return len(self.buckets)

    def signature(self) -> Tuple:
        return tuple(
            (b.indices, b.nbytes, b.wire_dtypes, b.pinned, b.wire, b.lowering)
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
    lowering: str = "flat",
    axis_size: Optional[int] = None,
) -> BucketSchedule:
    """Plan the exchange for leaves of ``sizes_bytes``/``dtypes``.

    ``order`` is the backward-readiness order of leaf indices (first =
    first gradient ready); ``None``, or an order that does not name every
    leaf exactly once, means the reversed index order.  ``pinned`` groups
    fuse atomically and are emitted where their earliest-ready member
    falls.  ``wire`` overrides ``cfg.wire``; each bucket gets it only when
    :func:`eligible_wire` allows.  ``lowering`` is the requested lowering
    (the caller's choice between ``cfg.lowering`` and ``flat``, as the
    JAX package's ``_reduce_gradients`` makes it), resolved per bucket by
    :func:`resolve_lowering` over an axis of ``axis_size`` ranks (None:
    the topology's world)."""
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
            _make_bucket(idx, sizes_bytes, dtypes, pinned=True, wire=wire,
                         lowering=lowering, axis_size=axis_size),
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
            _make_bucket(idx, sizes_bytes, dtypes, wire=wire, lowering=lowering,
                         axis_size=axis_size),
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


def resolve_lowering(
    requested: str, nbytes: int, axis_size: Optional[int] = None,
    wire_dtypes: Sequence[str] = (),
) -> str:
    """Resolve a requested lowering ("auto"/"flat"/"hier"/"hier_adasum")
    to the concrete per-bucket choice (``:311``).  "auto" asks the
    topology cost model (flat against hier only); a single-domain
    topology, or an axis that does not factor, always resolves flat, so
    the flat-only schedule is reproduced exactly; a hier_adasum request
    on a non-floating bucket resolves flat too (the coefficients divide
    by norms)."""
    requested = _canon_lowering(requested)
    if requested == "flat":
        return "flat"
    from ..topo import model as topo_model

    topo = topo_model.current()
    n = topo.world if axis_size is None else axis_size
    s, _ = topo.factor_axis(n)
    if s == 1:
        return "flat"
    if requested == "hier_adasum":
        if wire_dtypes and not all(_is_floating(d) for d in wire_dtypes):
            return "flat"
        return "hier_adasum"
    if requested == "hier":
        return "hier"
    return topo.choose_lowering("all_reduce", nbytes, n)


def _make_bucket(
    indices: Tuple[int, ...],
    sizes_bytes: Sequence[int],
    dtypes: Sequence[str],
    pinned: bool = False,
    wire: str = "off",
    lowering: str = "flat",
    axis_size: Optional[int] = None,
) -> Bucket:
    wire_dtypes = tuple(dict.fromkeys(dtypes[i] for i in indices))
    nbytes = sum(int(sizes_bytes[i]) for i in indices)
    return Bucket(
        indices=indices,
        nbytes=nbytes,
        wire_dtypes=wire_dtypes,
        pinned=pinned,
        wire=eligible_wire(wire, wire_dtypes),
        lowering=resolve_lowering(lowering, nbytes, axis_size, wire_dtypes),
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
