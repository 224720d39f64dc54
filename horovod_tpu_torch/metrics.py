"""Process-local metrics registry, its renders and ``metric_average``.

Counterpart of ``horovod_tpu/metrics.py``: counters, last-write-wins
(optionally labelled) gauges and fixed-bucket histograms (``_Histogram``
``:65``, ``observe`` ``:183``, the quantiles), under the JAX package's
names, with the same ``snapshot`` (``:251``), ``render_json`` (``:267``)
and ``render_prometheus`` (``:288``), so one sequence of records renders
to the same strings on both sides.  :func:`metric_average` (``:338``)
averages a host scalar across the ranks of the world or of a process
set.

What the port records:

- the data-parallel step: ``sched.buckets``, ``sched.buckets_per_step``,
  ``sched.bytes_per_step``, ``sched.wire_bytes{wire=}``,
  ``sched.wire_bytes.<wire>``, ``sched.compression_ratio`` and the
  histograms ``sched.bytes_per_bucket`` and ``sched.exchange_seconds``
  (``sched/execute.py``); the quantized wire counts
  ``quant.fused_collectives`` and ``quant.fused_bytes``
  (``ops/quantized.py``) above a world of one.  They are recorded in
  Python, so a step captured into a CUDA graph records them once, at
  capture, as the JAX package records them once per trace; its replays
  record nothing.  ``TrainStep`` publishes ``sched.onestep.engaged{mode=}``
  (1 when the call ran the captured step), counts ``xir.onestep.steps``
  once per capture, and counts ``train.steps`` and observes
  ``train.step_seconds`` (host time of the call) on every call;
- each eager collective: ``collective.<op>.dispatches``,
  ``collective.<op>.bytes``, the ``collective.<op>.bytes_hist`` and
  ``collective.<op>.dispatch_seconds`` histograms (``ops/eager.py``),
  and the measured cost model's ``topo.obs.*`` cells and
  ``topo.fitted_*`` gauges (``topo/fit.py``);
- the tuners' ``sched.tune.*`` (``sched/tune.py``, ``sched/store.py``),
  ``retry.<name>.*`` (``utils/retry.py``) and
  ``faults.injected.<site>.<kind>`` (``faults.py``).
"""

from __future__ import annotations

import json
import threading
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

_lock = threading.Lock()
_counters: Dict[str, int] = {}
# gauge key: (name, tuple(sorted(labels.items()))) -> float
_gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
_histograms: Dict[str, "_Histogram"] = {}

# Default bucket ladders (seconds / bytes), Prometheus-conventional.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
BYTES_BUCKETS: Tuple[float, ...] = (
    1 << 10, 1 << 14, 1 << 18, 1 << 20, 1 << 22, 1 << 24,
    1 << 26, 1 << 28, 1 << 30,
)


class _Histogram:
    """Fixed upper-bound buckets + sum + count (no lock of its own:
    every mutation happens under the module lock)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds: Tuple[float, ...] = tuple(sorted(bounds))
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +inf slot
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        return hist_quantile(self.to_dict(), q)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "buckets": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


def hist_quantile(hist: Dict[str, Any], q: float) -> Optional[float]:
    """Quantile estimate from a fixed-bucket histogram dict (the
    ``to_dict`` / snapshot shape) by linear interpolation inside the
    bucket the target rank lands in (Prometheus ``histogram_quantile``).
    Observations beyond the last finite bound clamp to it.  ``None`` on
    an empty histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    bounds = hist.get("buckets") or []
    counts = hist.get("counts") or []
    total = hist.get("count", 0)
    if total <= 0 or not bounds:
        return None
    target = q * total
    cumulative = 0
    lo = 0.0
    for bound, n in zip(bounds, counts):
        if n > 0 and cumulative + n >= target:
            frac = (target - cumulative) / n
            return lo + (float(bound) - lo) * frac
        cumulative += n
        lo = float(bound)
    return float(bounds[-1])


def inc_counter(name: str, value: int = 1) -> int:
    """Bump a named counter; returns the new value."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value
        return _counters[name]


def get_counter(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def get_counters(prefix: str = "") -> Dict[str, int]:
    """Snapshot of the counters (optionally filtered by name prefix)."""
    with _lock:
        return {k: v for k, v in sorted(_counters.items()) if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Clear counters, histograms and gauges whose names start with
    ``prefix`` (every one without it): one reset hook for the whole
    registry, as in the JAX package."""
    with _lock:
        for store in (_counters, _histograms):
            if not prefix:
                store.clear()
            else:
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]
        for key in [k for k in _gauges if k[0].startswith(prefix)]:
            del _gauges[key]


def reset(prefix: str = "") -> None:
    """:func:`reset_counters`, the name the port's callers use."""
    reset_counters(prefix)


def set_gauge(name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
    key = (name, tuple(sorted((labels or {}).items())))
    with _lock:
        _gauges[key] = float(value)


def get_gauge(name: str,
              labels: Optional[Dict[str, str]] = None) -> Optional[float]:
    key = (name, tuple(sorted((labels or {}).items())))
    with _lock:
        return _gauges.get(key)


def clear_gauge(name: str) -> None:
    """Drop every series of a gauge family."""
    with _lock:
        for key in [k for k in _gauges if k[0] == name]:
            del _gauges[key]


def observe(name: str, value: float,
            buckets: Sequence[float] = LATENCY_BUCKETS) -> None:
    """Record one observation into the named histogram (created on first
    touch with ``buckets``; later calls keep its ladder)."""
    with _lock:
        hist = _histograms.get(name)
        if hist is None:
            hist = _histograms[name] = _Histogram(buckets)
        hist.observe(float(value))


def get_histogram(name: str) -> Optional[Dict[str, Any]]:
    with _lock:
        hist = _histograms.get(name)
        return hist.to_dict() if hist else None


def histograms_by_prefix(
    prefix: str, snap: Optional[Dict[str, Any]] = None
) -> Dict[str, Dict[str, Any]]:
    """Every histogram whose name starts with ``prefix``, from a snapshot
    dict or the live registry."""
    if snap is not None:
        hists = snap.get("histograms", {})
        return {k: v for k, v in hists.items() if k.startswith(prefix)}
    with _lock:
        return {k: h.to_dict() for k, h in sorted(_histograms.items())
                if k.startswith(prefix)}


def gauges_by_prefix(
    prefix: str, snap: Optional[Dict[str, Any]] = None
) -> List[Dict[str, Any]]:
    """Every gauge whose name starts with ``prefix``, as ``[{name, labels,
    value}]`` rows, from a snapshot dict or the live registry."""
    if snap is not None:
        return [g for g in snap.get("gauges", [])
                if str(g.get("name", "")).startswith(prefix)]
    with _lock:
        return [{"name": k[0], "labels": dict(k[1]), "value": v}
                for k, v in sorted(_gauges.items()) if k[0].startswith(prefix)]


def quantile(name: str, q: float) -> Optional[float]:
    """Interpolated quantile of the named histogram; None when it is
    absent or empty (``topo/fit.py`` reads its cells' p50 through it)."""
    with _lock:
        hist = _histograms.get(name)
        if hist is None:
            return None
        snap = hist.to_dict()
    return hist_quantile(snap, q)


def snapshot() -> Dict[str, Any]:
    """JSON-serializable snapshot of the whole registry."""
    with _lock:
        return {
            "counters": dict(sorted(_counters.items())),
            "gauges": [
                {"name": k[0], "labels": dict(k[1]), "value": v}
                for k, v in sorted(_gauges.items())
            ],
            "histograms": {k: h.to_dict() for k, h in sorted(_histograms.items())},
        }


def render_json() -> str:
    return json.dumps(snapshot(), sort_keys=True)


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""

    def esc(v: Any) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"')

    inner = ",".join(f'{_prom_name(k)}="{esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(snap: Optional[Dict[str, Any]] = None,
                      prefix: str = "hvd_tpu",
                      extra_labels: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition of a registry snapshot (this process's
    by default); ``extra_labels`` stamps every series (``{"rank": r}``)."""
    snap = snap if snap is not None else snapshot()
    base = dict(extra_labels or {})
    lines: List[str] = []
    for name, value in snap.get("counters", {}).items():
        fam = f"{prefix}_{_prom_name(name)}_total"
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam}{_prom_labels(base)} {value}")
    for g in snap.get("gauges", []):
        fam = f"{prefix}_{_prom_name(g['name'])}"
        lines.append(f"# TYPE {fam} gauge")
        lines.append(f"{fam}{_prom_labels({**base, **g.get('labels', {})})} {g['value']}")
    for name, h in snap.get("histograms", {}).items():
        fam = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {fam} histogram")
        cumulative = 0
        for bound, n in zip(h["buckets"], h["counts"]):
            cumulative += n
            lines.append(
                f"{fam}_bucket{_prom_labels({**base, 'le': repr(float(bound))})} "
                f"{cumulative}"
            )
        lines.append(f"{fam}_bucket{_prom_labels({**base, 'le': '+Inf'})} {h['count']}")
        # Quantile estimates from the fixed ladder (summary-style lines).
        for q in (0.5, 0.99):
            est = hist_quantile(h, q)
            if est is not None:
                lines.append(f"{fam}{_prom_labels({**base, 'quantile': str(q)})} {est}")
        lines.append(f"{fam}_sum{_prom_labels(base)} {h['sum']}")
        lines.append(f"{fam}_count{_prom_labels(base)} {h['count']}")
    return "\n".join(lines) + "\n"


def metric_average(value: Any, process_set=None) -> Any:
    """Average a host scalar (or a pytree of scalars) across ranks.

    A world of one (or no runtime) returns ``value`` unchanged.  Every
    rank of the world takes part in one object allgather of its values
    (``functions.allgather_object``); with ``process_set`` the members
    average over the set's ranks and a non-member gets its own value
    back, as in the JAX package (whose processes are the port's ranks).
    The mean is taken in float64 over the members in rank order."""
    import numpy as np
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from . import functions, runtime
    from .process_sets import resolve

    if not runtime.is_initialized() or runtime.size() == 1:
        return value
    ps = resolve(process_set)
    members = list(range(runtime.size())) if ps is None else sorted(ps.ranks)
    leaves, spec = tree_flatten(value)
    arr = np.asarray([float(v) for v in leaves], dtype=np.float64)
    gathered = np.asarray(functions.allgather_object(arr))
    if runtime.rank() not in members:
        return value
    mean = gathered[members].mean(axis=0)
    return tree_unflatten([float(m) for m in mean], spec)
