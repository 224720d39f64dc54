"""Measured cost model: fit effective link parameters from telemetry.

Copy of ``horovod_tpu/topo/fit.py``.  The static cost model
(``model.Topology``) prices the fast and slow rails from env defaults no
real cluster matches; this module fits them from what was measured:

1. **Tagged observations.**  Every timed collective dispatch lands in a
   registry histogram *cell* named
   ``topo.obs.<collective>.<lowering>.n<axis>.b<log2(nbytes)>`` with a
   parallel ``.bytes`` counter, so each cell knows its latency
   distribution and its mean payload.  The eager layer feeds flat cells
   (``ops/eager.py`` ``_timed``); benches and tests feed others through
   :func:`record_observation`.

2. **Least-squares fit.**  The ring model is linear in
   ``(phase_overhead, ici_lat, dcn_lat, 1/ici_bw, 1/dcn_bw)``:
   :func:`~horovod_tpu_torch.topo.model.cost_coefficients` gives each
   cell's row, the cell's p50 (``metrics.quantile``) is the target, and
   :func:`fit_link_params` solves the weighted system once enough
   observations accumulate.  Columns the data does not pin keep their
   static values; non-physical solutions are rejected.

3. **Preferred pricing.**  ``Topology.estimate_cost`` /
   ``choose_lowering`` price with :func:`effective_params`, the fit when
   one exists for the topology's shape, the static fields otherwise.
   Fitted values surface as ``topo.fitted_*`` gauges;
   ``HVD_TPU_TOPO_FIT=off`` restores static pricing.

Two things differ from the JAX package.  ``HVD_TPU_TOPO_FIT`` unset is
off on an NCCL process group and on elsewhere (see below); ``on`` or
``1`` turns the fit on there too.  And in a world of several ranks the
pricing reads rank 0's fit, which the data-parallel plan broadcasts
(:func:`share`, from ``optim/distributed_optimizer.py`` ``_plan``):
each rank refits on its own clock, and two fits could resolve one
bucket ``flat`` on one rank and ``hier`` on another, whose collectives
would then not match.  Until a plan has shared one, every rank prices
statically.

What an observation is on the card: the eager layer times the *host*
dispatch of a collective, as the JAX package does.  An NCCL call returns
once its kernel is queued on the stream, so on an H100 a cell holds the
enqueue cost (microseconds, almost flat in the payload), not the
transfer; gloo on the CPU blocks until the collective is done.  A fit
over NCCL cells therefore prices the host overhead and reads a huge
bandwidth (``PERF.md`` records what it fitted on the card), which is
why it prices nothing there unless asked to.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from .. import metrics
from ..utils import env
from ..utils.logging import get_logger

OBS_PREFIX = "topo.obs."

# Dispatch latencies span sub-microsecond (cached async enqueue) to
# seconds (cold compile): a finer ladder than LATENCY_BUCKETS so the
# p50 interpolation has resolution where collectives actually live.
OBS_BUCKETS: Tuple[float, ...] = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5,
)

_FIT_COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather")
_PARAM_NAMES = (
    "phase_overhead_s", "ici_latency_s", "dcn_latency_s",
    "ici_gbps", "dcn_gbps",
)

# Minimum observations per cell before its p50 is trusted, and minimum
# distinct cells before a fit is attempted (the system has up to 5
# unknowns; fewer rows than active columns is underdetermined).
MIN_CELL_OBS = 4


@dataclasses.dataclass(frozen=True)
class Cell:
    """One observation cell: a (collective, lowering, axis, size-bin)
    bucket with its measured p50 and mean payload."""

    collective: str
    lowering: str
    axis_size: int
    mean_nbytes: float
    p50_s: float
    count: int


@dataclasses.dataclass(frozen=True)
class FittedParams:
    """Effective link parameters fitted from observation cells, plus
    the topology shape they were fitted against (fits never leak onto
    a different shape)."""

    phase_overhead_s: float
    ici_latency_s: float
    dcn_latency_s: float
    ici_gbps: float
    dcn_gbps: float
    topo_key: Tuple[int, int]  # (num_slices, slice_size)
    n_cells: int
    n_observations: int
    fitted_fields: Tuple[str, ...]  # columns the data actually pinned

    def as_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in _PARAM_NAMES}


_lock = threading.Lock()
_fitted: Optional[FittedParams] = None
_obs_count = 0
_last_fit_at = 0
_fit_failed_logged = False
# Fit epoch: bumped every time the effective cost parameters change (a
# successful refit, or a reset back to static pricing).  Consumers that
# memoize lowering decisions — xir/lower.py's store-sync memo, the
# svc/ ResponseCache — fold this into their keys so a refit invalidates
# them instead of pinning pre-fit flat/hier choices forever.
_fit_epoch = 0
# Rank 0's fit as the last plan broadcast it: what every rank prices
# with in a world of several ranks (module docstring).
_shared: Optional[FittedParams] = None


def fit_epoch() -> int:
    """Monotonic epoch of the effective cost parameters (see above)."""
    with _lock:
        return _fit_epoch


def enabled() -> bool:
    """``HVD_TPU_TOPO_FIT`` policy: ``off``/``0`` keeps the static
    env-parameter model; unset, fitted pricing is on except on an NCCL
    process group, whose cells hold enqueue times (module docstring)."""
    raw = (env.get_env(env.TOPO_FIT) or "").strip().lower()
    if not raw:
        return _backend() != "nccl"
    return raw not in ("off", "0", "false", "no")


def _backend() -> Optional[str]:
    from .. import runtime

    return runtime.get_runtime().backend if runtime.is_initialized() else None


def _several_ranks() -> bool:
    from .. import runtime

    return runtime.is_initialized() and runtime.size() > 1


def min_observations() -> int:
    return max(1, env.get_int(env.TOPO_FIT_MIN_OBS, 32))


def refit_every() -> int:
    return max(1, env.get_int(env.TOPO_FIT_REFIT_EVERY, 16))


def cell_name(collective: str, lowering: str, axis_size: int,
              nbytes: int) -> str:
    return (
        f"{OBS_PREFIX}{collective}.{lowering}."
        f"n{int(axis_size)}.b{max(int(nbytes), 1).bit_length() - 1}"
    )


def record_observation(collective: str, lowering: str, nbytes: int,
                       axis_size: int, seconds: float) -> None:
    """Feed one measured collective into its observation cell.  Called
    from the eager dispatch timer (flat cells) and from benches/tests
    for hierarchical cells; out-of-model inputs (single-member axis,
    empty payload) are dropped silently — the hot path never raises."""
    global _obs_count
    if (collective not in _FIT_COLLECTIVES
            or lowering not in ("flat", "hier", "hier_adasum")
            or axis_size <= 1 or nbytes <= 0 or seconds < 0):
        return
    name = cell_name(collective, lowering, axis_size, nbytes)
    metrics.observe(name, float(seconds), buckets=OBS_BUCKETS)
    metrics.inc_counter(name + ".bytes", int(nbytes))
    with _lock:
        _obs_count += 1


def observed_cells() -> List[Cell]:
    """Parse the registry's ``topo.obs.*`` histograms back into cells
    (skipping any with fewer than ``MIN_CELL_OBS`` samples)."""
    snap = metrics.snapshot()
    cells: List[Cell] = []
    for name, hist in snap.get("histograms", {}).items():
        if not name.startswith(OBS_PREFIX):
            continue
        parts = name[len(OBS_PREFIX):].split(".")
        if len(parts) != 4:
            continue
        collective, lowering, n_tag, _b_tag = parts
        if (collective not in _FIT_COLLECTIVES
                or lowering not in ("flat", "hier", "hier_adasum")
                or not n_tag.startswith("n")):
            continue
        try:
            axis_size = int(n_tag[1:])
        except ValueError:
            continue
        count = int(hist.get("count", 0))
        if count < MIN_CELL_OBS:
            continue
        p50 = metrics.hist_quantile(hist, 0.5)
        total_bytes = snap.get("counters", {}).get(name + ".bytes", 0)
        if p50 is None or p50 <= 0 or total_bytes <= 0:
            continue
        cells.append(Cell(
            collective=collective, lowering=lowering, axis_size=axis_size,
            mean_nbytes=total_bytes / count, p50_s=float(p50), count=count,
        ))
    return cells


def fit_link_params(topo=None,
                    cells: Optional[List[Cell]] = None
                    ) -> Optional[FittedParams]:
    """Weighted least squares of the ring model over the observation
    cells.  Returns None (static pricing stands) when the system is
    underdetermined or the solution is non-physical."""
    import numpy as np

    from . import model as topo_model

    topo = topo if topo is not None else topo_model.current()
    cells = observed_cells() if cells is None else cells
    rows, targets, weights = [], [], []
    for c in cells:
        coeff = topo_model.cost_coefficients(
            c.collective, c.mean_nbytes, c.lowering, c.axis_size, topo,
        )
        if not any(coeff):
            continue  # degenerate cell (axis collapses to one member)
        rows.append(coeff)
        targets.append(c.p50_s)
        weights.append(float(c.count) ** 0.5)
    if not rows:
        return None
    a = np.asarray(rows, dtype=np.float64)
    y = np.asarray(targets, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    # Static parameter values in solve space (columns 3/4 carry
    # INVERSE bytes/s): the fallback for any column the data cannot
    # pin to a physical value.
    static_x = [
        topo.phase_overhead_s, topo.ici_latency_s, topo.dcn_latency_s,
        1.0 / (topo.ici_gbps * 1e9), 1.0 / (topo.dcn_gbps * 1e9),
    ]
    active = [j for j in range(a.shape[1]) if np.any(a[:, j] != 0.0)]
    y_adj = y.copy()
    fitted: dict = {}
    # Non-physical columns (negative bandwidth, materially negative
    # latency — usually a noise artifact on a term the data barely
    # exercises) fall back to their STATIC value one at a time and the
    # rest re-solves, so one ill-conditioned column cannot discard an
    # otherwise solvable fit.
    while active:
        if len(rows) < len(active):
            return None  # underdetermined: keep static pricing
        a_act = a[:, active]
        # Column scaling: byte coefficients are ~1e9x the hop counts;
        # an unscaled solve loses the latency columns to round-off.
        scale = np.max(np.abs(a_act), axis=0)
        scale[scale == 0.0] = 1.0
        sol, *_ = np.linalg.lstsq(
            (a_act / scale) * w[:, None], y_adj * w, rcond=None
        )
        sol = sol / scale
        bad = [
            j for j, x in zip(active, sol)
            if (x <= 0 if j >= 3 else x < -1e-4)
        ]
        if not bad:
            for j, x in zip(active, sol):
                fitted[j] = max(float(x), 0.0)
            break
        for j in bad:
            y_adj = y_adj - a[:, j] * static_x[j]
            active.remove(j)
    if not fitted:
        return None  # nothing identifiable: static pricing stands
    out = list(static_x)
    for j, x in fitted.items():
        out[j] = x
    return FittedParams(
        phase_overhead_s=out[0], ici_latency_s=out[1],
        dcn_latency_s=out[2],
        ici_gbps=1.0 / out[3] / 1e9,
        dcn_gbps=1.0 / out[4] / 1e9,
        topo_key=(topo.num_slices, topo.slice_size),
        n_cells=len(rows),
        n_observations=sum(c.count for c in cells),
        fitted_fields=tuple(
            _PARAM_NAMES[j] for j in sorted(fitted)
        ),
    )


def _publish(fp: FittedParams) -> None:
    metrics.set_gauge("topo.fitted_ici_gbps", fp.ici_gbps)
    metrics.set_gauge("topo.fitted_dcn_gbps", fp.dcn_gbps)
    metrics.set_gauge("topo.fitted_ici_lat_us", fp.ici_latency_s * 1e6)
    metrics.set_gauge("topo.fitted_dcn_lat_us", fp.dcn_latency_s * 1e6)
    metrics.set_gauge(
        "topo.fitted_phase_overhead_us", fp.phase_overhead_s * 1e6
    )
    metrics.set_gauge("topo.fit.cells", fp.n_cells)
    metrics.set_gauge("topo.fit.observations", fp.n_observations)
    metrics.inc_counter("topo.fit.updates")


def refresh(topo=None, force: bool = False) -> Optional[FittedParams]:
    """Re-fit when enough new observations accumulated (``force`` skips
    the accumulation gate, not the solvability checks).  Thread-safe;
    a failed fit leaves the previous one in place."""
    global _fitted, _last_fit_at, _fit_failed_logged
    with _lock:
        count = _obs_count
        due = force or (
            count >= min_observations()
            and count - _last_fit_at >= refit_every()
        )
        if due:
            _last_fit_at = count  # claim this batch (even if fit fails)
    if not due:
        return _fitted
    fp = fit_link_params(topo)
    if fp is not None:
        global _fit_epoch
        with _lock:
            _fitted = fp
            _fit_epoch += 1
            metrics.set_gauge("topo.fit.epoch", _fit_epoch)
        _publish(fp)
        get_logger().info(
            "topo fit: %d cells / %d obs -> ici %.1f GB/s, dcn %.1f "
            "GB/s, lat %.1f/%.1f us, overhead %.1f us (fitted: %s)",
            fp.n_cells, fp.n_observations, fp.ici_gbps, fp.dcn_gbps,
            fp.ici_latency_s * 1e6, fp.dcn_latency_s * 1e6,
            fp.phase_overhead_s * 1e6, ",".join(fp.fitted_fields),
        )
    elif not _fit_failed_logged:
        _fit_failed_logged = True
        get_logger().debug(
            "topo fit: observations not yet solvable; static pricing "
            "stands"
        )
    return _fitted


def local_params() -> Optional[FittedParams]:
    """This process's own fit (refreshed when due), or None when fitting
    is disabled or nothing solvable was observed."""
    return refresh() if enabled() else None


def share(fp: Optional[FittedParams]) -> None:
    """Adopt ``fp``, rank 0's :func:`local_params`, as the fit every
    rank of a world of several prices with (module docstring)."""
    global _shared, _fit_epoch
    with _lock:
        if fp != _shared:
            _shared = fp
            _fit_epoch += 1


def fitted_params(topo=None) -> Optional[FittedParams]:
    """The current fitted parameters for ``topo``'s shape, or None when
    fitting is disabled, nothing solvable was observed, or the fit
    belongs to a different topology shape.  Fits are always solved
    against the process-wide topology (``model.current()``) — the pod
    the observations came from — never against a caller's ad-hoc
    instance; an instance merely *reads* the fit when its shape
    matches.  In a world of several ranks this is the fit rank 0 last
    shared (:func:`share`)."""
    fp = _shared if _several_ranks() else local_params()
    if fp is None:
        return None
    if topo is not None and fp.topo_key != (topo.num_slices,
                                            topo.slice_size):
        return None
    return fp


def effective_params(topo) -> Tuple[float, float, float, float, float]:
    """The link parameters every cost entry point prices with:
    ``(phase_overhead_s, ici_lat_s, dcn_lat_s, ici_bytes_per_s,
    dcn_bytes_per_s)`` — the *measured* fit when one exists for
    ``topo``'s shape (and ``HVD_TPU_TOPO_FIT`` allows it), the static
    env/instance fields otherwise.  Shared by
    ``Topology.estimate_cost``/``rail_times`` and the rail pipeliner's
    split-point search (``xir/pipeline.py``), so schedule pricing and
    bucket splitting can never disagree about the per-rail
    bandwidths."""
    fp = fitted_params(topo)
    if fp is not None:
        return (
            fp.phase_overhead_s, fp.ici_latency_s, fp.dcn_latency_s,
            fp.ici_gbps * 1e9, fp.dcn_gbps * 1e9,
        )
    return (
        topo.phase_overhead_s, topo.ici_latency_s, topo.dcn_latency_s,
        topo.ici_gbps * 1e9, topo.dcn_gbps * 1e9,
    )


def reset() -> None:
    """Drop the fitted state and the observation cells (test isolation;
    called from ``topo.model.reset`` so one reset covers the package)."""
    global _fitted, _obs_count, _last_fit_at, _fit_failed_logged
    global _fit_epoch, _shared
    with _lock:
        # A reset changes effective pricing back to the static fields:
        # that is a parameter change too, so the epoch advances (the
        # memo-invalidation contract) — it never rewinds to 0, which
        # would collide with keys cached before the reset.
        if _fitted is not None or _shared is not None:
            _fit_epoch += 1
        _fitted = None
        _shared = None
        _obs_count = 0
        _last_fit_at = 0
        _fit_failed_logged = False
    metrics.reset_counters(OBS_PREFIX)
    # "topo.fit" prefixes both the fit bookkeeping and the fitted_*
    # gauges — one reset covers them.
    metrics.reset_counters("topo.fit")
