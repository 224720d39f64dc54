"""Tune stage: drive the bucket-size knob from registry metrics.

Counterpart of ``horovod_tpu/sched/tune.py`` (``registry_view``,
``window_score``, ``ScheduleTuner``).  ``utils/autotune.FusionAutotuner``
owns the suggest/observe search; the scheduler adds the scoring feed:
scores come from the metrics registry (``train.steps``, the
``train.step_seconds`` histogram, ``sched.bytes_per_step``), so any
training loop that records them gets bucket-size tuning, with the
persistent store's warm start (``sched/store.py``)::

    tuner = ScheduleTuner(store_key=schedule.signature())
    while not tuner.converged:
        os.environ["HVD_TPU_SCHED_BUCKET_BYTES"] = str(tuner.bucket_bytes())
        tuner.begin_window()
        run_steps(window)                 # TrainStep records train.*
        tuner.end_window()

The store key's knob fingerprint folds in every ``HVD_TPU_SCHED*`` knob,
so a tuner that is to find a stored winner is made, as the one that
stored it was, before the bucket size is set in the environment.

What the score reads on a card: ``train.step_seconds`` is the host time
of each ``TrainStep`` call, as in the JAX package (whose call returns
once the step is dispatched).  A captured step's replay returns once the
graph is queued, so the score measures host dispatch, not the device's
step time; ``PERF.md`` compares the two.

In a world of several ranks every rank makes its tuner alike and closes
its windows together, and every rank follows rank 0: each window's
score is rank 0's (``utils/autotune.py`` ``world_score``), and so is the
store's entry at a warm start, so no two ranks apply different knobs.

The JAX package's rail-pipeliner dimension (``explore_pipeline``,
``HVD_TPU_XIR_PIPELINE``) has no knob in the port yet and is left out.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .. import metrics
from ..utils import env
from ..utils.autotune import FusionAutotuner, world_score


def registry_view() -> Dict[str, float]:
    """Snapshot the registry series the window score derives from."""
    hist = metrics.get_histogram("train.step_seconds")
    return {
        "steps": float(metrics.get_counter("train.steps")),
        "step_seconds_sum": float(hist["sum"]) if hist else 0.0,
        "bytes_per_step": float(
            metrics.get_gauge("sched.bytes_per_step") or 0.0
        ),
        "mono": time.monotonic(),
    }


def window_score(
    before: Dict[str, float], after: Dict[str, float]
) -> float:
    """Score one closed window from two registry snapshots.

    Primary: exchanged **bytes/sec** — steps/sec (from the
    ``train.steps`` counter over the ``train.step_seconds`` histogram
    sum, falling back to wall clock when the histogram is idle) times
    the planned ``sched.bytes_per_step`` gauge.  Without a bytes gauge
    the score degrades to plain steps/sec, which ranks candidates
    identically for a fixed model.
    """
    steps = after["steps"] - before["steps"]
    if steps <= 0:
        return 0.0
    dt = after["step_seconds_sum"] - before["step_seconds_sum"]
    if dt <= 0:
        dt = after["mono"] - before["mono"]
    rate = steps / max(dt, 1e-9)
    bytes_per_step = after["bytes_per_step"]
    return rate * bytes_per_step if bytes_per_step > 0 else rate


class ScheduleTuner:
    """FusionAutotuner wired to the scheduler's bucket-size knob with
    registry-fed window scores.

    ``explore_wire=True`` adds the quantized-wire dimension: each
    window runs under one wire candidate (``wire_candidates``, default
    off → bf16 → int8 → fp8), scored from the same registry deltas;
    once every candidate has a score the best freezes and bucket-size
    tuning proceeds under it.  Apply the suggestion per bucket with
    :meth:`wire` + :func:`~horovod_tpu.sched.plan.build_schedule`'s
    ``wire=`` argument (small buckets below ``wire_min_bucket_bytes``
    stay dense — the fp32 scale sidecar dominates tiny payloads)::

        tuner = ScheduleTuner(explore_wire=True)
        while not tuner.converged:
            cfg = dataclasses.replace(
                cfg, bucket_bytes=tuner.bucket_bytes(), wire=tuner.wire())
            tuner.begin_window(); run_steps(window); tuner.end_window()

    Scores are exchanged-bytes/sec over the *dense* byte gauge, so a
    wire that trains the same steps/sec wins only via its bucket plan —
    and a quantized wire that slows convergence shows up as fewer
    steps (the EF residual keeps trajectories close; see
    the JAX package's docs/quantization.md).

    ``store``/``store_key`` engage the persistent autotuning DB
    (``sched/store.py``): a hit freezes every knob
    before window 0 (``sched.tune.db_hit``), a miss explores as usual
    and writes the winner back on convergence
    (``sched.tune.db_store``)::

        tuner = ScheduleTuner(store="env",
                              store_key=schedule.signature())
    """

    def __init__(self, explore_wire: bool = False,
                 wire_candidates=("off", "bf16", "int8", "fp8"),
                 wire_min_bucket_bytes: int = 1 << 16,
                 explore_lowering: bool = False,
                 lowering_candidates=("flat", "hier", "hier_adasum"),
                 explore_backend: bool = False,
                 backend_candidates=("phase", "fused"),
                 explore_onestep: bool = False,
                 onestep_candidates=("off", "on", "auto"),
                 store="env",
                 store_key=None,
                 store_kind="dense_grad",
                 **tuner_kwargs):
        self.tuner = FusionAutotuner(**tuner_kwargs)
        self._baseline: Optional[Dict[str, float]] = None
        self._explore_wire = explore_wire
        self._wire_candidates = tuple(wire_candidates)
        self.wire_min_bucket_bytes = wire_min_bucket_bytes
        self._wire_scores: Dict[str, float] = {}
        self._wire_frozen: Optional[str] = None if explore_wire else "off"
        # Quantized-wire backend exploration (HVD_TPU_QUANT_BACKEND as
        # a tuned dimension): each window runs one candidate — the
        # suggestion is applied process-wide via the env knob, since
        # the backend resolves at trace time — scored from the same
        # registry deltas; the winner freezes and is pinned into the
        # environment.  "env" defers to the operator's knob (the
        # default: not a tuned dimension).
        self._explore_backend = explore_backend
        self._backend_candidates = tuple(backend_candidates)
        self._backend_scores: Dict[str, float] = {}
        self._backend_frozen: Optional[str] = (
            None if explore_backend else "env"
        )
        # Whole-step-emission exploration (HVD_TPU_ONESTEP as a tuned
        # dimension, xir/interp.py): each window runs one candidate —
        # applied process-wide through the env knob, since the fold
        # resolves at trace time — scored from the same registry
        # deltas; the winner freezes, pins the knob, and persists in
        # entry meta.onestep.  The fold is ordering-only (losses
        # bitwise-identical across candidates), so the score ranks
        # pure wall-clock: dispatch round-trips saved vs the larger
        # compiled program.
        self._explore_onestep = explore_onestep
        self._onestep_candidates = tuple(onestep_candidates)
        self._onestep_scores: Dict[str, float] = {}
        self._onestep_frozen: Optional[str] = (
            None if explore_onestep else "env"
        )
        # Lowering exploration (the HVD_TPU_TOPO_LOWER knob as a tuned
        # dimension): each window runs one candidate — including
        # hier_adasum, the adaptive cross-slice combine the cost model
        # never picks on its own — scored from the same registry
        # deltas; the winner freezes.  On a single-slice topology every
        # candidate resolves flat anyway, so exploration is skipped and
        # the knob pins to "flat" immediately.
        self._explore_lowering = explore_lowering
        self._lowering_candidates = tuple(lowering_candidates)
        self._lowering_scores: Dict[str, float] = {}
        if not explore_lowering:
            # Not a tuned dimension: defer to the cost model ("auto").
            self._lowering_frozen: Optional[str] = "auto"
        elif self._topo_multi_slice():
            self._lowering_frozen = None
        else:
            self._lowering_frozen = "flat"
        # Persistent warm start (sched/store.py): ``store_key`` is any
        # deterministic schedule identity — canonically
        # ``BucketSchedule.signature()`` — hashed together with the
        # topology, framework version, and knob fingerprint.  The default
        # ``store="env"`` resolves HVD_TPU_TUNE_DB, so persistence
        # engages for ANY tuner given a key (and stays off when the
        # env is unset — bit-identical to no store at all).
        if store == "env":
            if store_key is None:
                store = None  # keyless tuner: nothing to look up
            else:
                from .store import ScheduleStore

                store = ScheduleStore.from_env()
        self._store = store
        self._store_key: Optional[str] = None
        self._db_written = False
        self._best_score = 0.0
        if store is not None and store_key is not None:
            from .store import make_key

            # ``store_kind`` discriminates the workload in the DB key
            # (xir.KINDS): a tuner scoring a MoE program must never
            # collide with a dense-gradient schedule of equal payload
            # signature.
            self._store_key = (
                store_key if isinstance(store_key, str)
                and len(store_key) == 64
                else make_key(store_key, kind=store_kind)
            )
            entry = store.lookup(self._store_key)
            from .. import runtime

            if runtime.is_initialized() and runtime.size() > 1:
                entry = runtime.broadcast_object(entry, root_rank=0)
            if entry is not None:
                self._warm_start(entry)
            else:
                metrics.inc_counter("sched.tune.db_miss")

    def _warm_start(self, entry: Dict) -> None:
        """Adopt a stored winner: every knob freezes before the first
        window, so ``converged`` is True at window 0 and the job pays
        zero exploration windows."""
        from ..utils.logging import get_logger

        self.tuner.freeze(int(entry["bucket_bytes"]))
        wire = str(entry.get("wire", "off"))
        self._wire_frozen = (
            wire if wire in self._wire_candidates + ("off",) else "off"
        )
        lowering = str(entry.get("lowering", "auto"))
        self._lowering_frozen = (
            lowering if lowering in self._lowering_candidates + ("auto",)
            else "auto"
        )
        backend = str((entry.get("meta") or {}).get("backend", ""))
        if backend in self._backend_candidates:
            self._backend_frozen = backend
            if self._explore_backend:
                env.set_env("QUANT_BACKEND", backend)
        elif self._backend_frozen is None:
            self._backend_frozen = "env"
        onestep = str((entry.get("meta") or {}).get("onestep", ""))
        if onestep in self._onestep_candidates:
            self._onestep_frozen = onestep
            if self._explore_onestep:
                env.set_env("ONESTEP", onestep)
        elif self._onestep_frozen is None:
            self._onestep_frozen = "env"
        self._best_score = float(entry.get("score", 0.0))
        self._db_written = True  # a re-write would only echo the entry
        metrics.inc_counter("sched.tune.db_hit")
        metrics.set_gauge("sched.tune.warm_start", 1.0)
        get_logger().info(
            "schedule tuner warm start: bucket_bytes=%d wire=%s "
            "lowering=%s (stored score %.3g, %d prior hits)",
            int(entry["bucket_bytes"]), self._wire_frozen,
            self._lowering_frozen, self._best_score,
            int(entry.get("hits", 0)),
        )

    def _maybe_store(self) -> None:
        """Write the converged winner back once (miss path only)."""
        if (self._db_written or self._store is None
                or self._store_key is None or not self.converged):
            return
        self._db_written = True
        self._store.record(
            self._store_key,
            bucket_bytes=self.bucket_bytes(),
            wire=self.wire(),
            lowering=self.lowering(),
            score=self._best_score,
            meta={"backend": self.backend(),
                  "onestep": self.onestep()},
        )

    @staticmethod
    def _topo_multi_slice() -> bool:
        from ..topo import model as topo_model

        return topo_model.current().multi_slice

    def bucket_bytes(self) -> int:
        """Bucket-size suggestion for the next window (frozen winner
        after convergence)."""
        return self.tuner.threshold_bytes()

    def wire(self) -> str:
        """Wire-format suggestion for the next window: the next unscored
        candidate while exploring, the frozen winner after."""
        if self._wire_frozen is not None:
            return self._wire_frozen
        for w in self._wire_candidates:
            if w not in self._wire_scores:
                return w
        return self._wire_frozen or "off"

    def backend(self) -> str:
        """Quantized-wire backend suggestion for the next window: the
        next unscored candidate while exploring, the frozen winner
        after, or the ``HVD_TPU_QUANT_BACKEND`` env knob when the
        backend is not a tuned dimension.  Exploration applies the
        suggestion through the env knob in :meth:`begin_window` —
        the backend resolves at trace time, so the caller rebuilds its
        step per window exactly as with wire exploration."""
        if self._backend_frozen == "env":
            from ..ops.quantized import quant_backend

            return quant_backend()
        if self._backend_frozen is not None:
            return self._backend_frozen
        for b in self._backend_candidates:
            if b not in self._backend_scores:
                return b
        return "phase"

    def onestep(self) -> str:
        """Whole-step-emission mode suggestion for the next window
        (``HVD_TPU_ONESTEP``): the next unscored candidate while
        exploring, the frozen winner after, or the env knob's resolved
        mode when the fold is not a tuned dimension.  Exploration
        applies the suggestion through the env knob in
        :meth:`begin_window`; ``TrainStep`` reads it at each call, so a
        changed mode drops its captured graphs and captures anew."""
        if self._onestep_frozen == "env":
            from ..xir import interp as xir_interp

            return xir_interp.onestep_mode()
        if self._onestep_frozen is not None:
            return self._onestep_frozen
        for m in self._onestep_candidates:
            if m not in self._onestep_scores:
                return m
        return "auto"

    def lowering(self) -> str:
        """Lowering suggestion for the next window
        (``build_schedule(..., lowering=...)``): the next unscored
        candidate while exploring, the frozen winner after — "auto"
        when lowering is not an explored dimension (the cost model
        decides per bucket)."""
        if self._lowering_frozen is not None:
            return self._lowering_frozen
        for lo in self._lowering_candidates:
            if lo not in self._lowering_scores:
                return lo
        return self._lowering_frozen or "auto"

    def begin_window(self) -> None:
        # Prime the suggestion: FusionAutotuner only accepts an observe
        # for a threshold it suggested (suggest-before-observe contract).
        self.tuner.threshold_bytes()
        if self._backend_frozen is None:
            # backend candidates apply process-wide (trace-time knob)
            env.set_env("QUANT_BACKEND", self.backend())
        if self._onestep_frozen is None:
            # onestep candidates apply process-wide (trace-time knob)
            env.set_env("ONESTEP", self.onestep())
        self._baseline = registry_view()

    def end_window(self) -> float:
        """Close the window: score it from the registry deltas and feed
        the search.  While wire exploration is open the score lands on
        the current wire candidate; afterwards it feeds the bucket-size
        tuner.  Returns the score (0.0 when no window was open or no
        steps ran — not observed, so an idle window cannot poison the
        search)."""
        if self._baseline is None:
            return 0.0
        score = world_score(window_score(self._baseline, registry_view()))
        self._baseline = None
        if score <= 0.0:
            return score
        metrics.inc_counter("sched.tune_windows")
        metrics.set_gauge("sched.tune_score", score)
        self._best_score = max(self._best_score, score)
        if self._backend_frozen is None:
            b = self.backend()
            self._backend_scores[b] = max(
                self._backend_scores.get(b, 0.0), score
            )
            metrics.set_gauge(
                "sched.tune_backend_score", score, {"backend": b}
            )
            if all(c in self._backend_scores
                   for c in self._backend_candidates):
                self._backend_frozen = max(
                    self._backend_scores, key=self._backend_scores.get
                )
                env.set_env("QUANT_BACKEND", self._backend_frozen)
                metrics.set_gauge(
                    "sched.tune_backend_frozen", 1.0,
                    {"backend": self._backend_frozen},
                )
        elif self._onestep_frozen is None:
            m = self.onestep()
            self._onestep_scores[m] = max(
                self._onestep_scores.get(m, 0.0), score
            )
            metrics.set_gauge(
                "sched.tune_onestep_score", score, {"onestep": m}
            )
            if all(c in self._onestep_scores
                   for c in self._onestep_candidates):
                self._onestep_frozen = max(
                    self._onestep_scores, key=self._onestep_scores.get
                )
                env.set_env("ONESTEP", self._onestep_frozen)
                metrics.set_gauge(
                    "sched.tune_onestep_frozen", 1.0,
                    {"onestep": self._onestep_frozen},
                )
        elif self._lowering_frozen is None:
            lo = self.lowering()
            self._lowering_scores[lo] = max(
                self._lowering_scores.get(lo, 0.0), score
            )
            metrics.set_gauge(
                "sched.tune_lowering_score", score, {"lowering": lo}
            )
            if all(c in self._lowering_scores
                   for c in self._lowering_candidates):
                self._lowering_frozen = max(
                    self._lowering_scores, key=self._lowering_scores.get
                )
                metrics.set_gauge(
                    "sched.tune_lowering_frozen", 1.0,
                    {"lowering": self._lowering_frozen},
                )
        elif self._wire_frozen is None:
            w = self.wire()
            self._wire_scores[w] = max(self._wire_scores.get(w, 0.0), score)
            metrics.set_gauge(
                "sched.tune_wire_score", score, {"wire": w}
            )
            if all(c in self._wire_scores for c in self._wire_candidates):
                self._wire_frozen = max(
                    self._wire_scores, key=self._wire_scores.get
                )
                metrics.set_gauge(
                    "sched.tune_wire_frozen", 1.0,
                    {"wire": self._wire_frozen},
                )
        else:
            self.tuner.observe(score)
        self._maybe_store()
        return score

    def apply(self, schedule):
        """Stamp the current wire + lowering suggestions onto a built
        schedule, per bucket: buckets below ``wire_min_bucket_bytes``
        stay dense under a quantized suggestion (scale-sidecar overhead
        dominates tiny payloads), ineligible buckets downgrade via
        :func:`~horovod_tpu.sched.plan.eligible_wire`, and the lowering
        resolves through
        :func:`~horovod_tpu.sched.plan.resolve_lowering` (flat on a
        single-slice topology, cost-model choice under "auto")."""
        import dataclasses as _dc

        from .plan import eligible_wire, resolve_lowering

        w = self.wire()
        lo = self.lowering()
        buckets = []
        for b in schedule.buckets:
            req = w
            if w in ("int8", "fp8") and \
                    b.nbytes < self.wire_min_bucket_bytes:
                req = "off"
            buckets.append(_dc.replace(
                b,
                wire=eligible_wire(req, b.wire_dtypes),
                lowering=resolve_lowering(lo, b.nbytes,
                                          wire_dtypes=b.wire_dtypes),
            ))
        return _dc.replace(schedule, buckets=tuple(buckets))

    @property
    def converged(self) -> bool:
        return (
            self._wire_frozen is not None
            and self._lowering_frozen is not None
            and self._backend_frozen is not None
            and self._onestep_frozen is not None
            and self.tuner.converged
        )
