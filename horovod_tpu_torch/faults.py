"""Deterministic, seed-driven fault injection.

The reference Horovod proves its elastic path with scripted failures in
``test/integration/elastic_common.py`` (discovery scripts that change
output over time, workers told to exit by epoch).  That works for
integration tests but leaves the *production* code paths untestable
without monkeypatching: there is no way to make the real discovery
call, the real spawn path, or the real checkpoint writer fail on
demand.  This module closes that gap with named in-code injection
sites that are inert by default and scriptable from the environment —
the same plan syntax drives unit tests, the elastic integration suite,
and ad-hoc "game day" runs of a real job.

Plan syntax (``HVD_TPU_FAULT_PLAN``)::

    [seed=N;]site:kind[:key=val[,key=val...]][;site:kind[:...]]...

Each entry names an injection *site* (a dotted string the code passes
to :func:`inject`), a fault *kind*, and optional selectors/arguments:

``kind``
    ``error``/``flake``  raise :class:`FaultInjected` (``msg=...``)
    ``crash``            ``os._exit(code)`` (default 1) — a hard worker
                         death, skipping atexit like a real SIGKILL
    ``hang``             sleep ``secs`` (default 3600) — a wedged
                         thread, distinguishable from a crash only by
                         heartbeat
    ``slow``             sleep ``secs`` (default 1.0) then continue —
                         a straggler host
    ``corrupt``          return ``True`` from :func:`inject`; the call
                         site cooperates (e.g. ``checkpoint.py``
                         flips bytes after writing)
    ``kill_at_step``     sugar for ``crash`` pinned to one training
                         step: requires ``step=K`` and fires exactly
                         when a site's ``step`` context equals K
                         (``worker.commit`` is the per-step-boundary
                         site) — the deterministic worker kill of the
                         kill-and-resize remesh tests
    ``resize_to``        cooperative (like ``corrupt``): requires
                         ``np=N``; :func:`inject` returns
                         ``{"np": N}`` and the call site resizes the
                         world (``discovery.resize`` in
                         ``elastic/discovery.py`` rescales the
                         discovered slot total) — a scripted,
                         seed-reproducible membership change

selectors
    ``nth=K``     fire on the K-th matching arrival only (1-based)
    ``times=M``   fire on M consecutive matching arrivals (default 1;
                  combined with ``nth``, fires on arrivals K..K+M-1;
                  ``times=0`` means every arrival)
    ``p=0.X``     fire with probability X per matching arrival, drawn
                  from the plan-seeded RNG — deterministic for a given
                  (seed, arrival sequence)
    anything else is matched against the keyword context the call site
    passes to :func:`inject` (``rank=1``, ``round=2``, ``host=10.0.0.3``
    ...); an entry only counts arrivals whose context matches.

Example — one discovery flake, then a crash of rank 1 in round 2::

    HVD_TPU_FAULT_PLAN='discovery.script:error:nth=1;worker.step:crash:rank=1,round=2,code=7'

Registered sites (grep ``faults.inject`` for ground truth):

==============================  ==========================================
``discovery.script``            before each discovery-script execution
``discovery.resize``            after each discovery poll (``resize_to``
                                rescales the discovered slot total)
``driver.spawn``                before each worker spawn (host/rank/round)
``worker.connect``              before the worker dials the rendezvous KV
``worker.heartbeat``            each worker heartbeat tick (rank/round)
``worker.commit``               each elastic-state commit (``step=`` is
                                the per-state commit counter — the
                                ``kill_at_step`` anchor)
``checkpoint.write``            after checkpoint bytes hit disk (corrupt)
``remesh.<phase>``              each remesh pipeline phase (pause/
                                snapshot/publish/barrier/reinit/fetch/
                                rebuild — fail any phase on demand)
``remesh.publish``              additionally honors ``corrupt``: the
                                published shard blob is damaged so the
                                receiver's checksum MUST catch it
``svc.submit``                  each exchange-service submission (host
                                and traced producers; ``producer=``,
                                ``kind=`` context) — an ``error`` kills
                                the service and the submission degrades
                                to synchronous inline dispatch
                                (``svc.fallback_sync``)
``svc.admit``                   each tenant-lane admission
                                (``tenant=`` context; svc/arbiter.py)
                                — an ``error`` kills the service
                                before the slot is taken, degrading
                                the submission to inline dispatch
``svc.drain``                   each service drain (remesh pause,
                                elastic restart, shutdown)
``svc.loop``                    each background-loop cycle tick
                                (``cycle=`` context) — kill the service
                                mid-flight between submissions
``topo.dcn_phase``              inside each cross-slice DCN hop's trace
                                span (``phase=``/``wire=`` context;
                                host-side, fires at trace time) — a
                                ``slow`` kind is the scripted straggler
                                the trace smoke injects: the delay lands
                                in that rank's DCN rail span and the
                                driver's ``/trace`` summary names it
``remediate.plan``              while an SLO remediation plans its
                                action (``tenant=``/``rung=`` context;
                                elastic/remediate.py) — a failure here
                                aborts before anything changed
``remediate.handoff``           inside the slice-handoff execution
                                (shrink donor / reshard / grow
                                recipient) — any fault mid-handoff
                                rolls back to the pre-handoff placement
``remediate.rollback``          inside that rollback itself — a fault
                                here leaves the placement UNSTABLE and
                                the abort record says so (the caller
                                escalates to the respawn path)
==============================  ==========================================

Worker scripts may add their own sites (``faults.inject("my.site")``)
— the registry is open.  Every fired fault increments the
``faults.injected.<site>.<kind>`` counter in :mod:`horovod_tpu_torch.metrics`.

Copy of ``horovod_tpu/faults.py``.  The port's registered site is
``topo.dcn_phase`` (``topo/hierarchical.py``, every cross-domain hop,
with ``phase=``, ``wire=`` and ``rank=`` context; the JAX site passes no
``rank``, which only adds a selector a plan may use).  It fires on the
host, so a fault cannot be recorded into a CUDA graph: while a plan arms
a site of the step's path (:data:`STEP_SITES`), ``TrainStep`` does not
capture (``optim/distributed_optimizer.py`` ``capture_blocker``).  The
JAX package also dumps its flight recorder when a fault fires
(``trace.on_fault``); the port has no tracer yet, so nothing is dumped.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from .exceptions import FaultInjected
from .utils.logging import get_logger

ENV_VAR = "HVD_TPU_FAULT_PLAN"

# The sites on the data-parallel step's path: a plan that arms one keeps
# the step from being captured into a CUDA graph.
STEP_SITES = ("topo.dcn_phase",)

KINDS = ("error", "flake", "crash", "hang", "slow", "corrupt",
         "kill_at_step", "resize_to")

# Selector/argument keys that are NOT matched against inject() context.
_RESERVED = {"nth", "times", "p", "code", "secs", "msg", "np"}


def _parse_scalar(val: str) -> Any:
    """Plan values compare against context values; normalize numerics so
    ``rank=1`` matches ``inject(..., rank=1)``."""
    try:
        return int(val)
    except ValueError:
        pass
    try:
        return float(val)
    except ValueError:
        pass
    return val


class FaultSpec:
    """One plan entry: a (site, kind) with selectors and its own
    deterministic arrival counter."""

    def __init__(self, site: str, kind: str, args: Dict[str, Any]):
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (one of {KINDS})"
            )
        self.site = site
        self.kind = "error" if kind == "flake" else kind
        self.np = int(args.pop("np", 0))            # resize_to target
        if self.kind == "resize_to" and self.np < 1:
            raise ValueError(
                "resize_to requires np=N (the target world size)"
            )
        if self.kind == "kill_at_step":
            # Sugar: a crash pinned to one step-counter value — the
            # seed-reproducible worker kill of remesh tests.  The step
            # selector matches the site's step= context
            # (State.commit's per-step arrival counter).
            if "step" not in args:
                raise ValueError(
                    "kill_at_step requires step=K (the commit counter "
                    "value to die at)"
                )
            self.kind = "crash"
        self.nth = int(args.pop("nth", 0))          # 0 = any arrival
        self.times = int(args.pop("times", 1))      # 0 = unbounded
        self.prob = float(args.pop("p", 1.0))
        self.code = int(args.pop("code", 1))
        self.secs = float(args.pop("secs", 3600.0 if self.kind == "hang"
                                   else 1.0))
        self.msg = str(args.pop("msg", ""))
        self.match = dict(args)                     # context selectors
        self.arrivals = 0                           # matching arrivals
        self.fired = 0

    def _context_matches(self, context: Dict[str, Any]) -> bool:
        for k, want in self.match.items():
            got = context.get(k)
            if got is None:
                return False
            if isinstance(want, (int, float)) and not isinstance(got, str):
                try:
                    if float(got) != float(want):
                        return False
                    continue
                except (TypeError, ValueError):
                    return False
            if str(got) != str(want):
                return False
        return True

    def should_fire(self, context: Dict[str, Any], rng: random.Random) -> bool:
        """Deterministic: counters advance only on matching arrivals, and
        the probabilistic draw comes from the plan's seeded RNG."""
        if not self._context_matches(context):
            return False
        self.arrivals += 1
        if self.nth:
            lo, hi = self.nth, (
                float("inf") if self.times == 0 else self.nth + self.times - 1
            )
            if not (lo <= self.arrivals <= hi):
                return False
        elif self.times and self.fired >= self.times:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            return False
        self.fired += 1
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        sel = {"nth": self.nth, "times": self.times, "p": self.prob,
               **self.match}
        return f"FaultSpec({self.site}:{self.kind}:{sel})"


class FaultPlan:
    """A parsed ``HVD_TPU_FAULT_PLAN``: specs grouped by site, one seeded
    RNG shared by all probabilistic entries, thread-safe counters."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self._by_site.setdefault(s.site, []).append(s)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed = 0
        specs: List[FaultSpec] = []
        for raw in spec.split(";"):
            entry = raw.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                seed = int(entry[5:])
                continue
            parts = entry.split(":", 2)
            if len(parts) < 2:
                raise ValueError(
                    f"malformed fault entry {entry!r}: want "
                    "'site:kind[:key=val,...]'"
                )
            site, kind = parts[0].strip(), parts[1].strip()
            args: Dict[str, Any] = {}
            if len(parts) == 3 and parts[2].strip():
                for kv in parts[2].split(","):
                    if "=" not in kv:
                        raise ValueError(
                            f"malformed fault arg {kv!r} in {entry!r}"
                        )
                    k, v = kv.split("=", 1)
                    args[k.strip()] = _parse_scalar(v.strip())
            specs.append(FaultSpec(site, kind, args))
        return cls(specs, seed=seed)

    def sites(self) -> List[str]:
        return sorted(self._by_site)

    def arms_step(self) -> bool:
        """Whether an entry of the plan sits on the step's path
        (:data:`STEP_SITES`)."""
        return any(s in self._by_site for s in STEP_SITES)

    def arm(self, site: str, context: Dict[str, Any]) -> Optional[FaultSpec]:
        """The first spec at ``site`` that fires for this arrival."""
        specs = self._by_site.get(site)
        if not specs:
            return None
        with self._lock:
            for s in specs:
                if s.should_fire(context, self._rng):
                    return s
        return None

    def counters(self) -> Dict[str, int]:
        """Per-entry fired counts (``site:kind`` -> fired) for tests."""
        with self._lock:
            out: Dict[str, int] = {}
            for site, specs in self._by_site.items():
                for s in specs:
                    key = f"{site}:{s.kind}"
                    out[key] = out.get(key, 0) + s.fired
            return out


_active: Optional[FaultPlan] = None
_active_loaded = False
_active_lock = threading.Lock()


def get_plan() -> Optional[FaultPlan]:
    """The process-wide plan: set via :func:`set_plan`, else parsed once
    from ``HVD_TPU_FAULT_PLAN``.  None (the default) disables every
    injection site at the cost of one dict lookup."""
    global _active, _active_loaded
    with _active_lock:
        if not _active_loaded:
            spec = os.environ.get(ENV_VAR, "")
            _active = FaultPlan.parse(spec) if spec.strip() else None
            _active_loaded = True
        return _active


def set_plan(plan: Optional[Any]) -> Optional[FaultPlan]:
    """Install a plan (a :class:`FaultPlan`, a spec string, or None to
    disarm).  Returns the installed plan.  Tests use this instead of
    mutating the environment."""
    global _active, _active_loaded
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan) if plan.strip() else None
    with _active_lock:
        _active = plan
        _active_loaded = True
        return _active


def reset() -> None:
    """Forget the installed plan; the next :func:`inject` re-reads the
    environment."""
    global _active, _active_loaded
    with _active_lock:
        _active = None
        _active_loaded = False


def inject(site: str, **context: Any):
    """Fault-injection call site.  Inert (returns False) without a
    matching armed fault.  ``error`` raises :class:`FaultInjected`;
    ``crash`` (and its ``kill_at_step`` sugar) hard-exits the process;
    ``hang``/``slow`` sleep; ``corrupt`` returns True so the caller
    corrupts its own output; ``resize_to`` returns ``{"np": N}`` so
    the caller resizes the world.
    """
    plan = get_plan()
    if plan is None:
        return False
    spec = plan.arm(site, context)
    if spec is None:
        return False
    from . import metrics

    metrics.inc_counter(f"faults.injected.{site}.{spec.kind}")
    log = get_logger()
    if spec.kind == "error":
        log.warning("fault injection: error at %s %s", site, context)
        raise FaultInjected(site, spec.msg)
    if spec.kind == "crash":
        log.warning("fault injection: crash(%d) at %s %s",
                    spec.code, site, context)
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(spec.code)
    if spec.kind in ("hang", "slow"):
        log.warning("fault injection: %s(%.1fs) at %s %s",
                    spec.kind, spec.secs, site, context)
        time.sleep(spec.secs)
        return False
    if spec.kind == "resize_to":
        # cooperative: the call site resizes the world to spec.np
        log.warning("fault injection: resize_to(np=%d) at %s %s",
                    spec.np, site, context)
        return {"np": spec.np}
    # corrupt: cooperate with the caller
    log.warning("fault injection: corrupt at %s %s", site, context)
    return True
