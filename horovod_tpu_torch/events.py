"""Structured JSONL elastic event log.

Copy of ``horovod_tpu/events.py`` (``EventLog``, ``emit``,
``read_events``, ``ELASTIC_EVENT_LOG``): every lifecycle transition of an
elastic run (discovery change, blacklist, round start/end, worker crash
or hang, watchdog timeout, checkpoint fallback, remesh phases) as one
JSON object per line, appended to the file named by
``HVD_TPU_ELASTIC_EVENT_LOG`` (``HOROVOD_`` prefix accepted).

Each event carries both clocks, ``wall_ts`` (``time.time()``, merges
across processes and hosts) and ``mono_ts`` (``time.monotonic()``,
orders events within a process), plus ``pid``/``hostname``/``rank``
provenance, so a fault-injection run (``HVD_TPU_FAULT_PLAN``,
``faults.py``) leaves a replayable record: ``read_events(path)``
returns the sequence in order.  Writes are single ``write()`` calls on
an append-mode handle, so several processes may share one log path.

Nothing in the port emits an event yet: the emitters are the elastic
driver and workers, the checkpoint writer and the remesh, which the port
does not have yet.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from .utils import env as hvd_env
from .utils.logging import get_logger

# Known event names (the schema's ``event`` field; emitters may add
# more — the registry is open like the fault-injection sites).
DISCOVERY_CHANGE = "discovery_change"
BLACKLIST = "blacklist"
UNBLACKLIST = "unblacklist"
ROUND_START = "round_start"
ROUND_END = "round_end"
RESTART = "restart"
WORKER_CRASH = "worker_crash"
WORKER_HANG = "worker_hang"
WATCHDOG_TIMEOUT = "watchdog_timeout"
SPAWN_FAILED = "spawn_failed"
CHECKPOINT_CORRUPT = "checkpoint_corrupt"
CHECKPOINT_FALLBACK = "checkpoint_fallback"
# In-process remesh lifecycle (elastic/remesh.py): a remesh attempt
# emits START, one PHASE entry per pipeline phase (pause/snapshot/
# publish/barrier/reinit/fetch/rebuild), then OK — or FALLBACK with the
# failing phase when it degrades to the checkpoint-restore restart
# path, or ABORT when the driver cancels the attempt.
REMESH_START = "remesh_start"
REMESH_PHASE = "remesh_phase"
REMESH_OK = "remesh_ok"
REMESH_FALLBACK = "remesh_fallback"
REMESH_ABORT = "remesh_abort"
# Exchange tracing (trace/): the flight recorder dumped its ring
# (reason = slow_step / fault:<site> / remesh / svc_death), and the
# async service's negotiation stall check named missing participants.
TRACE_ANOMALY = "trace_anomaly"
SVC_STALL = "svc_stall"
# Stall escalation (svc/negotiate.py): after HVD_TPU_STALL_ABANDON
# consecutive stalled check intervals the entry is abandoned and every
# posted participant's future resolves inline.
SVC_STALL_ABANDON = "svc_stall_abandon"
# Arbiter admission telemetry (svc/arbiter.py): an admission wait
# expired (the submission was admitted anyway — backpressure never
# wedges), and a preemption gate lifted (reason = expired | drained) —
# the event-log entries the /slo remediation history attributes rung
# (a) actions against.
SVC_ADMIT_TIMEOUT = "svc_admit_timeout"
SVC_PREEMPT_EXPIRED = "svc_preempt_expired"
# SLO watchdog (runner/slo.py): a tenant's target stayed breached for
# HVD_TPU_SLO_WINDOWS consecutive evaluation windows (BREACH), or a
# confirmed breach's metric went green again (RECOVERED).
SLO_BREACH = "slo_breach"
SLO_RECOVERED = "slo_recovered"
# Remediation lifecycle (elastic/remediate.py): an escalation-ladder
# action emits START, one PHASE entry per executed phase (plan /
# preempt / degrade / handoff / rollback), then OK — or ABORT with
# ``stable`` telling whether the rollback restored the pre-handoff
# placement (stable=False escalates to the respawn path).
REMEDIATE_START = "remediate_start"
REMEDIATE_PHASE = "remediate_phase"
REMEDIATE_OK = "remediate_ok"
REMEDIATE_ABORT = "remediate_abort"
# SLO recovery re-armed a tenant's ladder and restored the env knobs
# its degrade rung(s) had flipped (Remediator.reset).
REMEDIATE_REVERT = "remediate_revert"
# Perf-regression sentinel (prof/baseline.py): observed step p50 or
# MFU degraded past HVD_TPU_PROF_REGRESS_FACTOR against the persisted
# baseline for this (workload signature, topology, knob fingerprint).
PROF_REGRESSION = "prof_regression"


class EventLog:
    """Append-only JSONL writer; one line per event, flushed per line
    so a crashed process never leaves a torn tail beyond its last
    complete event."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)
        self._hostname = socket.gethostname()
        self._seq = 0

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        record = {
            "event": event,
            "wall_ts": time.time(),
            "mono_ts": time.monotonic(),
            "pid": os.getpid(),
            "hostname": self._hostname,
            "rank": int(os.environ.get("HVD_TPU_CROSS_RANK", -1)),
        }
        record.update(fields)
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            try:
                self._fh.write(json.dumps(record, default=str) + "\n")
            except ValueError:
                pass  # closed under us during interpreter teardown
        return record

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except Exception:
                pass


_active: Optional[EventLog] = None
_active_loaded = False
_lock = threading.Lock()

ELASTIC_EVENT_LOG = "ELASTIC_EVENT_LOG"


def get_event_log() -> Optional[EventLog]:
    """The process-wide log: installed via :func:`set_event_log`, else
    opened once from ``HVD_TPU_ELASTIC_EVENT_LOG``.  None (the default)
    makes :func:`emit` a no-op."""
    global _active, _active_loaded
    with _lock:
        if not _active_loaded:
            path = hvd_env.get_env(ELASTIC_EVENT_LOG)
            if path:
                try:
                    _active = EventLog(path)
                except OSError as e:
                    get_logger().warning(
                        "cannot open elastic event log %s: %s", path, e
                    )
                    _active = None
            _active_loaded = True
        return _active


def set_event_log(log: Optional[EventLog]) -> Optional[EventLog]:
    """Install (or, with None, disable) the process-wide log — tests
    use this instead of mutating the environment."""
    global _active, _active_loaded
    with _lock:
        if _active is not None and _active is not log:
            _active.close()
        _active = log
        _active_loaded = True
        return _active


def reset() -> None:
    """Forget the installed log; the next :func:`emit` re-reads the
    environment."""
    global _active, _active_loaded
    with _lock:
        if _active is not None:
            _active.close()
        _active = None
        _active_loaded = False


def emit(event: str, **fields: Any) -> None:
    """Emit one structured event to the active log (no-op when no log
    is configured).  Never raises — observability must not take down
    the path it observes."""
    log = get_event_log()
    if log is None:
        return
    try:
        log.emit(event, **fields)
    except Exception as e:  # pragma: no cover - defensive
        get_logger().warning("elastic event emit failed: %s", e)


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL event log back into a list of event dicts,
    skipping any torn final line (a crashed writer's last partial
    write) — the postmortem reader."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
