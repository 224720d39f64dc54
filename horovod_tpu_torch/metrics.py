"""Process-local metrics registry.

Counterpart of the registry half of ``horovod_tpu/metrics.py``: counters
and last-write-wins (optionally labelled) gauges under the JAX package's
names, so parity tests can compare them.  The data-parallel step emits
``sched.buckets``, ``sched.buckets_per_step``, ``sched.bytes_per_step``,
``sched.wire_bytes{wire=}``, ``sched.wire_bytes.<wire>`` and
``sched.compression_ratio`` (``sched/execute.py``); the quantized wire
counts ``quant.fused_collectives`` and ``quant.fused_bytes``
(``ops/quantized.py``) above a world of one; each eager collective
counts ``collective.<op>.dispatches`` and ``collective.<op>.bytes``
(``ops/eager.py``).  They are recorded in
Python, so a step captured into a CUDA graph records them once, at
capture, as the JAX package records them once per trace; its replays
record nothing.  ``TrainStep`` publishes ``sched.onestep.engaged{mode=}``
(1 when the call ran the captured step) and counts
``xir.onestep.steps`` once per capture.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
_counters: Dict[str, int] = {}
_gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}


def inc_counter(name: str, value: int = 1) -> int:
    """Bump a named counter; returns the new value."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value
        return _counters[name]


def get_counter(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


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


def reset(prefix: str = "") -> None:
    """Clear counters and gauges whose names start with ``prefix``."""
    with _lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]
        for k in [k for k in _gauges if k[0].startswith(prefix)]:
            del _gauges[k]
