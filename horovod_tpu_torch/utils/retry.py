"""Reusable retry policy: bounded attempts, exponential backoff with
deterministic jitter, optional per-attempt timeout.

The reference scatters ad-hoc retry loops through its runner (ssh
probes, rendezvous polls, discovery hiccups swallowed by the driver
loop).  Centralizing the policy buys three things the fault-tolerance
path needs: (1) every retry is counted in :mod:`horovod_tpu_torch.metrics`
(``retry.<name>.attempts`` / ``.retries`` / ``.exhausted``) so flaky
infrastructure is visible, not silent; (2) jitter is drawn from a
seedable RNG so tests assert exact backoff sequences; (3) a per-attempt
timeout turns a *hung* call (the failure mode heartbeats exist for)
into a retryable error instead of a wedged driver.

Copy of ``horovod_tpu/utils/retry.py``.  Its users in the JAX package
(elastic discovery, the elastic driver's worker spawn and the worker's
rendezvous connect) have no port yet.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, Type

from ..exceptions import RetryTimeoutError


def _run_with_timeout(fn: Callable, args, kwargs, timeout_s: float):
    """Run ``fn`` in a daemon thread with a deadline.  On timeout the
    thread is abandoned (Python offers no safe kill) and
    :class:`RetryTimeoutError` is raised — callers pick attempt timeouts
    long enough that an abandoned attempt is rare and harmless
    (subprocess-backed work is additionally bounded by its own timeout).
    """
    result: list = []
    error: list = []

    def runner():
        try:
            result.append(fn(*args, **kwargs))
        except BaseException as e:  # delivered to the waiting caller
            error.append(e)

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise RetryTimeoutError(
            f"attempt exceeded per-attempt timeout of {timeout_s}s"
        )
    if error:
        raise error[0]
    return result[0]


@dataclass
class RetryPolicy:
    """``call(fn, ...)`` runs ``fn`` up to ``max_attempts`` times.

    Delay before retry K (1-based) is
    ``min(base_delay_s * multiplier**(K-1), max_delay_s)`` scaled by a
    jitter factor uniform in ``[1 - jitter, 1 + jitter]`` from the
    seeded RNG.  ``retry_on`` bounds which exceptions are retryable
    (others propagate immediately); :class:`RetryTimeoutError` from
    ``attempt_timeout_s`` is always retryable.  After the last attempt
    the final exception propagates unchanged.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    jitter: float = 0.1
    attempt_timeout_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None
    name: str = "retry"
    seed: Optional[int] = None
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self._rng = random.Random(self.seed)

    def delay_s(self, retry_index: int) -> float:
        """Backoff before the ``retry_index``-th retry (1-based), jitter
        included.  Consumes one RNG draw — with a fixed ``seed`` the
        sequence of delays is reproducible."""
        base = min(
            self.base_delay_s * (self.multiplier ** (retry_index - 1)),
            self.max_delay_s,
        )
        if self.jitter <= 0:
            return base
        return base * self._rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)

    def call(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        from .. import metrics

        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            metrics.inc_counter(f"retry.{self.name}.attempts")
            t0 = time.perf_counter()
            try:
                if self.attempt_timeout_s is not None:
                    result = _run_with_timeout(
                        fn, args, kwargs, self.attempt_timeout_s
                    )
                else:
                    result = fn(*args, **kwargs)
                metrics.observe(
                    f"retry.{self.name}.attempt_seconds",
                    time.perf_counter() - t0,
                )
                return result
            except self.retry_on + (RetryTimeoutError,) as e:
                metrics.observe(
                    f"retry.{self.name}.attempt_seconds",
                    time.perf_counter() - t0,
                )
                last = e
                if attempt == self.max_attempts:
                    break
                delay = self.delay_s(attempt)
                metrics.inc_counter(f"retry.{self.name}.retries")
                if self.on_retry is not None:
                    self.on_retry(attempt, e, delay)
                from .logging import get_logger

                get_logger().warning(
                    "%s: attempt %d/%d failed (%s); retrying in %.2fs",
                    self.name, attempt, self.max_attempts, e, delay,
                )
                if delay > 0:
                    self.sleep(delay)
        metrics.inc_counter(f"retry.{self.name}.exhausted")
        assert last is not None
        raise last

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form of :meth:`call`."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped
