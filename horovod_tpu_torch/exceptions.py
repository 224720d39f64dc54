"""Framework exceptions.

Counterpart of ``horovod_tpu/exceptions.py``, trimmed to what the
data-parallel step, the quantized wire, fault injection
(``faults.py``) and the retry policy (``utils/retry.py``) raise.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class NotInitializedError(HorovodTpuError):
    """Raised when the API is used before ``init()`` was called."""

    def __init__(self, name: str = "horovod_tpu_torch"):
        super().__init__(
            f"{name} has not been initialized; call "
            "horovod_tpu_torch.init() first."
        )


class QuantizedWireError(HorovodTpuError, ValueError):
    """The quantized wire cannot serve this reduction (an op other than
    Sum/Average, a process set that does not tile the world, or sparse
    gradients).  Subclasses ``ValueError``, as in the JAX package."""


class ProcessSetTilingError(QuantizedWireError):
    """A rank subset cannot tile the world into equal-size groups: the
    quantized wire's groups (``ops/quantized.py``) and
    ``process_sets.tiling_groups`` raise it.  Structured fields:
    ``ranks`` (the subset), ``world_size``, ``context`` (what needed the
    tiling).  The message is the JAX package's (``exceptions.py:121``),
    whose groups are XLA replica groups; here they are
    ``torch.distributed`` groups, with the same rule."""

    def __init__(self, ranks, world_size: int, context: str = ""):
        self.ranks = tuple(int(r) for r in ranks)
        self.world_size = int(world_size)
        self.context = context
        where = f" ({context})" if context else ""
        super().__init__(
            f"ranks {list(self.ranks)} do not tile the axis of size "
            f"{self.world_size} into equal replica groups{where}; XLA "
            "replica_groups require an equal-size partition — use the "
            "dense/masked path for arbitrary subsets"
        )


class FaultInjected(HorovodTpuError):
    """Raised by ``faults.inject`` when an ``error``/``flake`` fault
    fires at a call site: the scripted stand-in for a transient
    infrastructure failure (``horovod_tpu/exceptions.py:72``)."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site!r}")
        self.site = site


class RetryTimeoutError(HorovodTpuError):
    """A single attempt under ``utils.retry.RetryPolicy`` exceeded its
    per-attempt timeout (the attempt may still be running in its worker
    thread; the policy moves on and retries)."""
