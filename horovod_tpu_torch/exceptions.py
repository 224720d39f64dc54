"""Framework exceptions.

Counterpart of ``horovod_tpu/exceptions.py``, trimmed to what the
data-parallel step raises.
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

