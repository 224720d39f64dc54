"""Bucketed gradient-exchange scheduler: plan, readiness hooks, execute,
and the bucketed ZeRO-1 step (``zero1.py``: ``bucketed_zero_step``,
``bucket_layouts``)."""

_ZERO1 = ("bucketed_zero_step", "bucket_layouts")


def __getattr__(name):
    # zero1.py builds on optim/distributed_optimizer.py, which imports this
    # package's execute and plan: loaded at first use, after both.
    if name in _ZERO1:
        from . import zero1

        return getattr(zero1, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
