"""Distributed optimizer and train step; the delta-Adasum optimizer
(``adasum_optimizer.py``); ZeRO-1 and FSDP (``zero.py``)."""

from .zero import (  # noqa: F401
    ShardedOptimizer,
    clip_by_global_norm,
    fsdp_train_step,
    global_norm,
    zero_train_step,
)
