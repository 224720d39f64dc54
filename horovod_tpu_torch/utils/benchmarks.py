"""The canonical data-parallel training step for an image model.

Counterpart of ``horovod_tpu/utils/benchmarks.py`` (``build_dp_step``
``:15``, ``timed_throughput`` ``:70``).  A torch module carries its
weights, so the step is built around an existing model (the JAX
function initialises the flax model itself and takes the image size for
that) and returns the model and optimizer instead of parameter pytrees.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _loss_fn(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y)


def build_dp_step(hvd, model: torch.nn.Module, *, compression=None,
                  lr: float = 0.01,
                  momentum: Optional[float] = 0.9) -> Tuple:
    """Build the data-parallel step: rank 0's weights and buffers are
    broadcast, SGD (``lr``, ``momentum``; dampening 0, no Nesterov: the
    update of ``optax.sgd``) is wrapped in ``hvd.DistributedOptimizer``,
    and the step minimises the mean softmax cross-entropy.

    Returns ``(step, optimizer)``; ``step(batch)`` runs one step on this
    rank's ``(images NHWC, labels)`` and returns the loss averaged across
    ranks."""
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum or 0.0),
        named_parameters=model.named_parameters(),
        compression=compression if compression is not None
        else hvd.Compression.none,
    )
    return hvd.TrainStep(model, opt, _loss_fn), opt


def timed_throughput(step, batch, iters: int,
                     warmup: int = 3) -> Tuple[float, list]:
    """Run ``warmup`` + ``iters`` steps; return (seconds of the timed
    steps, every step's loss as a float).  A host read of the loss
    fences each phase: it waits for the step's device work."""
    losses = [float(step(batch)) for _ in range(warmup)]
    t0 = time.perf_counter()
    timed = [step(batch) for _ in range(iters)]
    if timed:
        float(timed[-1])
    seconds = time.perf_counter() - t0
    return seconds, losses + [float(t) for t in timed]
