"""Observe the backward readiness order of parameters, and launch each
bucket of a schedule as soon as its gradients are ready.

Counterpart of ``horovod_tpu/sched/hooks.py`` (``:38-121``) and of the
ordering half of ``horovod_tpu/sched/execute.py`` ``_chain`` (``:40-46``).
The JAX package taps each parameter's cotangent while the backward is
traced; PyTorch runs the backward eagerly, so each parameter gets a
``register_post_accumulate_grad_hook`` that records its index the moment
its gradient has been accumulated: the reference's runtime readiness
order (``horovod/torch/optimizer.py``).

Ranks may see different orders (autograd runs independent branches in
no fixed order), so the plan takes rank 0's order, broadcast to every
rank (``optim/distributed_optimizer.py``).  For the same reason a
:class:`ScheduleLauncher` launches buckets in schedule order only: a
bucket goes when every member's gradient is ready and every earlier
bucket of the schedule has gone, so every rank issues the same
collectives in the same order, as the JAX package's optimization
barriers make XLA do.

Both keep Python state only and read no tensor: in a step captured as a
CUDA graph (``TrainStep``) they fire at the capture alone, and what they
launch is recorded into the graph.  The host collectives of an exchange
(the plan's broadcast, the ring's window) refuse to run under a capture
(``runtime.refuse_in_capture``); the eager steps before it make them.
"""

from __future__ import annotations

import weakref
from functools import partial
from typing import Callable, List, Optional, Sequence

import torch


class GradOrder:
    """Records, per backward pass, the order in which the gradients of
    ``params`` become ready, and passes each ready index to ``on_ready``
    (a bound method, held weakly, so the hooks keep no optimizer
    alive).  Hooks run on the autograd engine's thread."""

    def __init__(self, params: Sequence[torch.Tensor],
                 on_ready: Optional[Callable[[int], None]] = None):
        self._n = len(params)
        self._seen: List[int] = []
        self._on_ready = None if on_ready is None else weakref.WeakMethod(on_ready)
        for i, p in enumerate(params):
            p.register_post_accumulate_grad_hook(partial(self._ready, i))

    def _ready(self, idx: int, _param: torch.Tensor) -> None:
        self._seen.append(idx)
        if self._on_ready is not None:
            listener = self._on_ready()
            if listener is not None:
                listener(idx)

    def consume(self) -> Optional[List[int]]:
        """The order observed since the last call (first = first ready),
        or ``None`` when some parameter's gradient never arrived."""
        order = list(dict.fromkeys(self._seen))
        self._seen = []
        return order if len(order) == self._n else None


class ScheduleLauncher:
    """Launches the buckets of a schedule in schedule order.

    ``ready(i)`` marks leaf ``i``'s gradient ready; every bucket whose
    members are all ready, and whose predecessors in the schedule have
    all launched, is passed to ``launch(position, from_hook=True)`` at
    once.  A bucket complete early waits for the earlier ones.
    ``flush()`` launches the rest in order (``from_hook=False``):
    buckets whose hooks never fired."""

    def __init__(self, buckets: Sequence, launch: Callable[[int, bool], None]):
        self._launch = launch
        self._missing = [set(b.indices) for b in buckets]
        self._bucket_of = {i: k for k, b in enumerate(buckets) for i in b.indices}
        self._next = 0

    def ready(self, idx: int) -> None:
        k = self._bucket_of.get(idx)
        if k is not None:
            self._missing[k].discard(idx)
            self._advance(lambda k: not self._missing[k], True)

    def flush(self) -> None:
        self._advance(lambda k: True, False)

    def _advance(self, go, from_hook: bool) -> None:
        while self._next < len(self._missing) and go(self._next):
            k = self._next
            self._next += 1  # before the launch: a raise leaves it spent
            self._launch(k, from_hook)
