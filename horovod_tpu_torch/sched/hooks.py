"""Observe the backward readiness order of parameters.

Counterpart of ``horovod_tpu/sched/hooks.py`` (``:38-121``).  The JAX
package taps each parameter's cotangent while the backward is traced;
PyTorch runs the backward eagerly, so each parameter gets a
``register_post_accumulate_grad_hook`` that records its index the moment
its gradient has been accumulated: the reference's runtime readiness
order (``horovod/torch/optimizer.py``).

Ranks may see different orders (autograd runs independent branches in
no fixed order), so the plan takes rank 0's order, broadcast to every
rank (``optim/distributed_optimizer.py``).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import torch


class GradOrder:
    """Records, per backward pass, the order in which the gradients of
    ``params`` become ready."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self._n = len(params)
        self._seen: List[int] = []
        for i, p in enumerate(params):
            p.register_post_accumulate_grad_hook(partial(self._ready, i))

    def _ready(self, idx: int, _param: torch.Tensor) -> None:
        self._seen.append(idx)

    def consume(self) -> Optional[List[int]]:
        """The order observed since the last call (first = first ready),
        or ``None`` when some parameter's gradient never arrived."""
        order = list(dict.fromkeys(self._seen))
        self._seen = []
        return order if len(order) == self._n else None
