"""Delta-Adasum optimizer (reference ``_DistributedAdasumOptimizer``,
``horovod/torch/optimizer.py:335-503``).

Counterpart of ``horovod_tpu/optim/adasum_optimizer.py``
(``DistributedAdasumOptimizer`` ``:35``).  Where
``DistributedOptimizer(op=Adasum)`` combines *gradients* adaptively, this
one applies the wrapped optimizer *locally* first and combines the
resulting parameter *deltas*, which keeps Adasum's scale invariance
through optimizers with per-parameter state (Adam and the like), as the
Adasum paper (arXiv:2006.02924) recommends.

``step()`` keeps each parameter's value, runs the wrapped optimizer on
this rank's gradients, takes the delta, reduces the deltas through the
``DistributedOptimizer`` bucket machinery with ``op=Adasum`` and the
lowering pinned to ``hier_adasum`` (a sum inside each NVLink domain,
Adasum across domains; on one domain the flat tree), and writes back
value + combined delta.  A quantized ``compression`` compresses just
the cross-domain hop, where ``hier_adasum`` serves.  The deltas ride
``p.grad`` through the exchange, so after ``step()`` ``p.grad`` holds
the combined delta until ``zero_grad()``.  The exchange runs after the
local update, never from the backward.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from ..compression import Compression, Compressor
from ..ops.collectives import Adasum
from ..process_sets import ProcessSet
from .distributed_optimizer import _DistributedOptimizer


class _DistributedAdasumOptimizer(_DistributedOptimizer):
    """See :func:`DistributedAdasumOptimizer`."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
                 *, compression: type[Compressor] = Compression.none,
                 process_set: Optional[ProcessSet] = None,
                 fusion_threshold_bytes: Optional[int] = None):
        super().__init__(optimizer, named_parameters, op=Adasum,
                         compression=compression, process_set=process_set,
                         fusion_threshold_bytes=fusion_threshold_bytes,
                         lowering="hier_adasum")

    def synchronize(self) -> None:
        super().synchronize()
        self._overlap_plan = None  # the deltas exist only after the update

    def step(self, closure=None):
        self._calls += 1
        with torch.no_grad():
            start = [p.detach().clone() for p in self._params]
        loss = self._opt.step(closure)
        with torch.no_grad():
            for p, s in zip(self._params, start):
                p.grad = p.detach() - s
                p.copy_(s)
        self.synchronize()
        self._synchronized = False
        with torch.no_grad():
            torch._foreach_add_(self._params, [p.grad for p in self._params])
        return loss


def DistributedAdasumOptimizer(
    optimizer: torch.optim.Optimizer,
    named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
    **kwargs,
):
    """Wrap ``optimizer``: local update, then Adasum of the parameter
    deltas across ranks (keyword arguments: ``compression``,
    ``process_set``, ``fusion_threshold_bytes``).  The returned object
    IS-A ``type(optimizer)``, as ``DistributedOptimizer``'s is."""
    cls = type(
        "DistributedAdasum" + type(optimizer).__name__,
        (_DistributedAdasumOptimizer, type(optimizer)),
        {},
    )
    obj = cls.__new__(cls)
    _DistributedAdasumOptimizer.__init__(obj, optimizer, named_parameters, **kwargs)
    return obj
