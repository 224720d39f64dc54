"""Broadcast model and optimizer state, and Python objects.

Counterpart of ``horovod_tpu/functions.py`` ``broadcast_parameters``
(``:88``), ``broadcast_optimizer_state`` (``:157``),
``broadcast_object`` (``:169``) and ``allgather_object`` (``:212``), in
the shape of the reference's ``horovod/torch/functions.py``: parameters
go as tensors, fused into one buffer per dtype; optimizer state and
objects as pickles (``torch.distributed``'s object collectives).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from . import runtime
from .ops import collectives, fusion
from .process_sets import resolve


def broadcast_parameters(
    params: Union[Dict[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]],
    root_rank: int = 0,
) -> None:
    """Overwrite ``params`` (a ``state_dict`` or ``named_parameters()``)
    with ``root_rank``'s values, in place.  A no-op in a world of one."""
    if runtime.size() == 1:
        return
    items = params.items() if isinstance(params, dict) else params
    tensors = [t for _, t in sorted(items, key=lambda kv: kv[0])]
    if not tensors:
        return
    with torch.no_grad():
        flats, meta = fusion.flatten_group(tensors)
        for f in flats:
            collectives.broadcast_(f, root_rank)
        for t, r in zip(tensors, fusion.unflatten_group(flats, meta)):
            t.copy_(r)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Load ``root_rank``'s optimizer state into ``optimizer`` on every
    rank.  A no-op in a world of one."""
    if runtime.size() == 1:
        return
    state = optimizer.state_dict()

    def to_cpu(v):
        if torch.is_tensor(v):
            return v.detach().cpu()
        if isinstance(v, dict):
            return {k: to_cpu(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(to_cpu(x) for x in v)
        return v

    synced = runtime.broadcast_object(to_cpu(state), root_rank)
    # load_state_dict moves state tensors onto each parameter's device.
    optimizer.load_state_dict(synced)


def broadcast_object(obj: Any, root_rank: int = 0, name: Optional[str] = None,
                     process_set=None) -> Any:
    """``root_rank``'s ``obj``, pickled, on every rank (reference
    ``horovod/torch/functions.py:165``).  ``obj`` itself in a world of
    one.  ``name`` is accepted for the reference's signature;
    ``process_set`` is validated (registered, as the JAX package's
    ``_ps_id`` checks it: ``process_sets.resolve``) and, as in the JAX package
    (``functions.py:169-230``), the object still reaches every rank of
    the world, from the world's ``root_rank``."""
    resolve(process_set)
    return runtime.broadcast_object(obj, root_rank)


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set=None) -> List[Any]:
    """Every rank's ``obj``, pickled, in rank order (reference
    ``horovod/torch/functions.py:206``); ``[obj]`` in a world of one.
    ``process_set`` is validated and, as in the JAX package, every rank
    of the world takes part."""
    resolve(process_set)
    if runtime.size() == 1:
        return [obj]
    out = [None] * runtime.size()
    dist.all_gather_object(out, obj)
    return out
