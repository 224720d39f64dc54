"""Collectives over the global process group.

Counterpart of ``horovod_tpu/ops/traced.py`` for the global set:
``_scale`` (``:94-105``), ``allreduce`` (``:313-357``) and broadcast.
Where the JAX package emits XLA collectives inside the compiled step,
these are eager ``torch.distributed`` calls (NCCL on the card, gloo on
the CPU).

Average is SUM followed by a postscale of ``1/size``, as the reference
rewrites it (``operations.cc:1396-1399``) and the JAX package keeps it:
``ReduceOp.AVG`` is never used, since gloo refuses it for a world above
one and it would round differently from ``_scale``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from . import kernels


class ReduceOp:
    AVERAGE = 0
    SUM = 1


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM


def f32_reciprocal(n: float) -> float:
    """``float32(1 / n)``.  Under ``jit`` XLA turns ``x / n`` by a
    constant (``lax.pmean``, the quantized wire's averages and scales)
    into ``x * float32(1 / n)``; multiplying by this keeps the port
    bitwise with the JAX package at any world size."""
    return float(np.float32(1.0) / np.float32(n))


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * factor`` in the JAX package's precision rules: f16/bf16 scale
    in float32 and round back (kernel B1 on the card), integers scale in
    float32 and truncate, float32 multiplies by ``float32(factor)``."""
    if factor == 1.0:
        return x
    if x.dtype in (torch.float16, torch.bfloat16):
        return kernels.scale_buffer(x, factor, x.dtype)
    if not x.dtype.is_floating_point:
        return (x.float() * factor).to(x.dtype)
    return x * factor


def allreduce_(
    x: torch.Tensor,
    op: int = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> torch.Tensor:
    """Allreduce over the world; may reduce ``x`` in place.  Returns the
    result, which is ``x`` itself unless a scale produced a new tensor."""
    if op not in (Average, Sum):
        raise ValueError("allreduce supports op=Average or op=Sum")
    size = runtime.size()
    x = _scale(x, prescale_factor)
    if op == Average:
        postscale_factor = postscale_factor / size
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return _scale(x, postscale_factor)


def allreduce(
    x: torch.Tensor,
    op: int = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> torch.Tensor:
    """Out-of-place :func:`allreduce_`: ``x`` is left as it was."""
    return allreduce_(x.clone(), op, prescale_factor, postscale_factor)


def broadcast_(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Overwrite ``x`` with ``root_rank``'s value, in place."""
    if runtime.size() > 1:
        dist.broadcast(x, src=root_rank)
    return x


def broadcast(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    return broadcast_(x.clone(), root_rank)
