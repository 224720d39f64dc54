"""Pipeline parallelism: GPipe microbatching over the ``pp`` axis of a mesh.

Counterpart of ``horovod_tpu/parallel/pipeline.py`` ``pipeline_apply``
(``:25-111``).  Each rank of the axis holds one stage; the schedule has
``M + n − 1`` steps, and at each one every stage applies itself to its
input and passes the result one hop on (``ring_attention._Hop``, whose
backward is the inverse hop; under gloo on a card through host memory).
Stage 0 takes microbatch ``clip(s, 0, M − 1)`` where the others take
the hop's arrival, and the last stage writes output ``s − (n − 1)`` from
step ``n − 1`` on.  As in the JAX function the masked inputs and
outputs are selects, not branches, so every stage's backward runs every
hop's inverse, in the same order on every rank.  Autograd through the
schedule is GPipe's backward; ``remat_stage`` recomputes each stage
application in it (``torch.utils.checkpoint``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import PP_AXIS, Mesh, refuse_in_capture
from .ring_attention import _Hop
from .tensor import AxisSum
from .wire import dense_shuffle


def pipeline_apply(
    stage_fn: Callable[..., torch.Tensor],
    stage_params,
    microbatches: torch.Tensor,
    mesh: Mesh,
    axis: str = PP_AXIS,
    broadcast_outputs: bool = True,
    remat_stage: bool = False,
) -> torch.Tensor:
    """Run ``microbatches`` ``[M, B, ...]`` through the n-stage pipeline on
    ``axis`` of ``mesh``; this rank is the stage at its coordinate on the
    axis and applies ``stage_fn(stage_params, x)``, which must keep its
    input's shape.

    Returns ``[M, B, ...]`` outputs in the microbatches' dtype: on every
    rank with ``broadcast_outputs`` (the last stage's, summed over the
    axis), else valid on the last stage only (zeros elsewhere).  Each
    rank's gradient is that of the sum of the ranks' losses, as under
    the JAX package's ``shard_map(check_vma=False)``."""
    n = mesh.axis_size(axis)
    stage = mesh.axis_index(axis)
    m = microbatches.shape[0]
    if n > 1:
        refuse_in_capture("pipeline_apply")
    fn = stage_fn
    if remat_stage:
        def fn(params, x):
            return checkpoint(stage_fn, params, x, use_reentrant=False,
                              preserve_rng_state=False)
    ranks = mesh.ranks(axis)
    to, frm = ranks[(stage + 1) % n], ranks[(stage - 1) % n]
    group = mesh.group(axis)
    dev = microbatches.device
    first = torch.tensor(stage == 0, device=dev)
    last = stage == n - 1

    act = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0]) for _ in range(m)]
    for s in range(m + n - 1):
        inp = torch.where(first, microbatches[min(max(s, 0), m - 1)], act)
        y = fn(stage_params, inp)
        if s >= n - 1:
            write = torch.tensor(last, device=dev)
            outs[s - (n - 1)] = torch.where(write, y.to(microbatches.dtype),
                                            outs[s - (n - 1)])
        if n > 1 and s < m + n - 2:  # the last step's hop feeds nothing
            dense_shuffle("the pipeline hop", y.dtype)
            pending: list = []
            (act,) = _Hop.apply(to, frm, group, pending, y)
            for w in pending:
                w.wait()
        else:
            act = y
    out = torch.stack(outs)
    if broadcast_outputs and n > 1:
        out = AxisSum.apply(torch.where(torch.tensor(last, device=dev), out,
                                        torch.zeros_like(out)), group)
    return out
