"""Ulysses sequence parallelism: attention over a sequence axis through
two head/sequence re-shards.

Counterpart of ``horovod_tpu/parallel/ulysses.py`` (``:26-76``): an
all-to-all on the sequence axis's group flips ``[B, T_local, H, D]``
(sequence-sharded, every head) into ``[B, T_global, H/n, D]`` (every
position, this rank's heads), ``attn_fn`` runs on that, and a second
all-to-all flips back.  Each flip has ``lax.all_to_all(tiled=True)``'s
layout: the split axis is cut into n chunks in order, chunk j goes to
the rank at position j, and the chunks received are concatenated along
the concat axis in the senders' order.  Its backward is the inverse
flip (:class:`_Flip`).

The JAX package sends each flip through its exchange IR, which runs a
flip dense on every wire request but ``bf16`` on a wider floating
payload (``parallel/wire.py``): there the port raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import SP_AXIS, Mesh, refuse_in_capture
from .ring_attention import full_attention
from .wire import dense_shuffle


def _all_to_all(x: torch.Tensor, n: int, split: int, concat: int, group) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)`` over a group of n ranks."""
    shape = list(x.shape)
    chunks = x.reshape(shape[:split] + [n, shape[split] // n] + shape[split + 1:])
    send = chunks.movedim(split, 0).contiguous()  # [n, ...]: chunk j to rank j
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[i] came from the rank at position i: concatenate along concat.
    out = recv.movedim(0, concat)
    new = list(send.shape[1:])
    new[concat] = new[concat] * n
    return out.reshape(new)


class _Flip(torch.autograd.Function):
    """One tiled all-to-all; its backward is the inverse flip."""

    @staticmethod
    def forward(ctx, x, n, split, concat, group):
        ctx.n, ctx.split, ctx.concat, ctx.group = n, split, concat, group
        return _all_to_all(x, n, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.n, ctx.concat, ctx.split, ctx.group), None, None, None, None


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
    axis: str = SP_AXIS, causal: bool = False,
    attn_fn: Optional[Callable[..., torch.Tensor]] = None,
) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis`` of ``mesh`` via head
    exchange.  q/k/v: ``[B, T_local, H, D]`` on each rank with H
    divisible by the axis size; ``attn_fn`` (default ``full_attention``)
    sees ``[B, T_global, H/n, D]``."""
    n = mesh.axis_size(axis)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"heads ({h}) must be divisible by axis size {n}")
    dense_shuffle("the Ulysses flip", q.dtype)
    group = mesh.group(axis)
    if n > 1:
        refuse_in_capture("ulysses_attention")

    def flip(x, split, concat):
        return x if n == 1 else _Flip.apply(x, n, split, concat, group)

    # [B, T_loc, H, D] -> [B, T_global, H/n, D], and back.
    q, k, v = flip(q, 2, 1), flip(k, 2, 1), flip(v, 2, 1)
    out = (attn_fn or full_attention)(q, k, v, causal=causal)
    return flip(out, 1, 2)
