"""Plain softmax attention, and ring attention over a sequence axis.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``:
``full_attention`` (``:30-62``), the single-device reference, and
``ring_attention`` (``:65-140``), exact attention over a sequence sharded
on a mesh axis.  Each rank keeps its query block and passes its key and
value blocks around the axis's ranks (``dist.batch_isend_irecv``, the
next hop posted before the block's products, waited on after them),
folding each block into a float32 online softmax with the JAX
function's order of operations, its ``-1e30`` guards and its causal mask
from global positions.  The hop's backward is the inverse hop
(:class:`_Hop`); the rest is autograd.  The JAX ring is plain ``jnp``
with no Pallas kernel, so this is plain PyTorch.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import SP_AXIS, Mesh, refuse_in_capture

_NEG_INF = -1e30


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    scale: Optional[float] = None, segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention in float32: ``[B, T, H, D] -> [B, T, H, D]`` in
    q's dtype.  The causal mask is offset by ``Tk - Tq``; ``segment_ids``
    ([B, T]) restricts attention to keys of the same segment."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=s.device).tril(tk - tq)
        s = torch.where(mask, s, _NEG_INF)
    if segment_ids is not None:
        segmask = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        s = torch.where(segmask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class _Staged:
    """The works of a hop staged through host memory, and the copies of
    the received host buffers into the device's, made on ``wait()``."""

    def __init__(self, works, copies):
        self.works, self.copies = works, copies

    def wait(self):
        for w in self.works:
            w.wait()
        # The device buffers are the hop's outputs: a copy that autograd
        # recorded would replace their gradient with its own (zero).
        with torch.no_grad():
            for dst, src in self.copies:
                dst.copy_(src)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a hop of ``t`` goes through host memory: gloo sends and
    receives host memory only, so on a card under gloo (ranks sharing
    one card) it does."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _post(sends, recvs, to: int, frm: int, group) -> list:
    """Post sends to global rank ``to`` and receives from ``frm`` at once;
    the works to wait on (:func:`_staged`: through host copies)."""
    staged = _staged(sends[0], group)
    if staged:
        sends = [t.cpu() for t in sends]
        host = [torch.empty(t.shape, dtype=t.dtype) for t in recvs]
        copies, recvs = list(zip(recvs, host)), host
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in recvs]
    works = dist.batch_isend_irecv(ops)
    return [_Staged(works, copies)] if staged else works


class _Hop(torch.autograd.Function):
    """``lax.ppermute`` of tensors one step along a ring (rank at
    position j sends to j+1 and receives from j-1): ``_Hop.apply(to,
    frm, group, pending, *tensors)``.  The forward posts the transfers
    and returns the receive buffers at once; their works go to
    ``pending``, which the caller waits on before it reads them.  The
    backward sends the cotangents the other way (the inverse permute)."""

    @staticmethod
    def forward(ctx, to, frm, group, pending: List, *ts):
        ctx.to, ctx.frm, ctx.group = to, frm, group
        ts = [t.contiguous() for t in ts]
        out = [torch.empty_like(t) for t in ts]
        pending.extend(_post(ts, out, to, frm, group))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g.contiguous() for g in gs]  # autograd gives zeros, not None
        out = [torch.empty_like(g) for g in gs]
        for w in _post(gs, out, ctx.frm, ctx.to, ctx.group):
            w.wait()
        return (None, None, None, None) + tuple(out)


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
    axis: str = SP_AXIS, causal: bool = False, scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``axis`` of ``mesh``.

    q/k/v: ``[B, T_local, H, D]`` on each rank, the global sequence being
    the concatenation of the ranks' blocks in axis order.  Returns this
    rank's ``[B, T_local, H, D]`` block of ``full_attention`` over the
    gathered sequence, in q's dtype."""
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    b, t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    q_pos = idx * t + torch.arange(t, device=q.device)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), _NEG_INF, dtype=torch.float32, device=q.device)
    ranks = mesh.ranks(axis)
    to, frm = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    group = mesh.group(axis)
    if n > 1:
        refuse_in_capture("ring_attention")

    def block_update(o, l, m, kb, vb, i):
        # After i hops this rank holds the block of position (idx - i) mod n.
        kv_block = (idx - i) % n
        k_pos = kv_block * t + torch.arange(t, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, _NEG_INF)
        blk_max = s.amax(dim=-1)
        m_new = torch.maximum(m, blk_max)
        # Rows masked so far keep m == -inf; subtract 0 there.
        m_safe = torch.where(m_new <= _NEG_INF, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(torch.where(m <= _NEG_INF, _NEG_INF, m) - m_safe)
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, vb.float())
        return o, l, m_new

    # n - 1 hops and n block updates: the next hop goes out before each
    # block's products, and the last block computes with no hop after it.
    for i in range(n - 1):
        pending: list = []
        k_next, v_next = _Hop.apply(to, frm, group, pending, k, v)
        o, l, m = block_update(o, l, m, k, v, i)
        for w in pending:
            w.wait()
        k, v = k_next, v_next
    o, l, m = block_update(o, l, m, k, v, n - 1)
    l = l.transpose(1, 2)[..., None]  # [B, T, H, 1]
    return (o / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
