"""Plain softmax attention, the single-device reference of the
attention implementations.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``
``full_attention`` (``:30-62``).  Ring and Ulysses attention are not
ported yet (ROADMAP Queue A item 10).
"""

from __future__ import annotations

from typing import Optional

import torch

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
