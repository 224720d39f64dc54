"""Expert parallelism: a top-k routed mixture of experts whose experts are
sharded over the ``ep`` axis of a mesh.

Counterpart of ``horovod_tpu/parallel/moe.py``: ``_top_k_gating``
(``:28-71``), ``moe_alltoall_dispatch`` and ``moe_alltoall_combine``
(``:100-111``) and ``MoELayer`` (``:114-173``).  The router assigns each
token to its top ``k`` experts with a static capacity per expert (the
tokens past it are dropped: a zero combine weight, the residual carries
them); one tiled all-to-all over the ``ep`` group sends each expert's
buffer to the rank that holds it, every rank runs its experts as one
batched product, and the inverse all-to-all brings the results back.
The all-to-alls are the Ulysses flip (``parallel/ulysses.py``
``_Flip``), whose backward is the inverse flip.  The gating, dispatch,
expert and combine products are plain PyTorch, as the JAX package
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mesh import EP_AXIS, Mesh, refuse_in_capture
from .tensor import Dense, lecun_normal_
from .ulysses import _Flip
from .wire import dense_shuffle


def _top_k_gating(logits: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity, in float32.

    logits: ``[S, E]``.  Returns (combine ``[S, E, C]``, dispatch bool
    ``[S, E, C]``, the Switch load-balancing loss).  Each of the ``k``
    rounds takes every token's highest remaining gate (the first on a
    tie, as ``jnp.argmax``), places the token after the ones its expert
    already holds, in token order, and drops it past ``capacity``."""
    s, e = logits.shape
    dev = logits.device
    gates = torch.softmax(logits.float(), dim=-1)
    experts = torch.arange(e, device=dev)
    slots = torch.arange(capacity, device=dev)
    remaining = gates
    location_base = torch.zeros(e, dtype=torch.int32, device=dev)
    combine = torch.zeros((s, e, capacity), dtype=torch.float32, device=dev)
    importance = torch.zeros(e, dtype=torch.float32, device=dev)
    load = torch.zeros(e, dtype=torch.float32, device=dev)
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)  # [S]
        onehot = (choice[:, None] == experts).float()  # [S, E]
        gate_val = (gates * onehot).sum(-1)  # [S]
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
        pos_tok = pos.sum(-1).to(torch.int32) + location_base[choice]
        keep = pos_tok < capacity
        slot = (torch.where(keep, pos_tok, capacity)[:, None] == slots).float()
        combine = combine + ((gate_val * keep)[:, None] * onehot)[..., None] * slot[:, None, :]
        location_base = location_base + (onehot * keep[:, None]).sum(0).to(torch.int32)
        importance = importance + (gates * onehot).mean(0)
        load = load + onehot.mean(0)
        remaining = remaining * (1.0 - onehot)
    # E · Σ_e mean-gate_e · token-frac_e over the k rounds.
    aux = e * torch.sum(importance / k * load / k)
    return combine, combine > 0.0, aux


def moe_alltoall_dispatch(x: torch.Tensor, mesh: Mesh, axis: str = EP_AXIS) -> torch.Tensor:
    """``[E, C, d]`` dispatch buffers -> ``[E_local, n·C, d]``: this rank's
    experts' tokens from every rank of ``axis``, in rank order."""
    dense_shuffle("the MoE dispatch", x.dtype)
    return _Flip.apply(x, mesh.axis_size(axis), 0, 1, mesh.group(axis))


def moe_alltoall_combine(y: torch.Tensor, mesh: Mesh, axis: str = EP_AXIS) -> torch.Tensor:
    """The inverse: ``[E_local, n·C, d]`` -> ``[E, C, d]``, each ``C``
    slice back to the rank it came from."""
    dense_shuffle("the MoE combine", y.dtype)
    return _Flip.apply(y, mesh.axis_size(axis), 1, 0, mesh.group(axis))


class MoELayer(nn.Module):
    """Mixture-of-experts FFN with its experts sharded over ``axis``.

    ``num_experts_local`` experts on each rank (``E = n·num_experts_local``
    over an axis of n ranks); ``forward(x [B, T, d])`` returns ``(out
    [B, T, d], aux)``.  The router (``router.kernel [d, E]``,
    ``router.bias``) runs in float32 on every rank's own tokens; ``wi
    [E_local, d, hidden]`` and ``wo [E_local, hidden, d]`` are float32
    and used in ``dtype`` (default: x's).  With ``mesh=None``, or a mesh
    without ``axis``, it is the single-device layer with
    ``E = num_experts_local``, as in the JAX package."""

    def __init__(self, features: int, num_experts_local: int, hidden: int, k: int = 2,
                 capacity_factor: float = 1.25, axis: str = EP_AXIS,
                 dtype: Optional[torch.dtype] = None, mesh: Optional[Mesh] = None):
        super().__init__()
        self.num_experts_local, self.hidden = num_experts_local, hidden
        self.k, self.capacity_factor, self.axis = k, capacity_factor, axis
        self.dtype, self.mesh = dtype, mesh
        self.n = mesh.axis_size(axis) if mesh is not None else 1
        e = self.n * num_experts_local
        self.router = Dense(features, e, dtype=torch.float32)
        self.wi = nn.Parameter(torch.empty(num_experts_local, features, hidden))
        self.wo = nn.Parameter(torch.empty(num_experts_local, hidden, features))

    def reset_parameters(self, g: torch.Generator) -> None:
        """flax's initialisers: lecun normal over the router's and the
        experts' fan-in (``E_local · d`` and ``E_local · hidden``: flax
        counts the expert axis into the receptive field), zero bias."""
        with torch.no_grad():
            lecun_normal_(self.router.kernel, g)
            self.router.bias.zero_()
            for w in (self.wi, self.wo):
                std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        n, e_loc = self.n, self.num_experts_local
        e = n * e_loc
        s = b * t
        capacity = max(1, int(s * self.capacity_factor * self.k / e))
        if n > 1:
            refuse_in_capture("MoELayer")

        xf = x.reshape(s, d)
        logits = self.router(xf.float())  # the router in float32
        combine, dispatch, aux = _top_k_gating(logits, self.k, capacity)

        buf = torch.einsum("sec,sd->ecd", dispatch.to(xf.dtype), xf)  # [E, C, d]
        if n > 1:
            buf = moe_alltoall_dispatch(buf, self.mesh, self.axis)  # [E_loc, n·C, d]
        else:
            buf = buf.reshape(e_loc, n * capacity, d)
        dtype = self.dtype or x.dtype
        h = torch.matmul(buf.to(dtype), self.wi.to(dtype))
        h = F.gelu(h, approximate="tanh")
        y = torch.matmul(h, self.wo.to(dtype))
        if n > 1:
            y = moe_alltoall_combine(y, self.mesh, self.axis)
        else:
            y = y.reshape(e, capacity, d)
        out = torch.einsum("sec,ecd->sd", combine.to(y.dtype), y)
        return out.reshape(b, t, d), aux
