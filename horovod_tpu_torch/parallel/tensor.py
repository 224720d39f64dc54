"""Tensor (operator) parallel dense layers with flax ``nn.Dense`` numerics.

Counterpart of ``horovod_tpu/parallel/tensor.py`` ``ColumnParallelDense``,
``RowParallelDense`` and ``TensorParallelMLP`` (``:37-124``).  Widths are
GLOBAL; over a mesh whose ``axis`` has n ranks each rank holds one
shard: ``features/n`` output columns of a column layer, ``features_in/n``
input rows of a row layer.  Kernels keep flax's ``[in, out]`` layout and
the flax tree's names (``Dense_0.kernel``, ``Dense_0.bias``, and the row
layer's own ``bias``).  What flax's Dense does, and this does:

* the input, the float32 kernel and the bias are cast to ``dtype``;
* the product is rounded to ``dtype``, then the bias is added in
  ``dtype`` (a second rounding; ``F.linear`` with a bias would fuse the
  add and round once).

The row layer sums its partial products over the axis with one
all-reduce on the axis's group (:class:`AxisSum`), whose backward is an
all-reduce of the cotangents: the transpose of ``lax.psum`` under the
JAX package's ``shard_map(check_vma=False)``, so each rank's gradient is
``d(Σ_ranks L_r)/dθ_local``, the premise of ``grad_sync.py``'s rule (not
Megatron's identity-backward operator).  With ``mesh=None``, or a mesh
without ``axis``, the layers are the single-device ones.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .mesh import TP_AXIS, Mesh, refuse_in_capture


def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default kernel init for an ``[in, out]`` kernel: variance
    scaling 1.0 over fan-in, normal truncated at two standard deviations."""
    std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class AxisSum(torch.autograd.Function):
    """``lax.psum`` over one mesh axis: an all-reduce (sum) on the axis's
    group, out of place; the backward all-reduces the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def axis_sum(x: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """``lax.psum(x, axis)``: identity off the mesh or on an axis of one rank."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    refuse_in_capture("a row-parallel layer's sum")
    return AxisSum.apply(x, mesh.group(axis))


def axis_degree(mesh: Optional[Mesh], axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 off the mesh)."""
    return 1 if mesh is None else mesh.axis_size(axis)


def _shard(width: int, n: int, what: str, axis: str) -> int:
    if width % n != 0:
        raise ValueError(
            f"{what} ({width}) not divisible by '{axis}' axis size {n}"
        )
    return width // n


class Dense(nn.Module):
    """flax ``nn.Dense``: ``y = x.to(dtype) @ kernel.to(dtype)``, rounded
    to ``dtype``, then ``+ bias.to(dtype)``."""

    def __init__(self, features_in: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dtype), self.kernel.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class ColumnParallelDense(nn.Module):
    """Dense with output features sharded over ``axis``: this rank holds
    and produces ``features / n`` columns; no collective."""

    def __init__(self, features_in: int, features: int, axis: str = TP_AXIS,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.axis = axis
        local = _shard(features, axis_degree(mesh, axis), "features", axis)
        self.Dense_0 = Dense(features_in, local, use_bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class RowParallelDense(nn.Module):
    """Dense with input features sharded over ``axis`` (this rank holds
    ``features_in / n`` rows); the partial products are summed over the
    axis (:func:`axis_sum`), then the float32 bias, which lives beside
    ``Dense_0``, is added once, in the product's dtype."""

    def __init__(self, features_in: int, features: int, axis: str = TP_AXIS,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.axis = axis
        self.mesh = mesh
        local = _shard(features_in, axis_degree(mesh, axis), "features_in", axis)
        self.Dense_0 = Dense(local, features, False, dtype)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = axis_sum(self.Dense_0(x), self.mesh, self.axis)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class TensorParallelMLP(nn.Module):
    """Column → gelu (tanh approximation, flax's ``nn.gelu``) → row: one
    all-reduce per block."""

    def __init__(self, features_in: int, hidden: int, features: int,
                 axis: str = TP_AXIS, dtype: Optional[torch.dtype] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.wi = ColumnParallelDense(features_in, hidden, axis, dtype=dtype, mesh=mesh)
        self.wo = RowParallelDense(hidden, features, axis, dtype=dtype, mesh=mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))
