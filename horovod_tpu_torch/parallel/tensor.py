"""Dense layers of the transformer with flax ``nn.Dense`` numerics.

Counterpart of ``horovod_tpu/parallel/tensor.py`` ``ColumnParallelDense``,
``RowParallelDense`` and ``TensorParallelMLP`` (``:37-124``) at a tensor-
parallel degree of 1.  Kernels keep flax's ``[in, out]`` layout and the
flax tree's names (``Dense_0.kernel``, ``Dense_0.bias``, and the row
layer's own ``bias``).  What flax's Dense does, and this does:

* the input, the float32 kernel and the bias are cast to ``dtype``;
* the product is rounded to ``dtype``, then the bias is added in
  ``dtype`` (a second rounding; ``F.linear`` with a bias would fuse the
  add and round once).

A tensor-parallel degree above 1 is ROADMAP Queue A item 10.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import TP_AXIS


def _check_tp(tp: int) -> None:
    if tp != 1:
        raise NotImplementedError(
            f"tensor parallelism (tp={tp}) is not ported yet: ROADMAP "
            "Queue A item 10"
        )


def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default kernel init for an ``[in, out]`` kernel: variance
    scaling 1.0 over fan-in, normal truncated at two standard deviations."""
    std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


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
    """Dense with output features sharded over ``axis`` (degree 1 here)."""

    def __init__(self, features_in: int, features: int, axis: str = TP_AXIS,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 tp: int = 1):
        super().__init__()
        _check_tp(tp)
        self.axis = axis
        self.Dense_0 = Dense(features_in, features, use_bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class RowParallelDense(nn.Module):
    """Dense with input features sharded over ``axis`` (degree 1 here);
    the float32 bias lives beside ``Dense_0`` and is added after the
    (absent) sum across the axis, in the product's dtype."""

    def __init__(self, features_in: int, features: int, axis: str = TP_AXIS,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 tp: int = 1):
        super().__init__()
        _check_tp(tp)
        self.axis = axis
        self.Dense_0 = Dense(features_in, features, False, dtype)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class TensorParallelMLP(nn.Module):
    """Column → gelu (tanh approximation, flax's ``nn.gelu``) → row."""

    def __init__(self, features_in: int, hidden: int, features: int,
                 axis: str = TP_AXIS, dtype: Optional[torch.dtype] = None,
                 tp: int = 1):
        super().__init__()
        self.wi = ColumnParallelDense(features_in, hidden, axis, dtype=dtype, tp=tp)
        self.wo = RowParallelDense(hidden, features, axis, dtype=dtype, tp=tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))
