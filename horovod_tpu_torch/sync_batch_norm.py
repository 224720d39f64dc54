"""Cross-rank synchronized BatchNorm, in its two forms.

* :class:`FlaxSyncBatchNorm`, the model form: counterpart of
  ``horovod_tpu/sync_batch_norm.py`` ``SyncBatchNorm`` (``:39``), the
  norm of ``models/resnet.py`` ``ResNet(sync_bn=True)``.  Flax's layout
  (``scale``, ``bias``, ``mean``, ``var``; features on dim 1 here, NCHW),
  flax's momentum convention (``ra = m·ra + (1-m)·batch``, the biased
  variance).  The moments are one fused Sum allreduce of
  ``[sum | sum_sq | count]`` in float32 over the world or a
  ``process_set``, and the backward is autograd through that
  collective, whose gradient is the same Sum allreduce (the transpose
  of ``psum``), as the JAX package gets it from autodiff.  The
  normalisation is folded into two per-channel float32 vectors and
  applied in the model dtype, ``x·mult + shift``, as the JAX module does.
* :class:`SyncBatchNorm`, the public form: ``hvd.SyncBatchNorm`` with
  ``horovod.torch`` semantics (``horovod_tpu/interop/torch.py:846-1008``):
  a ``torch.nn`` ``_BatchNorm`` (``weight``, ``bias``, ``running_mean``,
  ``running_var``, ``num_batches_tracked``; PyTorch's momentum, the
  unbiased running variance) whose training statistics are the global
  batch's (one fused float32 Sum allreduce of ``[sum | sum_sq |
  count]``), whose backward all-reduces the per-channel sums of ``dy``
  and ``dy·x̂``, so ``dx`` is the global batch's, and whose weight and
  bias gradients stay local (the optimizer averages them).  A world of
  one and eval mode run plain BatchNorm.

Both keep the count on the device (no host read), so each runs inside a
CUDA graph's capture on NCCL.  A non-member of ``process_set`` uses its
local statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm

from . import runtime
from .process_sets import member_group, resolve


def _where(process_set):
    """``(group, reduce)``: the set's group (None: the world's) and
    whether this rank reduces at all (a member of more than one rank's
    set)."""
    if not runtime.is_initialized():
        return None, False
    group, ranks, member = member_group(resolve(process_set))
    size = runtime.size() if ranks is None else len(ranks)
    return group, member and size > 1


def _sum_(v: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
    return v


class _SumAllreduce(torch.autograd.Function):
    """``psum``: a Sum allreduce whose gradient is the same allreduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return _sum_(dy.contiguous().clone(), ctx.group), None


def _channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.view([1, -1] + [1] * (ndim - 2))


class FlaxSyncBatchNorm(nn.Module):
    """flax-layout BatchNorm whose batch moments are reduced across ranks
    (NCHW, channels on dim 1); ``momentum`` is flax's (0.9 in the
    ResNet)."""

    def __init__(self, c: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False, momentum: float = 0.9, eps: float = 1e-5,
                 process_set=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(c) if zero_scale else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.process_set = process_set

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, nd = x.shape[1], x.dim()
        if self.training:
            xf = x.float()
            dims = [0] + list(range(2, nd))
            count = torch.full((1,), x.numel() // c, dtype=torch.float32,
                               device=x.device)
            packed = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
            group, reduce = _where(self.process_set)
            if reduce:
                packed = _SumAllreduce.apply(packed, group)
            total, total_sq, n = packed[:c], packed[c:2 * c], packed[-1]
            mean = total / n
            var = total_sq / n - mean * mean
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mult = torch.rsqrt(var + self.eps) * self.scale
        shift = -mean * mult + self.bias
        dt = self.dtype
        return x.to(dt) * _channel(mult.to(dt), nd) + _channel(shift.to(dt), nd)


class _SyncNormalize(torch.autograd.Function):
    """Normalisation by the global statistics, with the reference's
    hand-written backward: ``dx`` from the globally summed ``dy`` and
    ``dy·x̂`` per channel; the weight and bias gradients local."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, count, eps, group, reduce):
        nd = x.dim()
        x32 = x.float()
        rstd = torch.rsqrt(var + eps)
        xhat = (x32 - _channel(mean, nd)) * _channel(rstd, nd)
        ctx.save_for_backward(xhat, weight, rstd, count)
        ctx.group, ctx.reduce, ctx.in_dtype = group, reduce, x.dtype
        y = xhat
        if weight is not None:
            y = y * _channel(weight.float(), nd) + _channel(bias.float(), nd)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, weight, rstd, count = ctx.saved_tensors
        nd = dy.dim()
        dy32 = dy.float()
        dims = [0] + list(range(2, nd))
        dyhat = dy32 if weight is None else dy32 * _channel(weight.float(), nd)
        sum_dy = dyhat.sum(dims)
        sum_dy_xhat = (dyhat * xhat).sum(dims)
        stats = torch.cat([sum_dy, sum_dy_xhat])
        if ctx.reduce:
            _sum_(stats, ctx.group)
        c = sum_dy.numel()
        g_dy, g_dy_xhat = stats[:c], stats[c:]
        dx = _channel(rstd, nd) * (dyhat - _channel(g_dy / count, nd)
                                   - xhat * _channel(g_dy_xhat / count, nd))
        dweight = dbias = None
        if weight is not None:
            dweight = (dy32 * xhat).sum(dims).to(weight.dtype)
            dbias = dy32.sum(dims).to(weight.dtype)
        return dx.to(ctx.in_dtype), dweight, dbias, None, None, None, None, None, None


class SyncBatchNorm(_BatchNorm):
    """N-d batch norm with ``horovod.torch`` semantics (module docstring):
    ``SyncBatchNorm(num_features, eps=1e-5, momentum=0.1, affine=True,
    track_running_stats=True, process_set=None)``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: Optional[float] = 0.1,
                 affine: bool = True, track_running_stats: bool = True,
                 process_set=None, device=None, dtype=None):
        super().__init__(num_features, eps=eps, momentum=momentum, affine=affine,
                         track_running_stats=track_running_stats, device=device,
                         dtype=dtype)
        self.process_set = process_set

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {input.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        training = self.training or not self.track_running_stats
        group, reduce = _where(self.process_set)
        if not training or not runtime.is_initialized() or runtime.size() == 1:
            return super().forward(x)
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        x32 = x.detach().float()
        local = torch.cat([x32.sum(dims), (x32 * x32).sum(dims),
                           torch.full((1,), x.numel() // c, dtype=torch.float32,
                                      device=x.device)])
        if reduce:
            _sum_(local, group)
        m = local[-1]
        mean = local[:c] / m
        var = local[c:2 * c] / m - mean * mean  # biased: the normalisation's
        if self.training and self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                unbiased = var * (m / (m - 1.0))
                if self.momentum is None:  # a cumulative average, on the device
                    eaf = 1.0 / self.num_batches_tracked.float()
                    self.running_mean.mul_(1 - eaf).add_(eaf * mean)
                    self.running_var.mul_(1 - eaf).add_(eaf * unbiased)
                else:
                    eaf = self.momentum
                    self.running_mean.mul_(1 - eaf).add_(
                        mean.to(self.running_mean.dtype), alpha=eaf)
                    self.running_var.mul_(1 - eaf).add_(
                        unbiased.to(self.running_var.dtype), alpha=eaf)
        return _SyncNormalize.apply(x, self.weight, self.bias, mean, var, m, self.eps,
                                    group, reduce)
