"""ResNet v1.5 as a torch ``nn.Module`` with the JAX model's numerics.

Counterpart of ``horovod_tpu/models/resnet.py`` (``ResNet`` ``:59``,
``space_to_depth`` ``:51``, ``ResNet50``, ``ResNet101`` and
``ResNet152`` ``:141-143``).  The public ``forward`` takes NHWC input like
the flax model; inside, tensors are NCHW views in channels-last memory.
What is kept from the flax model, on purpose:

* SAME padding as XLA computes it: on even inputs the stride-2 3x3 conv
  and the 3x3/2 max pool pad (0, 1), not (1, 1).  Padding is explicit
  (``F.pad``: zeros for convs, -inf for the pool).
* BatchNorm: moments from the local batch in float32 with the fast
  variance ``E[x²] - E[x]²`` clipped at 0; running statistics updated as
  ``ra = 0.9·ra + 0.1·batch`` with that (biased) variance; the
  normalisation computed in float32 and rounded to the model dtype.
* Convolutions run in the model dtype (bf16 for ResNet-50) on float32
  master weights; the classifier runs in float32.
* The ``space_to_depth`` stem (``:97-117``): the 7x7/2 stem conv folded
  into a 4x4/1 conv over 2x2 blocks of the input padded by 3, the same
  function with 4x the input channels; it refuses odd input sizes.
* Parameter layouts follow torch (conv OIHW, linear (out, in));
  :func:`load_jax_params` carries the flax tree across.
* ``sync_bn=True`` (``:68``, ``:86``): every norm is
  ``sync_batch_norm.FlaxSyncBatchNorm``, whose moments are reduced
  across ranks (flax names its block norms ``SyncBatchNorm_<i>`` then,
  and :func:`load_jax_params` reads either name).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's SAME rule along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float) -> torch.Tensor:
    hl, hh = _same_pads(x.shape[2], k, stride)
    wl, wh = _same_pads(x.shape[3], k, stride)
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # flax's default kernel init: variance-scaling 1.0, fan-in, truncated
    # normal at two standard deviations.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class Conv(nn.Module):
    """Bias-free square conv with flax SAME (or explicit) padding, run in
    ``dtype`` on a float32 weight."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is None:
            x = _pad_same(x, self.k, self.stride, 0.0)
            pad = 0
        else:
            pad = self.padding
        return F.conv2d(x, self.weight.to(self.dtype), None, self.stride, pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW."""

    def __init__(self, c: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(
            torch.zeros(c) if zero_scale else torch.ones(c)
        )
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.dtype = dtype
        self.momentum, self.eps = 0.9, 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        return (y + self.bias.view(1, -1, 1, 1)).to(self.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 norm_cls=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype)
        norm = partial(norm_cls or BatchNorm, dtype=dtype)
        self.conv0, self.bn0 = conv(cin, filters, 1), norm(filters)
        self.conv1, self.bn1 = conv(filters, filters, 3, stride), norm(filters)
        self.conv2 = conv(filters, filters * 4, 1)
        self.bn2 = norm(filters * 4, zero_scale=True)
        self.proj = cin != filters * 4 or stride != 1
        if self.proj:
            self.conv_proj = conv(cin, filters * 4, 1, stride)
            self.norm_proj = norm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: (N, H, W, C) -> (N, H/b, W/b, C·b·b), the
    channels of a block in (row, column, channel) order."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                               c * block * block)


class ResNet(nn.Module):
    """ResNet v1.5 (stride on the 3x3) with a 7x7/2 stem (``stem="conv7"``)
    or its space-to-depth fold (``stem="space_to_depth"``); NHWC input,
    float32 logits.  Weights are drawn from ``seed`` on the CPU, then
    moved to ``device``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 *, seed: int = 0, device="cuda", stem: str = "conv7",
                 sync_bn: bool = False):
        super().__init__()
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(
                f"unknown stem {stem!r}; expected 'conv7' or 'space_to_depth'"
            )
        self.dtype, self.stem = dtype, stem
        if sync_bn:
            from ..sync_batch_norm import FlaxSyncBatchNorm as norm_cls
        else:
            norm_cls = BatchNorm
        if stem == "conv7":
            self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype)
        else:
            self.conv_init_s2d = Conv(12, num_filters, 4, 1, padding=0, dtype=dtype)
        self.bn_init = norm_cls(num_filters, dtype=dtype)
        blocks = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(cin, filters, stride, dtype, norm_cls))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, num_classes)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    _lecun_normal_(m.weight, m.weight[0].numel(), g)
            _lecun_normal_(self.fc.weight, cin, g)
            self.fc.bias.zero_()
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError(
                    "space_to_depth stem needs even input H/W (got "
                    f"{x.shape[1]}x{x.shape[2]}); use stem='conv7' for odd sizes"
                )
            # Output i of the 7x7/2 conv padded by 3 reads padded rows
            # [2i, 2i+7): blocks [i, i+4) after the 2x2 fold.
            x = space_to_depth(F.pad(x, (0, 0, 3, 3, 3, 3)), 2)
            x = self.conv_init_s2d(x.permute(0, 3, 1, 2))  # NHWC -> NCHW view
        else:
            x = self.conv_init(x.permute(0, 3, 1, 2))
        x = F.relu(self.bn_init(x))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.fc(x.float())


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])


def load_jax_params(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """Map the flax ResNet's ``params`` (and ``batch_stats``), as numpy
    arrays, to this module's ``state_dict`` names: conv kernels HWIO ->
    OIHW, the dense kernel (in, out) -> (out, in)."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr, perm=None):
        a = np.array(arr, np.float32)
        if perm is not None:
            a = np.transpose(a, perm)
        out[name] = torch.from_numpy(np.ascontiguousarray(a))

    def norm(prefix, p, s):
        put(f"{prefix}.scale", p["scale"])
        put(f"{prefix}.bias", p["bias"])
        if s is not None:
            put(f"{prefix}.mean", s["mean"])
            put(f"{prefix}.var", s["var"])

    stats = batch_stats or {}
    for stem in ("conv_init", "conv_init_s2d"):
        if stem in params:
            put(f"{stem}.weight", params[stem]["kernel"], (3, 2, 0, 1))
    norm("bn_init", params["bn_init"], stats.get("bn_init"))
    i = 0
    while f"BottleneckBlock_{i}" in params:
        bp = params[f"BottleneckBlock_{i}"]
        bs = stats.get(f"BottleneckBlock_{i}", {})
        for j in range(3):
            put(f"blocks.{i}.conv{j}.weight", bp[f"Conv_{j}"]["kernel"],
                (3, 2, 0, 1))
            key = f"BatchNorm_{j}" if f"BatchNorm_{j}" in bp else f"SyncBatchNorm_{j}"
            norm(f"blocks.{i}.bn{j}", bp[key], bs.get(key))
        if "conv_proj" in bp:
            put(f"blocks.{i}.conv_proj.weight", bp["conv_proj"]["kernel"],
                (3, 2, 0, 1))
            norm(f"blocks.{i}.norm_proj", bp["norm_proj"], bs.get("norm_proj"))
        i += 1
    put("fc.weight", params["Dense_0"]["kernel"], (1, 0))
    put("fc.bias", params["Dense_0"]["bias"])
    return out
