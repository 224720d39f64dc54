"""MNIST models as torch ``nn.Module``s with the flax models' numerics.

Counterpart of ``horovod_tpu/models/mnist.py`` (``MnistCNN``,
``MnistMLP``; the reference's ``examples/pytorch/pytorch_mnist.py``
``Net``: conv5x5(10) -> pool -> conv5x5(20) -> pool -> fc50 -> fc10).
``forward`` takes NHWC input like the flax models and flattens in NHWC
order, so the dense kernels carry across unpermuted; weights start as
flax's defaults (LeCun normal kernels, zero biases), drawn from
``seed``.  :func:`load_jax_params` maps a flax parameter tree onto
either model's ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import _lecun_normal_


def _init(module: nn.Module, seed: int, device) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, m.weight[0].numel(), g)
                m.bias.zero_()
    module.to(device)


class MnistCNN(nn.Module):
    """The reference example's LeNet-style net: (B, 28, 28, 1) NHWC in,
    float32 logits out, computed in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(1, 10, 5)
        self.conv1 = nn.Conv2d(10, 20, 5)
        self.fc0 = nn.Linear(320, 50)
        self.fc1 = nn.Linear(50, 10)
        _init(self, seed, device)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype))
        return F.relu(F.max_pool2d(y, 2))

    def _dense(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, fc.weight.to(self.dtype), fc.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = self._conv(self.conv1, self._conv(self.conv0, x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        x = F.relu(self._dense(self.fc0, x))
        return self._dense(self.fc1, x).float()


class MnistMLP(nn.Module):
    """The small MLP of the unit tests: flatten, dense ``hidden``, relu,
    dense 10."""

    def __init__(self, hidden: int = 128, dtype: torch.dtype = torch.float32,
                 *, seed: int = 0, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.fc0 = nn.Linear(784, hidden)
        self.fc1 = nn.Linear(hidden, 10)
        _init(self, seed, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        x = F.relu(F.linear(x, self.fc0.weight.to(self.dtype),
                            self.fc0.bias.to(self.dtype)))
        return F.linear(x, self.fc1.weight.to(self.dtype),
                        self.fc1.bias.to(self.dtype)).float()


def load_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map the flax ``MnistCNN`` or ``MnistMLP`` ``params`` (numpy arrays)
    to this module's ``state_dict`` names: conv kernels HWIO -> OIHW,
    dense kernels (in, out) -> (out, in)."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr, perm=None):
        a = np.array(arr, np.float32)
        if perm is not None:
            a = np.transpose(a, perm)
        out[name] = torch.from_numpy(np.ascontiguousarray(a))

    for i in range(2):
        if f"Conv_{i}" in params:
            put(f"conv{i}.weight", params[f"Conv_{i}"]["kernel"], (3, 2, 0, 1))
            put(f"conv{i}.bias", params[f"Conv_{i}"]["bias"])
        put(f"fc{i}.weight", params[f"Dense_{i}"]["kernel"], (1, 0))
        put(f"fc{i}.bias", params[f"Dense_{i}"]["bias"])
    return out
