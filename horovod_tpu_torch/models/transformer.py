"""GPT-style decoder-only transformer as a torch ``nn.Module`` with the
JAX model's numerics.

Counterpart of ``horovod_tpu/models/transformer.py``:
``TransformerConfig`` (``:46``), ``Attention`` (``:74``), ``Block``
(``:142``), ``Transformer`` (``:181``), ``gpt_small`` (``:296``),
``gpt_tiny`` (``:307``), ``packed_token_cross_entropy`` (``:317``) and
``token_cross_entropy`` (``:339``).  Ported: the dense single-device
model with ``attn_impl`` "flash" (kernel B2, ``ops/flash.py``) or "full".
Ring and Ulysses attention, a sequence or tensor axis, MoE and remat
raise ``NotImplementedError`` (ROADMAP Queue A item 10).

Kept from the flax model, on purpose:

* parameter names and layouts of the flax tree (``block_0.attn.qkv.
  Dense_0.kernel`` is ``[in, out]``), so :func:`load_jax_params` copies
  without transposes, and the qkv columns in ``[3, H, D]`` order;
* the residual stream in ``cfg.dtype``; LayerNorm in float32 with
  epsilon 1e-6 and the variance as ``E[x²] − E[x]²`` (flax's
  ``use_fast_variance``);
* the float32 ``wpe``, with positions that restart at each packed
  document;
* the tied head ``x.to(dtype) @ wte.to(dtype)ᵀ``, rounded to ``dtype``,
  then cast to float32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash import flash_attention
from ..parallel import EP_AXIS, SP_AXIS, TP_AXIS
from ..parallel.ring_attention import full_attention
from ..parallel.tensor import (
    ColumnParallelDense,
    RowParallelDense,
    TensorParallelMLP,
    lecun_normal_,
)

_QUEUE = "ROADMAP Queue A item 10"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    model_dim: int = 768
    num_heads: int = 12          # global head count
    head_dim: int = 64
    ff_dim: int = 3072           # global feed-forward width
    max_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    causal: bool = True
    # Parallelism:
    attn_impl: str = "flash"     # "flash" | "full" ("ring", "ulysses": not ported)
    sp_axis: str = SP_AXIS
    tp_axis: str = TP_AXIS
    remat: bool = False
    # MoE (0: dense FFN everywhere; MoE is not ported):
    moe_every: int = 0
    num_experts_local: int = 1
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    ep_axis: str = EP_AXIS

    def check(self) -> None:
        """Raise for what the port does not run yet."""
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} is not ported yet: {_QUEUE}"
            )
        if self.attn_impl not in ("flash", "full"):
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r}; expected 'flash', "
                "'full', 'ring', or 'ulysses'"
            )
        if self.moe_every > 0:
            raise NotImplementedError(f"MoE (moe_every > 0) is not ported yet: {_QUEUE}")
        if self.remat:
            raise NotImplementedError(f"remat is not ported yet: {_QUEUE}")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: float32 statistics with the
    fast variance ``max(0, E[x²] − E[x]²)``, epsilon 1e-6,
    ``y = (x − mean) · (rsqrt(var + eps) · scale) + bias``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class Embed(nn.Module):
    """flax ``nn.Embed``: a float32 ``embedding`` table."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class Attention(nn.Module):
    """Multi-head self-attention: one qkv projection, flash or full
    attention, an output projection."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        cfg.check()
        self.cfg = cfg
        width = cfg.num_heads * cfg.head_dim
        self.qkv = ColumnParallelDense(cfg.model_dim, 3 * width, cfg.tp_axis,
                                       dtype=cfg.dtype)
        self.proj = RowParallelDense(width, cfg.model_dim, cfg.tp_axis,
                                     dtype=cfg.dtype)

    def forward(self, x: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv.unbind(2)  # strided views: B2 reads them in place
        if cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, cfg.causal, segment_ids=segment_ids)
        else:
            out = full_attention(q, k, v, causal=cfg.causal,
                                 segment_ids=segment_ids)
        return self.proj(out.reshape(b, t, cfg.num_heads * cfg.head_dim))


class Block(nn.Module):
    """Pre-LN transformer block with the dense MLP."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.model_dim)
        self.attn = Attention(cfg)
        self.ln_mlp = LayerNorm(cfg.model_dim)
        self.mlp = TensorParallelMLP(cfg.model_dim, cfg.ff_dim, cfg.model_dim,
                                     cfg.tp_axis, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor, segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.cfg.dtype
        x = x + self.attn(self.ln_attn(x).to(dtype), segment_ids)
        y = self.mlp(self.ln_mlp(x).to(dtype))
        return x + y.to(x.dtype), torch.zeros((), device=x.device)


class Transformer(nn.Module):
    """Decoder-only LM: int token ids ``[B, T]`` (and optional packed
    ``segment_ids``) -> ``(logits [B, T, vocab] float32, aux loss)``.
    Weights are drawn from ``seed`` on the CPU with flax's initialisers,
    then moved to ``device``."""

    def __init__(self, cfg: TransformerConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        cfg.check()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.model_dim)
        self.wpe = nn.Parameter(torch.empty(cfg.max_len, cfg.model_dim))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.model_dim)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.wte.embedding.normal_(0.0, 0.02, generator=g)
            self.wpe.normal_(0.0, 0.02, generator=g)
            for name, p in self.named_parameters():
                if name.endswith(".kernel"):
                    lecun_normal_(p, g)
        self.to(device)

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, t = tokens.shape
        if t > cfg.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {cfg.max_len}")
        x = self.wte(tokens)
        if segment_ids is not None:
            # Positions restart at each packed document.
            idx = torch.arange(t, device=tokens.device).expand(b, t)
            is_start = torch.cat(
                [torch.ones((b, 1), dtype=torch.bool, device=tokens.device),
                 segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1,
            )
            start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
            x = (x + self.wpe[idx - start]).to(cfg.dtype)
        else:
            x = (x + self.wpe[:t][None]).to(cfg.dtype)
        aux_total = torch.zeros((), device=x.device)
        for i in range(cfg.num_layers):
            x, aux = getattr(self, f"block_{i}")(x, segment_ids)
            aux_total = aux_total + aux
        x = self.ln_f(x)
        # Tied head in the compute dtype, cast up for the float32 loss.
        logits = (x.to(cfg.dtype) @ self.wte.embedding.to(cfg.dtype).t()).float()
        return logits, aux_total


def gpt_small(*, seed: int = 0, device="cuda", **overrides) -> Transformer:
    """GPT-2 small (124M): vocab 50304, 12 layers, width 768, 12 heads of
    64, ff 3072, max_len 1024, bf16 compute."""
    cfg = TransformerConfig(
        vocab_size=50304, num_layers=12, model_dim=768, num_heads=12,
        head_dim=64, ff_dim=3072, max_len=1024,
    )
    return Transformer(dataclasses.replace(cfg, **overrides), seed=seed,
                       device=device)


def gpt_tiny(*, seed: int = 0, device="cuda", **overrides) -> Transformer:
    """Tiny float32 config for tests."""
    cfg = TransformerConfig(
        vocab_size=256, num_layers=2, model_dim=64, num_heads=4,
        head_dim=16, ff_dim=128, max_len=256, dtype=torch.float32,
    )
    return Transformer(dataclasses.replace(cfg, **overrides), seed=seed,
                       device=device)


def packed_token_cross_entropy(logits: torch.Tensor, tokens: torch.Tensor,
                               segment_ids: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of packed rows: position t predicts t+1
    only inside one document, padding (segment 0) excluded; the mean over
    valid positions.  The float32 logits are read in place: every
    position's loss is computed and the last one weighted 0."""
    b, t, v = logits.shape
    targets = torch.roll(tokens, -1, dims=-1).long()
    ce = F.cross_entropy(logits.float().reshape(b * t, v), targets.reshape(-1),
                         reduction="none").view(b, t)[:, :-1]
    valid = (segment_ids[:, 1:] == segment_ids[:, :-1]) & (segment_ids[:, 1:] > 0)
    w = valid.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer targets over float32 logits, with no
    one-hot or probability tensor of the logits' size beyond what
    ``F.cross_entropy`` keeps for its backward."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, v),
                           targets.long().reshape(-1))


def load_jax_params(model: Transformer, params: Mapping) -> Transformer:
    """Copy the flax tree of numpy arrays (``params["params"]["block_0"]
    ["attn"]["qkv"]["Dense_0"]["kernel"]``, ...) into ``model``, name for
    name and without transposes: every kernel keeps flax's ``[in, out]``.
    Raises if the two sets of names differ."""
    tree = params.get("params", params)
    flat = {}

    def walk(prefix, node):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(name, val)
            else:
                flat[name] = val

    walk("", tree)
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise KeyError(
            f"flax tree and model differ: only in the tree "
            f"{sorted(set(flat) - set(own))}, only in the model "
            f"{sorted(set(own) - set(flat))}"
        )
    with torch.no_grad():
        for name, p in own.items():
            arr = np.array(flat[name], np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model
