"""GPT-style decoder-only transformer as a torch ``nn.Module`` with the
JAX model's numerics, wired for hybrid parallelism over a mesh.

Counterpart of ``horovod_tpu/models/transformer.py``:
``TransformerConfig`` (``:46``), ``Attention`` (``:74``), ``Block``
(``:142``), ``Transformer`` (``:181``), ``param_shard_axes`` (``:261``),
``gpt_small`` (``:296``), ``gpt_tiny`` (``:307``),
``packed_token_cross_entropy`` (``:317``) and ``token_cross_entropy``
(``:339``).  ``attn_impl`` "flash" (kernel B2, ``ops/flash.py``),
"full", "ring" (``parallel/ring_attention.py``) or "ulysses"
(``parallel/ulysses.py``, with B2 inside at ``[B, T_global, H/sp, D]``).
Every ``moe_every``-th block's FFN is a ``parallel.moe.MoELayer`` (its
experts sharded over ``ep_axis``), and ``remat=True`` recomputes each
block in the backward (``torch.utils.checkpoint``, the counterpart of
``nn.remat(Block)``), so B2's forward runs twice per block per step.

The model, its layers and ``parallel.sync_gradients`` take a
``parallel.Mesh`` where the JAX model reads the axes ``shard_map`` binds:
``mesh=None`` is the single-device model.  Over a mesh the qkv, proj
and MLP layers are tensor-parallel over ``tp_axis`` (this rank holds
heads ``r·H/tp:(r+1)·H/tp``; qkv's local columns in ``[3, H/tp, D]``
order), the tokens are this rank's block of the sequence over
``sp_axis`` (positions offset by the block's index), and the model
raises every error the JAX one raises: heads not divisible by tp,
packed rows with ring/ulysses or over sp > 1, flash/full on an sp axis
of size > 1, a global length over ``max_len``.  Over an ``ep`` axis each
rank holds ``num_experts_local`` experts of the ``ep · num_experts_local``
that a layer routes to (:func:`shard_of`).

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
from torch.utils.checkpoint import checkpoint

from ..ops.flash import flash_attention
from ..parallel.mesh import EP_AXIS, SP_AXIS, TP_AXIS, Mesh
from ..parallel.moe import MoELayer
from ..parallel.ring_attention import full_attention, ring_attention
from ..parallel.tensor import (
    ColumnParallelDense,
    RowParallelDense,
    TensorParallelMLP,
    axis_degree,
    lecun_normal_,
)
from ..parallel.ulysses import ulysses_attention


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
    attn_impl: str = "flash"     # "flash" | "full" | "ring" | "ulysses"
    sp_axis: str = SP_AXIS
    tp_axis: str = TP_AXIS
    remat: bool = False          # recompute each block in the backward
    # MoE (0: dense FFN everywhere; else every moe_every-th block):
    moe_every: int = 0
    num_experts_local: int = 1
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    ep_axis: str = EP_AXIS

    def check(self) -> None:
        """Raise for an unknown ``attn_impl``."""
        if self.attn_impl not in ("flash", "full", "ring", "ulysses"):
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r}; expected 'flash', "
                "'full', 'ring', or 'ulysses'"
            )


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
    """Multi-head self-attention: tp-sharded qkv and output projections,
    and flash, full, ring or Ulysses attention."""

    def __init__(self, cfg: TransformerConfig, mesh: Optional[Mesh] = None):
        super().__init__()
        cfg.check()
        self.cfg = cfg
        self.mesh = mesh
        tp = axis_degree(mesh, cfg.tp_axis)
        if cfg.num_heads % tp != 0:
            raise ValueError(
                f"num_heads {cfg.num_heads} not divisible by tp degree {tp}"
            )
        self.h_local = cfg.num_heads // tp
        width = cfg.num_heads * cfg.head_dim
        self.qkv = ColumnParallelDense(cfg.model_dim, 3 * width, cfg.tp_axis,
                                       dtype=cfg.dtype, mesh=mesh)
        self.proj = RowParallelDense(width, cfg.model_dim, cfg.tp_axis,
                                     dtype=cfg.dtype, mesh=mesh)

    def forward(self, x: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, self.h_local, cfg.head_dim)
        q, k, v = qkv.unbind(2)  # strided views: B2 reads them in place
        if segment_ids is not None and cfg.attn_impl not in ("flash", "full"):
            raise ValueError(
                "packed sequences (segment_ids) require attn_impl='flash' "
                "or 'full'; sequence-parallel impls do not support packing"
            )
        sp_present = mesh is not None and mesh.present(cfg.sp_axis)
        # With the sp axis absent the sequence is unsharded: full
        # attention is the lowering of every impl, as in the JAX model.
        if cfg.attn_impl == "ring" and sp_present:
            out = ring_attention(q, k, v, mesh, cfg.sp_axis, causal=cfg.causal)
        elif cfg.attn_impl == "ulysses" and sp_present:
            # B2 over the whole sequence, a fraction of the heads.
            out = ulysses_attention(q, k, v, mesh, cfg.sp_axis, causal=cfg.causal,
                                    attn_fn=flash_attention)
        elif sp_present and mesh.axis_size(cfg.sp_axis) > 1:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} is shard-local but the "
                f"sequence axis {cfg.sp_axis!r} is present in the mesh; "
                "use attn_impl='ring' or 'ulysses' for sequence parallelism"
            )
        elif cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, cfg.causal, segment_ids=segment_ids)
        else:
            out = full_attention(q, k, v, causal=cfg.causal,
                                 segment_ids=segment_ids)
        return self.proj(out.reshape(b, t, self.h_local * cfg.head_dim))


class Block(nn.Module):
    """Pre-LN transformer block; the FFN is the tensor-parallel dense MLP,
    or with ``use_moe`` a ``MoELayer`` of ``experts_local`` experts
    (default ``cfg.num_experts_local``) of width ``ff_dim //
    num_experts_local``."""

    def __init__(self, cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                 use_moe: bool = False, experts_local: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.model_dim)
        self.attn = Attention(cfg, mesh)
        self.ln_mlp = LayerNorm(cfg.model_dim)
        if use_moe:
            self.moe = MoELayer(cfg.model_dim, experts_local or cfg.num_experts_local,
                                cfg.ff_dim // max(1, cfg.num_experts_local), k=cfg.moe_k,
                                capacity_factor=cfg.moe_capacity_factor,
                                axis=cfg.ep_axis, dtype=cfg.dtype, mesh=mesh)
        else:
            self.mlp = TensorParallelMLP(cfg.model_dim, cfg.ff_dim, cfg.model_dim,
                                         cfg.tp_axis, dtype=cfg.dtype, mesh=mesh)

    def forward(self, x: torch.Tensor, segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.cfg.dtype
        x = x + self.attn(self.ln_attn(x).to(dtype), segment_ids)
        h = self.ln_mlp(x).to(dtype)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
        else:
            y, aux = self.mlp(h), torch.zeros((), device=x.device)
        return x + y.to(x.dtype), aux


class Transformer(nn.Module):
    """Decoder-only LM: int token ids ``[B, T_local]`` (and optional
    packed ``segment_ids``) -> ``(logits [B, T_local, vocab] float32, aux
    loss)``; ``T_local = T_global / sp`` over a mesh with a sequence axis.
    Weights are drawn from ``seed`` on the CPU with flax's initialisers
    at full width (over a tensor- or expert-parallel mesh this rank keeps
    its shard of them, :func:`load_jax_params`'s slicing; the full width
    of an MoE layer over ``ep`` is ``ep · num_experts_local`` experts,
    ``experts_local`` of the mesh-free draw), then moved to ``device``."""

    def __init__(self, cfg: TransformerConfig, *, seed: int = 0, device="cuda",
                 mesh: Optional[Mesh] = None, experts_local: Optional[int] = None):
        super().__init__()
        cfg.check()
        self.cfg = cfg
        self.mesh = mesh
        self.wte = Embed(cfg.vocab_size, cfg.model_dim)
        self.wpe = nn.Parameter(torch.empty(cfg.max_len, cfg.model_dim))
        for i in range(cfg.num_layers):
            use_moe = cfg.moe_every > 0 and (i + 1) % cfg.moe_every == 0
            self.add_module(f"block_{i}", Block(cfg, mesh, use_moe, experts_local))
        self.ln_f = LayerNorm(cfg.model_dim)
        ep = axis_degree(mesh, cfg.ep_axis) if cfg.moe_every > 0 else 1
        if axis_degree(mesh, cfg.tp_axis) > 1 or ep > 1:
            full = Transformer(cfg, seed=seed, device="cpu",
                               experts_local=ep * cfg.num_experts_local)
            _copy_full(self, {n: p.detach() for n, p in full.named_parameters()})
        else:
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                self.wte.embedding.normal_(0.0, 0.02, generator=g)
                self.wpe.normal_(0.0, 0.02, generator=g)
                for name, p in self.named_parameters():
                    if name.endswith(".kernel") and ".moe." not in name:
                        lecun_normal_(p, g)
                for module in self.modules():
                    if isinstance(module, MoELayer):
                        module.reset_parameters(g)
        self.to(device)

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, mesh = self.cfg, self.mesh
        b, t = tokens.shape
        x = self.wte(tokens)
        # Positions are global: offset by this rank's block of the
        # sequence when it is sharded over sp.
        pos = torch.arange(t, device=tokens.device)
        t_global = t
        if mesh is not None and mesh.present(cfg.sp_axis):
            sp = mesh.axis_size(cfg.sp_axis)
            if segment_ids is not None and sp > 1:
                raise ValueError(
                    "packed sequences cannot be sequence-sharded; drop "
                    "the sp axis or the segment_ids"
                )
            t_global = t * sp
            pos = pos + mesh.axis_index(cfg.sp_axis) * t
        if t_global > cfg.max_len:
            raise ValueError(
                f"sequence length {t_global} exceeds max_len {cfg.max_len}")
        if segment_ids is not None:
            # Positions restart at each packed document.
            idx = torch.arange(t, device=tokens.device).expand(b, t)
            is_start = torch.cat(
                [torch.ones((b, 1), dtype=torch.bool, device=tokens.device),
                 segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1,
            )
            start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
            x = (x + self.wpe[idx - start]).to(cfg.dtype)
        elif t_global == t:
            x = (x + self.wpe[:t][None]).to(cfg.dtype)
        else:
            x = (x + self.wpe[pos][None]).to(cfg.dtype)
        aux_total = torch.zeros((), device=x.device)
        for i in range(cfg.num_layers):
            block = getattr(self, f"block_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x, aux = checkpoint(block, x, segment_ids, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = block(x, segment_ids)
            aux_total = aux_total + aux
        x = self.ln_f(x)
        # Tied head in the compute dtype, cast up for the float32 loss.
        logits = (x.to(cfg.dtype) @ self.wte.embedding.to(cfg.dtype).t()).float()
        return logits, aux_total


def param_shard_axes(params, cfg: TransformerConfig) -> dict:
    """Each parameter's name -> the space-separated mesh axes it is
    sharded over, for ``parallel.sync_gradients``.  ``params`` is a
    mapping (or iterable) of the model's parameter names, as
    ``dict(model.named_parameters())``.  The JAX model's rules: attention
    qkv (kernel and bias) and proj kernels and the MLP's wi (kernel and
    bias) and wo kernels are tp-sharded; MoE expert weights ep-sharded;
    embeddings, LayerNorms, the row layers' biases and the router are
    replicated."""

    def classify(name: str) -> str:
        parts = name.split(".")
        leaf = parts[-1]
        inside = set(parts[:-1])
        if "moe" in inside:
            return cfg.ep_axis if leaf in ("wi", "wo") else ""
        if "attn" in inside:
            if "qkv" in inside:
                return cfg.tp_axis
            if "proj" in inside and leaf == "kernel":
                return cfg.tp_axis
            return ""
        if "mlp" in inside:
            if "wi" in inside:
                return cfg.tp_axis
            if "wo" in inside and leaf == "kernel":
                return cfg.tp_axis
            return ""
        return ""

    return {name: classify(name) for name in params}


def gpt_small(*, seed: int = 0, device="cuda", mesh: Optional[Mesh] = None,
              **overrides) -> Transformer:
    """GPT-2 small (124M): vocab 50304, 12 layers, width 768, 12 heads of
    64, ff 3072, max_len 1024, bf16 compute."""
    cfg = TransformerConfig(
        vocab_size=50304, num_layers=12, model_dim=768, num_heads=12,
        head_dim=64, ff_dim=3072, max_len=1024,
    )
    return Transformer(dataclasses.replace(cfg, **overrides), seed=seed,
                       device=device, mesh=mesh)


def gpt_tiny(*, seed: int = 0, device="cuda", mesh: Optional[Mesh] = None,
             **overrides) -> Transformer:
    """Tiny float32 config for tests."""
    cfg = TransformerConfig(
        vocab_size=256, num_layers=2, model_dim=64, num_heads=4,
        head_dim=16, ff_dim=128, max_len=256, dtype=torch.float32,
    )
    return Transformer(dataclasses.replace(cfg, **overrides), seed=seed,
                       device=device, mesh=mesh)


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


def shard_of(name: str, full: torch.Tensor, cfg: TransformerConfig, tp: int,
             r: int, ep: int = 1, re: int = 0) -> torch.Tensor:
    """Rank r's shard (of ``tp``) of the full-width parameter ``name``,
    or for an expert weight, the shard of the rank at ``re`` on an ``ep``
    axis of ``ep`` ranks.

    qkv (``[D, 3·H·hd]`` kernel, ``[3·H·hd]`` bias): heads
    ``r·H/tp:(r+1)·H/tp`` of each of q, k and v, the local columns in
    ``[3, H/tp, hd]`` order.  The MLP's ``wi`` (kernel and bias): columns
    ``r·ff/tp:(r+1)·ff/tp``.  The kernels of ``proj`` and of the MLP's
    ``wo``: the rows of those heads / columns.  An MoE layer's ``wi`` and
    ``wo`` (``[E, ...]``): experts ``re·E/ep:(re+1)·E/ep``.  Every other
    parameter (replicated) whole."""
    axes = param_shard_axes([name], cfg)[name].split()
    if cfg.ep_axis in axes:
        n = full.shape[0] // ep
        return full[re * n:(re + 1) * n]
    if tp == 1 or cfg.tp_axis not in axes:
        return full
    parts = name.split(".")
    if "qkv" in parts:
        h, hd = cfg.num_heads, cfg.head_dim
        hl = h // tp
        view = full.reshape(full.shape[:-1] + (3, h, hd))
        return view[..., r * hl:(r + 1) * hl, :].reshape(full.shape[:-1] + (-1,))
    if "wi" in parts:
        n = full.shape[-1] // tp
        return full[..., r * n:(r + 1) * n]
    n = full.shape[0] // tp  # proj and wo kernels: rows
    return full[r * n:(r + 1) * n]


def _copy_full(model: Transformer, flat: Mapping) -> None:
    """Copy full-width parameters (name -> array or tensor) into
    ``model``, each as this rank's shard (:func:`shard_of`)."""
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise KeyError(
            f"flax tree and model differ: only in the tree "
            f"{sorted(set(flat) - set(own))}, only in the model "
            f"{sorted(set(own) - set(flat))}"
        )
    mesh, cfg = model.mesh, model.cfg
    tp, ep = axis_degree(mesh, cfg.tp_axis), axis_degree(mesh, cfg.ep_axis)
    r = 0 if mesh is None else mesh.axis_index(cfg.tp_axis)
    re = 0 if mesh is None else mesh.axis_index(cfg.ep_axis)
    with torch.no_grad():
        for name, p in own.items():
            val = flat[name]
            full = (val.detach().float().cpu() if torch.is_tensor(val)
                    else torch.from_numpy(np.array(val, np.float32)))
            part = shard_of(name, full, cfg, tp, r, ep, re)
            if tuple(part.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(part.shape)} != {tuple(p.shape)}")
            p.copy_(part)


def load_jax_params(model: Transformer, params: Mapping) -> Transformer:
    """Copy the full-width flax tree of numpy arrays
    (``params["params"]["block_0"]["attn"]["qkv"]["Dense_0"]["kernel"]``,
    ...) into ``model``, name for name and without transposes: every
    kernel keeps flax's ``[in, out]``.  Over a tensor-parallel mesh each
    tp-sharded leaf is cut to this rank's shard (:func:`shard_of`: rank r
    of tp takes heads ``r·H/tp:(r+1)·H/tp`` of each of q, k and v in qkv,
    the rows of ``proj`` and ``wo`` and the columns of ``wi`` that go
    with them), over an ``ep`` axis each MoE layer's ``[E, ...]`` expert
    weights to this rank's ``E/ep`` experts, and replicated leaves are
    copied whole.  Raises if the two sets of names differ."""
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
    _copy_full(model, flat)
    return model
