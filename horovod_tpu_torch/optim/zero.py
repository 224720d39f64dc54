"""ZeRO-1 and FSDP: optimizer state, and with FSDP the parameters too, held
as one 1/N slice of the flattened parameter vector on each rank.

Counterpart of ``horovod_tpu/optim/zero.py``: ``global_norm`` and
``clip_by_global_norm`` (``:39-68``), the sharded optimizer
(``sharded_gradient_transformation``, ``:84-190``), ``zero_train_step``
(``:193-280``), ``_flat_layout`` (``:292``) and ``fsdp_train_step``
(``:357-506``).  Per step the gradients are reduce-scattered (each rank
receives the sum of its slice, divided by the world), the optimizer
updates the slice, and an all-gather assembles the full vector: one
allreduce's bytes, with the optimizer's state N times smaller.

Where the JAX package takes an optax transformation, these take an
optimizer factory applied to this rank's flat shard, a one-element list
holding a float32 ``nn.Parameter``: ``lambda p: torch.optim.AdamW(p,
lr=1e-3)``.  Sharding over the flat vector is exact for elementwise
optimizers (SGD, momentum, Adam(W), RMSprop); a transformation across
parameters sees its shard only, which :func:`clip_by_global_norm` (a
``pre_update`` hook) closes for global-norm clipping.

The dense wire is ``reduce_scatter_tensor`` and ``all_gather_into_tensor``
on the world's group, the shards padded to a multiple of the world.  On
the int8 or fp8 wire (ZeRO-1's ``wire=``, or ``HVD_TPU_SCHED_WIRE``) the
two collectives are ``ops/quantized.py`` ``quantized_reduce_scatter``
(kernels B3 and B4, or B6 on the ring) and ``quantized_all_gather`` (B3
and B5, or B7), the shards padded to the world times the quantization
block, and the error-feedback residual of the reduce-scatter is held
with the optimizer (``HVD_TPU_SCHED_WIRE_EF``, default on).

On a card both steps are captured as CUDA graphs under
``HVD_TPU_ONESTEP`` (default ``auto``), as ``TrainStep`` captures the
data-parallel step (``optim/distributed_optimizer.py`` ``CapturedStep``,
the counterpart of the JAX package compiling each step whole): two eager
warm-up steps, then one graph per batch signature, replayed for every
later call, bitwise with the eager step.  The graphs hold the model, the
optimizer state and their tensors fixed: a call with another model,
state or shard, or a changed hyperparameter (``host_state``), captures
anew.  Every tensor the step carries from one call to the next is
updated in place (the parameters, the shards, the optimizer's state, the
error-feedback residual), so a replay carries it on.  An optimizer whose
update reads its step count on the host (``torch.optim.AdamW`` without
``capturable=True``), a gloo group or an armed fault plan blocks the
capture (``capture_blocker``): ``auto`` then runs eagerly and ``on``
raises.

The port flattens parameters in module order (``named_parameters()``);
the JAX package in the sorted order of the pytree's keys.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import runtime
from ..ops.collectives import _all_gather as all_gather_into
from ..ops.collectives import _reduce_scatter as reduce_scatter_into
from .distributed_optimizer import CapturedStep, host_state, step_blocker

OptimizerFactory = Callable[[list], torch.optim.Optimizer]


def _world() -> Tuple[int, int]:
    rt = runtime.get_runtime()
    return rt.size, rt.rank


def global_norm(shards) -> torch.Tensor:
    """The L2 norm of a flat vector sharded over the world (one shard, or
    a list of them): each rank's sum of squares, summed over the world,
    then the square root.  Zero padding leaves it unchanged."""
    leaves = [shards] if torch.is_tensor(shards) else list(shards)
    sq = sum(torch.sum(torch.square(s)) for s in leaves)
    if _world()[0] > 1:
        dist.all_reduce(sq, op=dist.ReduceOp.SUM)
    return torch.sqrt(sq)


def clip_by_global_norm(max_norm: float) -> Callable:
    """A ``pre_update`` hook that scales every shard by ``max_norm / norm``
    where the global norm exceeds ``max_norm``: ``optax.clip_by_global_norm``
    on sharded gradients.  Takes one shard or a list of them."""

    def hook(shards):
        single = torch.is_tensor(shards)
        leaves = [shards] if single else list(shards)
        norm = global_norm(leaves)
        scale = torch.where(norm > max_norm, max_norm / torch.clamp(norm, min=1e-16),
                            torch.ones_like(norm))
        out = [s * scale.to(s.dtype) for s in leaves]
        return out[0] if single else out

    return hook


def _resolve_wire(wire: Optional[str]) -> Tuple[str, bool]:
    """None follows ``HVD_TPU_SCHED_WIRE`` and ``HVD_TPU_SCHED_WIRE_EF``;
    an explicit value pins the wire."""
    from ..sched.plan import SchedConfig

    cfg = SchedConfig.from_env()
    w = ((cfg.wire if wire is None else wire) or "off").strip().lower()
    return ("off" if w in ("none", "") else w), cfg.wire_ef


def _padded(n: int, unit: int) -> int:
    return -(-n // unit) * unit


class ShardedOptimizer:
    """This rank's slice of the optimizer of a replicated model
    (``sharded_gradient_transformation``).

    ``params`` (module order) are replicated on every rank.  The
    optimizer made by ``make_optimizer`` holds only ``shard``, this
    rank's ``padded / N`` elements of the flattened float32 parameters.
    :meth:`step` reduce-scatters the parameters' ``.grad`` (their
    average over the world), applies ``pre_update`` to the shard of the
    gradient, steps the optimizer on the shard, and all-gathers the
    slices' updates into every parameter.  ``wire="int8"``/``"fp8"``
    puts both collectives on the quantized wire, with the reduce-scatter's
    error-feedback residual in ``ef``; None follows
    ``HVD_TPU_SCHED_WIRE``, ``"off"`` pins the dense wire."""

    def __init__(self, params: Iterable[torch.nn.Parameter], make_optimizer: OptimizerFactory,
                 *, pre_update: Optional[Callable] = None, wire: Optional[str] = None):
        self.params = list(params)
        self.wire, wire_ef = _resolve_wire(wire)
        self.quantized = self.wire in ("int8", "fp8")
        self.pre_update = pre_update
        self.world, self.rank = _world()
        unit = self.world
        if self.quantized:
            # The shards stay block-aligned, so the all-gather re-quantizes
            # them without padding again.
            from ..ops.quantized import quant_block

            unit = self.world * quant_block()
        self.n = sum(p.numel() for p in self.params)
        self.padded = _padded(self.n, unit)
        self.shard_len = self.padded // self.world
        with torch.no_grad():
            mine = self._my_slice(self._flat([p.detach() for p in self.params]))
        self.shard = torch.nn.Parameter(mine.clone())
        self.optimizer = make_optimizer([self.shard])
        dev = self.shard.device
        self.ef = (torch.zeros(self.padded, dtype=torch.float32, device=dev)
                   if self.quantized and wire_ef else None)

    def _flat(self, tensors) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        return F.pad(flat, (0, self.padded - self.n))

    def _my_slice(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.rank * self.shard_len:(self.rank + 1) * self.shard_len]

    def _reduce_scatter(self, gflat: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            from ..ops.collectives import Sum
            from ..ops.quantized import quantized_reduce_scatter

            if self.ef is not None:
                gshard, ef = quantized_reduce_scatter(
                    gflat + self.ef, Sum, wire=self.wire, ef=True)
                self.ef.copy_(ef)  # in place: a replayed graph carries it on
            else:
                gshard = quantized_reduce_scatter(gflat, Sum, wire=self.wire)
        elif self.world > 1:
            gshard = torch.empty(self.shard_len, dtype=gflat.dtype, device=gflat.device)
            reduce_scatter_into(gshard, gflat, op=dist.ReduceOp.SUM)
        else:
            gshard = gflat
        return gshard / self.world

    def _all_gather(self, ushard: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            from ..ops.quantized import quantized_all_gather

            return quantized_all_gather(ushard, wire=self.wire)[:self.n].to(ushard.dtype)
        if self.world == 1:
            return ushard[:self.n]
        out = torch.empty(self.padded, dtype=ushard.dtype, device=ushard.device)
        all_gather_into(out, ushard.contiguous())
        return out[:self.n]

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as zero)."""
        gflat = self._flat([p.grad if p.grad is not None else torch.zeros_like(p)
                            for p in self.params])
        gshard = self._reduce_scatter(gflat)
        pshard = self._my_slice(self._flat([p.detach() for p in self.params]))
        if self.pre_update is not None:
            gshard = self.pre_update(gshard)
        self.shard.copy_(pshard)
        self.shard.grad = gshard.to(self.shard.dtype)
        self.optimizer.step()
        self.shard.grad = None
        uflat = self._all_gather(self.shard - pshard)
        off = 0
        for p in self.params:
            p.add_(uflat[off:off + p.numel()].view_as(p).to(p.dtype))
            off += p.numel()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def _world_mean(loss: torch.Tensor) -> torch.Tensor:
    """``lax.pmean(loss)`` over the world."""
    world = _world()[0]
    loss = loss.detach().reshape(1).clone()
    if world > 1:
        dist.all_reduce(loss, op=dist.ReduceOp.SUM)
    return (loss / world)[0]


def zero_train_step(loss_fn: Callable, make_optimizer: OptimizerFactory, *,
                    pre_update: Optional[Callable] = None, wire: Optional[str] = None):
    """The step with ZeRO-1 sharded optimizer state.

    ``loss_fn(model, batch)`` on this rank's batch.  ``state =
    step.init(model)`` makes the :class:`ShardedOptimizer` (the model's
    parameters replicated: the same on every rank); ``model, state, loss
    = step(model, state, batch)`` runs the forward and backward, the
    sharded update (``pre_update`` and ``wire`` as there) and returns the
    loss averaged over the world.  The model is updated in place.  On a
    card the step is captured (module docstring)."""

    class _Step(CapturedStep):
        def init(self, model: torch.nn.Module) -> ShardedOptimizer:
            return ShardedOptimizer(model.parameters(), make_optimizer,
                                    pre_update=pre_update, wire=wire)

        def __call__(self, model, opt_state: ShardedOptimizer, batch):
            self._model, self._state = model, opt_state
            return model, opt_state, self._call(batch)

        def _device(self) -> torch.device:
            return self._state.shard.device

        def blocker(self):
            return step_blocker(self._model, self._state.optimizer)

        def _host_key(self) -> tuple:
            return self._model, self._state, host_state(self._state.optimizer)

        def _units(self) -> int:
            return 2  # the exchange and the update

        def _step(self, batch) -> torch.Tensor:
            loss = loss_fn(self._model, batch)
            loss.backward()
            self._state.step()
            self._state.zero_grad()
            return _world_mean(loss)

    return _Step()


ParamsLike = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _named(params_like: ParamsLike) -> Dict[str, torch.Tensor]:
    if isinstance(params_like, torch.nn.Module):
        return dict(params_like.named_parameters())
    return dict(params_like)


def _flat_layout(params_like: ParamsLike, world: int):
    """(n, padded, shard_len, ravel, unravel) of a mapping of names to
    tensors, in its order (a module: ``named_parameters()``).  Shapes and
    dtypes are all it reads, so meta tensors give the layout for a
    restore without full parameters.  ``ravel`` concatenates the leaves
    as float32; ``unravel`` gives each its shape and dtype back (views of
    the flat vector where the dtype is float32)."""
    named = _named(params_like)
    names = list(named)
    shapes = [tuple(named[k].shape) for k in names]
    dtypes = [named[k].dtype for k in names]
    sizes = [named[k].numel() for k in names]
    n = sum(sizes)
    padded = _padded(n, world)

    def ravel(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([tree[k].reshape(-1).float() for k in names])

    def unravel(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for k, sh, dt, sz in zip(names, shapes, dtypes, sizes):
            out[k] = flat[off:off + sz].view(sh).to(dt)
            off += sz
        return out

    return n, padded, padded // world, ravel, unravel


def fsdp_train_step(loss_fn: Callable, make_optimizer: OptimizerFactory, *,
                    example_params: Optional[ParamsLike] = None, compression=None):
    """The ZeRO-3 (FSDP) step: parameters and optimizer state both live as
    1/N flat shards between steps.

    Per step one all-gather rebuilds the full parameter vector for the
    forward and backward, one reduce-scatter takes the gradients straight
    to the shards (their average over the world), and the optimizer
    updates this rank's slice.  ``loss_fn(params, batch)`` takes a
    mapping of names to tensors (``torch.func.functional_call`` runs a
    module on it) and this rank's batch.  Call convention::

        step = fsdp_train_step(loss_fn, lambda p: torch.optim.AdamW(p, lr=1e-3))
        pshard, opt = step.init(dict(model.named_parameters()))
        pshard, opt, loss = step(pshard, opt, batch)   # loss: world mean
        params = step.gather(pshard)                    # eval / checkpoint

    To restore shards without full parameters, give the layout up front:
    ``example_params`` is a mapping of names to tensors of the right
    shapes and dtypes (a module on the ``meta`` device, or its
    ``named_parameters()``).  ``compression`` (``Compression.bf16``, ...)
    wraps the reduce-scatter.  On a card the step is captured (module
    docstring)."""
    world, rank = _world()
    meta: dict = {}

    def _set_layout(params_like):
        (meta["n"], meta["padded"], meta["shard_len"], meta["ravel"],
         meta["unravel"]) = _flat_layout(params_like, world)

    if example_params is not None:
        _set_layout(example_params)

    def _layout() -> dict:
        if "unravel" not in meta:
            raise RuntimeError(
                "fsdp_train_step: parameter layout unknown — call init(params) "
                "first, or construct with example_params=(a meta-device model, "
                "or its named_parameters()) when restoring shards from a checkpoint"
            )
        return meta

    def _gather_flat(pshard: torch.Tensor) -> torch.Tensor:
        m = _layout()
        if world == 1:
            return pshard[:m["n"]]
        out = torch.empty(m["padded"], dtype=pshard.dtype, device=pshard.device)
        all_gather_into(out, pshard.contiguous())
        return out[:m["n"]]

    def _reduce_scatter(x: torch.Tensor) -> torch.Tensor:
        if world == 1:
            return x
        out = torch.empty(x.numel() // world, dtype=x.dtype, device=x.device)
        reduce_scatter_into(out, x.contiguous(), op=dist.ReduceOp.SUM)
        return out

    class _Step(CapturedStep):
        def init(self, params: ParamsLike) -> Tuple[torch.nn.Parameter, torch.optim.Optimizer]:
            _set_layout(params)
            m = _layout()
            with torch.no_grad():
                flat = F.pad(m["ravel"](_named(params)).detach(), (0, m["padded"] - m["n"]))
                pshard = torch.nn.Parameter(
                    flat[rank * m["shard_len"]:(rank + 1) * m["shard_len"]].clone())
            return pshard, make_optimizer([pshard])

        def __call__(self, pshard: torch.nn.Parameter, opt: torch.optim.Optimizer, batch):
            self._pshard, self._opt = pshard, opt
            return pshard, opt, self._call(batch)

        def _device(self) -> torch.device:
            return self._pshard.device

        def blocker(self):
            return step_blocker(None, self._opt)

        def _host_key(self) -> tuple:
            return self._opt, self._pshard.data_ptr(), host_state(self._opt)

        def _units(self) -> int:
            return 3  # the all-gather, the reduce-scatter and the update

        def _step(self, batch) -> torch.Tensor:
            pshard, opt, m = self._pshard, self._opt, _layout()
            pfull = _gather_flat(pshard.detach()).detach().requires_grad_()
            loss = loss_fn(m["unravel"](pfull), batch)
            (gflat,) = torch.autograd.grad(loss, pfull)
            gflat = F.pad(gflat, (0, m["padded"] - m["n"]))
            if compression is not None:
                wire, ctx = compression.compress(gflat)
                gshard = compression.decompress(_reduce_scatter(wire), ctx) / world
            else:
                gshard = _reduce_scatter(gflat) / world
            pshard.grad = gshard.to(pshard.dtype)
            opt.step()
            opt.zero_grad(set_to_none=True)
            return _world_mean(loss)

        def gather(self, pshard: torch.Tensor) -> Dict[str, torch.Tensor]:
            with torch.no_grad():
                return _layout()["unravel"](_gather_flat(pshard.detach()))

    return _Step()
