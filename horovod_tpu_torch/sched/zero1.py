"""Bucketed ZeRO-1: the sharded optimizer step cut at bucket granularity.

Counterpart of ``horovod_tpu/sched/zero1.py``.  ``optim/zero.py``
``zero_train_step`` exchanges the whole model as one reduce-scatter, one
sharded update and one all-gather (arXiv:2004.13336).  Here the
gradients are planned into the scheduler's buckets (``sched/plan.py``
``build_schedule``, reverse-backward order), and each bucket is
reduce-scattered, divided by the world, updated on this rank's slice of
it and all-gathered, so a bucket's collectives are the size of the
bucket and the optimizer state still shrinks N-fold: each rank holds
``padded / N`` elements of every bucket.

Per bucket, by its wire and lowering (``_BucketLayout``):

* ``flat`` on the dense wire: ``reduce_scatter_tensor`` over the world,
  the shard times float32(1/N), the update, ``all_gather_into_tensor``;
  the bucket padded to a multiple of N.
* ``flat`` on int8 or fp8: ``ops/quantized.py``
  ``quantized_reduce_scatter`` of ``g + ef`` (kernels B3 and B4, or B6
  on the ring), the error-feedback residual kept in the bucket's state
  when ``HVD_TPU_SCHED_WIRE_EF`` is on; the update runs on the float32
  shard, and ``quantized_all_gather`` of the update (B3 and B5, or B7)
  is the only re-quantization.  The bucket is padded to N times the
  quantization block, so the shard gathers without padding again.
* ``hier`` and ``hier_adasum`` (a multi-domain topology,
  ``HVD_TPU_TOPO``; ``topo/hierarchical.py``): the bucket shards over the
  intra-domain group only, k shards per domain, replicated across the
  domains, so the state shrinks k-fold.  An intra-domain reduce-scatter,
  then the cross-domain hop of the 1/k shard: a sum (``dcn_all_reduce``,
  then 1/N) or, for ``hier_adasum``, Adasum of the domains' means
  (1/k, then ``dcn_adasum``); the bucket's wire compresses only that
  hop, without error feedback.  The update's all-gather stays inside the
  domain, dense.

``pre_update`` (``optim/zero.py`` ``clip_by_global_norm``) sees the list
of every bucket's gradient shard before any update.  The JAX package's
rail pipeliner (``xir/pipeline.py``), which interleaves one bucket's
cross-domain hop with the next one's intra-domain phase, is not ported:
the buckets run in schedule order, which the JAX package states gives
the same bits (``:245-250``).

The port takes an optimizer factory where the JAX package takes an optax
transformation, as ``zero_train_step`` does: ``make_optimizer(shards)``
gets the list of this rank's bucket shards (``nn.Parameter``\\ s, one per
bucket, in the bucket's dtype).  Leaves are flattened in module order
(``named_parameters()``), the JAX package's in sorted key order.  On a
card the step is captured as a CUDA graph under ``HVD_TPU_ONESTEP``
(``optim/distributed_optimizer.py`` ``CapturedStep``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import metrics, runtime
from ..ops.collectives import Sum, _all_gather, _reduce_scatter, f32_reciprocal
from ..ops.quantized import quant_block, quantized_all_gather, quantized_reduce_scatter
from ..optim.distributed_optimizer import CapturedStep, host_state, step_blocker
from ..optim.zero import OptimizerFactory, _world_mean
from .execute import record_wire_metrics
from .plan import QUANTIZED_WIRES, BucketSchedule, SchedConfig, build_schedule, dtype_name

HIER = ("hier", "hier_adasum")


@dataclass(frozen=True)
class _BucketLayout:
    """One bucket's flat buffer: its leaves, their shapes and sizes, the
    valid and padded lengths, this rank's shard length, its wire and
    lowering, and over how many ranks it is sharded (the world, or the
    domain's k for ``hier``/``hier_adasum``)."""

    indices: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]  # elements per member leaf
    dtype: torch.dtype
    n: int  # valid elements
    padded: int  # n rounded up to a multiple of the shard count (times the block)
    shard_len: int
    wire: str = "off"
    lowering: str = "flat"
    shards: int = 0


def _layouts(params: Sequence[torch.Tensor], world: int,
             cfg: SchedConfig) -> Tuple[List[_BucketLayout], BucketSchedule]:
    """The buckets of ``params`` over ``world`` ranks (``:51-93``)."""
    from ..topo import model as topo_model

    sizes_bytes = [p.numel() * p.element_size() for p in params]
    dtypes = [dtype_name(p.dtype) for p in params]
    schedule = build_schedule(sizes_bytes, dtypes, cfg, lowering=cfg.lowering,
                              axis_size=world)
    s_dcn, k_ici = topo_model.current().factor_axis(world)
    layouts = []
    for b in schedule.buckets:
        if len(b.wire_dtypes) != 1:
            raise ValueError(
                "bucketed ZeRO requires single-dtype buckets "
                f"(got {b.wire_dtypes}); pinned mixed-dtype groups are "
                "not supported here"
            )
        sizes = tuple(params[i].numel() for i in b.indices)
        n = sum(sizes)
        lowering = b.lowering if s_dcn > 1 else "flat"
        shards = k_ici if lowering in HIER else world
        unit = shards * quant_block() if b.wire in QUANTIZED_WIRES else shards
        padded = -(-n // unit) * unit
        layouts.append(_BucketLayout(
            indices=b.indices, shapes=tuple(tuple(params[i].shape) for i in b.indices),
            sizes=sizes, dtype=getattr(torch, b.wire_dtypes[0]), n=n, padded=padded,
            shard_len=padded // shards, wire=b.wire, lowering=lowering, shards=shards))
    return layouts, schedule


def bucket_layouts(params: Sequence[torch.Tensor], world: int,
                   cfg: Optional[SchedConfig] = None) -> List[_BucketLayout]:
    """How :func:`bucketed_zero_step` shards the buckets of ``params`` (a
    module's parameters or a list of tensors; shapes and dtypes are all
    it reads) over ``world`` ranks: a function of the parameters'
    metadata, the world and ``cfg`` alone, the same on every rank."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    return _layouts(list(params), world, cfg if cfg is not None else SchedConfig.from_env())[0]


def _bucket_flat(leaves: Sequence[torch.Tensor], layout: _BucketLayout) -> torch.Tensor:
    """The bucket's leaves as one flat buffer, zero-padded to ``padded``."""
    flat = torch.cat([leaves[i].reshape(-1) for i in layout.indices])
    return F.pad(flat, (0, layout.padded - layout.n)) if layout.padded != layout.n else flat


def _bucket_unflat(flat: torch.Tensor, layout: _BucketLayout) -> List[torch.Tensor]:
    """The bucket's leaves (views of ``flat``), in ``indices`` order."""
    out, off = [], 0
    for shape, size in zip(layout.shapes, layout.sizes):
        out.append(flat[off:off + size].view(shape))
        off += size
    return out


class BucketedZeroState:
    """This rank's slice of the optimizer of a replicated model, bucket by
    bucket: ``shards`` (one ``nn.Parameter`` of ``shard_len`` elements
    per bucket), ``optimizer`` (made by the factory over them), ``ef``
    (each quantized flat bucket's float32 error-feedback residual of
    ``padded`` elements, else None) and ``layouts``."""

    def __init__(self, params: List[torch.nn.Parameter], layouts: List[_BucketLayout],
                 make_optimizer: OptimizerFactory, ef_on: Callable[[_BucketLayout], bool]):
        self.params, self.layouts = params, layouts
        pleaves = [p.detach() for p in params]
        with torch.no_grad():
            self.shards = [torch.nn.Parameter(_my_slice(_bucket_flat(pleaves, lay), lay).clone())
                           for lay in layouts]
        self.optimizer = make_optimizer(self.shards)
        dev = params[0].device
        self.ef = [torch.zeros(lay.padded, dtype=torch.float32, device=dev)
                   if ef_on(lay) else None for lay in layouts]


def _shard_index(lay: _BucketLayout) -> int:
    """This rank's shard of the bucket: its rank, or its position in its
    domain for ``hier``/``hier_adasum`` (slice-major ranks)."""
    rank = runtime.rank()
    return rank % lay.shards if lay.lowering in HIER else rank


def _my_slice(flat: torch.Tensor, lay: _BucketLayout) -> torch.Tensor:
    i = _shard_index(lay)
    return flat[i * lay.shard_len:(i + 1) * lay.shard_len]


def bucketed_zero_step(loss_fn: Callable, make_optimizer: OptimizerFactory, *,
                       cfg: Optional[SchedConfig] = None,
                       pre_update: Optional[Callable] = None):
    """The ZeRO-1 step with bucket-granular sharding (``:127``).

    Call convention of ``optim/zero.py`` ``zero_train_step``: ``state =
    step.init(model)`` plans the buckets of the model's parameters (the
    same on every rank) and makes a :class:`BucketedZeroState`; ``model,
    state, loss = step(model, state, batch)`` runs ``loss_fn(model,
    batch)`` and its backward, each bucket's exchange and sharded update
    (module docstring) and returns the loss averaged over the world; the
    model is updated in place.  ``cfg`` (default
    ``SchedConfig.from_env()``: ``HVD_TPU_FUSION_THRESHOLD`` or
    ``HVD_TPU_SCHED_BUCKET_BYTES``, ``HVD_TPU_SCHED_WIRE``,
    ``HVD_TPU_SCHED_WIRE_EF``, ``HVD_TPU_TOPO_LOWER``) is read once, at
    ``init``.  ``step.schedule`` is the plan."""
    if cfg is None:
        cfg = SchedConfig.from_env()

    def _ef_on(lay: _BucketLayout) -> bool:
        # A hier bucket quantizes its domain-summed shard on the
        # cross-domain hop, not the gradient: no residual (:188-195).
        return cfg.wire_ef and lay.wire in QUANTIZED_WIRES and lay.lowering not in HIER

    def reduce_scatter(g: torch.Tensor, lay: _BucketLayout, st: BucketedZeroState,
                       k: int, world: int, ctx) -> torch.Tensor:
        """Bucket ``k``'s float32-or-bucket-dtype gradient shard, averaged."""
        from ..topo import hierarchical

        if lay.lowering in HIER:
            shard = hierarchical.ici_reduce_scatter_phase(g, ctx)
            if lay.lowering == "hier_adasum":
                shard = shard * f32_reciprocal(lay.shards)  # the domain's mean
                return hierarchical.dcn_adasum(shard, wire=lay.wire)
            shard = hierarchical.dcn_all_reduce(shard, wire=lay.wire)
            return shard * f32_reciprocal(world)
        if lay.wire in QUANTIZED_WIRES:
            if st.ef[k] is not None:
                shard, r_new = quantized_reduce_scatter(g.float() + st.ef[k], Sum,
                                                        wire=lay.wire, ef=True)
                st.ef[k].copy_(r_new)  # in place: a replayed graph carries it on
            else:
                shard = quantized_reduce_scatter(g, Sum, wire=lay.wire)
            return shard * f32_reciprocal(world)
        shard = g
        if world > 1:
            shard = g.new_empty((lay.shard_len,))
            _reduce_scatter(shard, g.contiguous(), op=dist.ReduceOp.SUM)
        return shard * f32_reciprocal(world)

    def all_gather(ushard: torch.Tensor, lay: _BucketLayout, world: int,
                   ctx) -> torch.Tensor:
        """The bucket's update, every rank's shard, cut to ``n``."""
        from ..topo import hierarchical

        if lay.lowering in HIER:
            return hierarchical.ici_all_gather_phase(ushard, ctx)[:lay.n]
        if lay.wire in QUANTIZED_WIRES:
            return quantized_all_gather(ushard, wire=lay.wire)[:lay.n].to(lay.dtype)
        if world == 1:
            return ushard[:lay.n]
        out = ushard.new_empty((lay.padded,))
        _all_gather(out, ushard.contiguous())
        return out[:lay.n]

    class _Step(CapturedStep):
        schedule: Optional[BucketSchedule] = None

        def init(self, model: torch.nn.Module) -> BucketedZeroState:
            params = list(model.parameters())
            layouts, self.schedule = _layouts(params, runtime.size(), cfg)
            if any(lay.lowering in HIER for lay in layouts):
                from ..topo import hierarchical

                hierarchical.phase_context()  # the groups, made on every rank now
            metrics.set_gauge("sched.buckets_per_step", len(self.schedule))
            metrics.set_gauge("sched.bytes_per_step", self.schedule.total_bytes)
            metrics.inc_counter("sched.zero_steps_built")
            record_wire_metrics(self.schedule)
            return BucketedZeroState(params, layouts, make_optimizer, _ef_on)

        def __call__(self, model: torch.nn.Module, state: BucketedZeroState, batch):
            self._model, self._state = model, state
            return model, state, self._call(batch)

        def _device(self) -> torch.device:
            return self._state.shards[0].device

        def blocker(self):
            return step_blocker(self._model, self._state.optimizer)

        def _host_key(self) -> tuple:
            return self._model, self._state, host_state(self._state.optimizer)

        def _units(self) -> int:
            return len(self._state.layouts) + 1

        def _step(self, batch) -> torch.Tensor:
            model, st = self._model, self._state
            loss = loss_fn(model, batch)
            loss.backward()
            world = runtime.size()
            ctx = None
            if any(lay.lowering in HIER for lay in st.layouts):
                from ..topo import hierarchical

                ctx = hierarchical.phase_context()
            with torch.no_grad():
                gleaves = [p.grad if p.grad is not None else torch.zeros_like(p)
                           for p in st.params]
                gshards = [reduce_scatter(_bucket_flat(gleaves, lay), lay, st, k, world, ctx)
                           for k, lay in enumerate(st.layouts)]
                if pre_update is not None:
                    gshards = pre_update(gshards)
                pleaves = [p.detach() for p in st.params]
                pshards = [_my_slice(_bucket_flat(pleaves, lay), lay) for lay in st.layouts]
                for shard, pshard, g in zip(st.shards, pshards, gshards):
                    shard.copy_(pshard)
                    shard.grad = g.to(shard.dtype)
                st.optimizer.step()
                for shard, pshard, lay in zip(st.shards, pshards, st.layouts):
                    shard.grad = None
                    uflat = all_gather(shard - pshard, lay, world, ctx)
                    for i, u in zip(lay.indices, _bucket_unflat(uflat, lay)):
                        st.params[i].add_(u.to(st.params[i].dtype))
            model.zero_grad(set_to_none=True)
            return _world_mean(loss)

    return _Step()
