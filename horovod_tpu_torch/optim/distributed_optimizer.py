"""DistributedOptimizer and the data-parallel train step.

Counterpart of ``horovod_tpu/optim/distributed_optimizer.py``:
``DistributedOptimizer`` (``:615``, with the predivide split of
``:648-657``), the scheduler path of ``_reduce_gradients`` and
``TrainStep`` (``:815``, the semantics of ``:907-934``), with the
quantized wire's per-bucket dispatch (``:368-398``, ``:504-524``) and
its error-feedback residuals (``_ef_active`` ``:679-701``).  The API has
the shape of ``horovod_tpu/interop/torch.py`` and the reference's
``horovod.torch``: the wrapper IS-A ``type(optimizer)``, takes
``named_parameters``, and reduces the gradients in ``step()`` (or an
explicit ``synchronize()``) before the wrapped optimizer applies them.

The reduction is the bucketed scheduler: gradients are compressed,
planned into buckets in reverse-backward order (the readiness order the
post-accumulate-grad hooks saw in the first backward, rank 0's copy),
and each bucket is allreduced as one flat buffer per dtype, with a bf16
wire around it when ``HVD_TPU_SCHED_WIRE=bf16``, or exchanged as a
quantized reduce-scatter + all-gather under ``HVD_TPU_SCHED_WIRE=int8``
/ ``fp8`` or ``Compression.int8`` / ``fp8`` (the compressor wins over
the knob).  The collectives run after the backward, not overlapped with
it.

Error feedback (``HVD_TPU_SCHED_WIRE_EF``, default on): when a quantized
wire is requested at construction with the scheduler on, every
parameter gets a float32 residual, zero at first; a quantized bucket
sends ``g + r`` and keeps ``r ← (g + r) − dequant(quantize(g + r))``.
The residuals are rank-local: they are not part of ``state_dict()`` and
``broadcast_optimizer_state`` leaves them alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import runtime
from ..compression import Compression, Compressor
from ..exceptions import QuantizedWireError
from ..ops import collectives, fusion
from ..ops.collectives import Average, Sum
from ..ops.quantized import quantized_allreduce
from ..sched import execute
from ..sched.hooks import GradOrder
from ..sched.plan import (
    QUANTIZED_WIRES,
    BucketSchedule,
    SchedConfig,
    build_schedule,
    dtype_name,
)


class _DistributedOptimizer:
    """Gradient-averaging wrapper around a ``torch.optim.Optimizer``."""

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
        *,
        op: int = Average,
        compression: type[Compressor] = Compression.none,
        backward_passes_per_step: int = 1,
        average_aggregated_gradients: bool = True,
        gradient_predivide_factor: float = 1.0,
        prescale_factor: float = 1.0,
        postscale_factor: float = 1.0,
        fusion_threshold_bytes: Optional[int] = None,
    ):
        cfg = SchedConfig.from_env()
        self._quantized = getattr(compression, "quantized_wire", False)
        quantized_req = self._quantized or (
            cfg.enabled and cfg.wire in QUANTIZED_WIRES
        )
        if op not in (Average, Sum):
            if quantized_req:
                raise QuantizedWireError(
                    "the quantized wire requires op=Average or Sum; unset "
                    "HVD_TPU_SCHED_WIRE or use a cast compressor"
                )
            raise ValueError("DistributedOptimizer supports op=Average or Sum")
        if gradient_predivide_factor != 1.0:
            if op != Average:
                raise ValueError(
                    "gradient_predivide_factor requires op=Average "
                    "(reference torch/optimizer.py:194)"
                )
            # Reference split: prescale by 1/f before the sum, postscale
            # by f/size after.
            prescale_factor = prescale_factor / gradient_predivide_factor
            postscale_factor = postscale_factor * gradient_predivide_factor
        self._k = int(backward_passes_per_step)
        if self._k < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._opt = optimizer
        self._op = op
        self._compression = compression
        self._avg_agg = average_aggregated_gradients
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._fusion_threshold = fusion_threshold_bytes
        self._params: List[torch.Tensor] = [
            p for group in optimizer.param_groups for p in group["params"]
            if p.requires_grad
        ]
        if named_parameters is not None:
            self._check_names(named_parameters)
        # Error-feedback residuals, one float32 tensor per parameter.
        self._residuals: Optional[List[torch.Tensor]] = None
        if cfg.enabled and cfg.wire_ef and quantized_req:
            self._residuals = [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in self._params
            ]
        self._order = (
            GradOrder(self._params)
            if cfg.enabled and cfg.capture_order else None
        )
        self._schedule_key = None
        self._schedule: Optional[BucketSchedule] = None
        self._calls = 0
        self._synchronized = False

    def _check_names(self, named_parameters) -> None:
        """The reference's check: unique names covering every parameter
        the optimizer updates."""
        names, named = set(), set()
        for name, p in named_parameters:
            if name in names:
                raise ValueError(f"named_parameters repeats the name {name!r}")
            names.add(name)
            named.add(id(p))
        missing = sum(id(p) not in named for p in self._params)
        if missing:
            raise ValueError(
                f"named_parameters does not name {missing} of the "
                "optimizer's parameters"
            )

    # Everything not overridden forwards to the wrapped optimizer
    # (param_groups, state, defaults, ...).
    def __getattr__(self, name):
        if name == "_opt":
            raise AttributeError(name)
        return getattr(self._opt, name)

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, state_dict):
        return self._opt.load_state_dict(state_dict)

    def add_param_group(self, group):
        raise NotImplementedError(
            "add_param_group after wrapping is not supported: the exchange "
            "plan covers the parameters given at construction"
        )

    def zero_grad(self, set_to_none: bool = True):
        return self._opt.zero_grad(set_to_none=set_to_none)

    @property
    def accumulating(self) -> bool:
        """True when the last ``step()`` only accumulated gradients
        locally (``backward_passes_per_step``) and applied nothing."""
        return self._calls % self._k != 0

    @property
    def residuals(self) -> Optional[List[torch.Tensor]]:
        """The error-feedback residuals, one per parameter in optimizer
        order (None when error feedback is off)."""
        return self._residuals

    @property
    def schedule(self) -> Optional[BucketSchedule]:
        """The exchange plan of the last reduction (None before it)."""
        return self._schedule

    def _plan(self, sizes, dtypes, cfg: SchedConfig) -> BucketSchedule:
        observed = self._order.consume() if self._order is not None else None
        key = (tuple(sizes), tuple(dtypes), cfg)
        if self._schedule is not None and key == self._schedule_key:
            return self._schedule
        if cfg.enabled:
            # Every rank plans from rank 0's observation, so all ranks
            # issue the same collectives in the same order.  An explicit
            # quantized compressor wins over HVD_TPU_SCHED_WIRE.
            order = runtime.broadcast_object(observed, root_rank=0)
            wire = self._compression.wire_format if self._quantized else None
            schedule = build_schedule(sizes, dtypes, cfg, order=order,
                                      wire=wire)
        else:
            # HVD_TPU_SCHED=off: in-order buckets on the dense wire.
            schedule = build_schedule(
                sizes, dtypes,
                dataclasses.replace(cfg, bucket_bytes=self._fusion_threshold),
                order=range(len(sizes)), wire="off",
            )
        self._schedule_key, self._schedule = key, schedule
        return schedule

    def synchronize(self) -> None:
        """Reduce every gradient across ranks, in place."""
        grads = [
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in self._params
        ]
        compressed = [self._compression.compress(g) for g in grads]
        wire = [c[0] for c in compressed]
        cfg = SchedConfig.from_env()
        if cfg.bucket_bytes is None and self._fusion_threshold is not None:
            cfg = dataclasses.replace(
                cfg, bucket_bytes=self._fusion_threshold
            )
        # One wire byte per element under a quantized compressor, so
        # buckets fill to the intended wire-size threshold.
        schedule = self._plan(
            [w.numel() * (1 if self._quantized else w.element_size())
             for w in wire],
            [dtype_name(w.dtype) for w in wire],
            cfg,
        )

        def dense(f):
            if self._quantized and f.is_floating_point():
                # Compression.int8/fp8 on a bucket the plan left "off"
                # (or HVD_TPU_SCHED=off): quantized, without residuals.
                g = f if self._prescale == 1.0 else f * self._prescale
                g = quantized_allreduce(
                    g, self._op, wire=self._compression.wire_format
                )
                return g if self._postscale == 1.0 else g * self._postscale
            return collectives.allreduce_(
                f, self._op, self._prescale, self._postscale
            )

        bf16 = execute.bf16_wire(dense)

        def reduce_bucket(f, bucket):
            if bucket.wire in QUANTIZED_WIRES:
                return self._quantized_bucket(f, bucket)
            return bf16(f) if bucket.wire == "bf16" else dense(f)

        reduced = execute.exchange(wire, schedule, reduce_bucket)
        with torch.no_grad():
            for p, t, (_, ctx) in zip(self._params, reduced, compressed):
                out = self._compression.decompress(t, ctx)
                if p.grad is None:
                    p.grad = out.to(p.dtype).clone()
                else:
                    p.grad.copy_(out)
        self._synchronized = True

    def _quantized_bucket(self, f: torch.Tensor, bucket) -> torch.Tensor:
        """The quantized exchange of one bucket's flat buffer, threading
        the bucket's residuals through it when error feedback is on."""
        res_flat = None
        if self._residuals is not None:
            flats, rmeta = fusion.flatten_group(
                [self._residuals[i] for i in bucket.indices]
            )
            res_flat = flats[0]
        out, r_new = execute.quantized_exchange_flat(
            f, average=self._op == Average, wire=bucket.wire,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale, residual=res_flat,
        )
        if r_new is not None:
            for i, r in zip(bucket.indices,
                            fusion.unflatten_group([r_new], rmeta)):
                self._residuals[i].copy_(r)
        return out

    def step(self, closure=None):
        self._calls += 1
        if self.accumulating:
            return None  # no reduce, no apply
        if self._k > 1 and self._avg_agg:
            with torch.no_grad():
                for p in self._params:
                    if p.grad is not None:
                        p.grad.mul_(1.0 / self._k)
        if not self._synchronized:
            self.synchronize()
        self._synchronized = False
        return self._opt.step(closure)


def DistributedOptimizer(
    optimizer: torch.optim.Optimizer,
    named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
    **kwargs,
):
    """Wrap ``optimizer`` so ``step()`` first averages the gradients
    across ranks (keyword arguments as :class:`_DistributedOptimizer`).

    The returned object IS-A ``type(optimizer)``, so
    ``isinstance(opt, torch.optim.Optimizer)`` holds; its own
    ``Optimizer.__init__`` never runs and all state lives in the wrapped
    instance."""
    cls = type(
        "Distributed" + type(optimizer).__name__,
        (_DistributedOptimizer, type(optimizer)),
        {},
    )
    obj = cls.__new__(cls)
    _DistributedOptimizer.__init__(obj, optimizer, named_parameters, **kwargs)
    return obj


def _pmean_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor by its mean across ranks (sum, then times
    float32(1/size), as ``lax.pmean`` compiles), through one fused
    buffer per dtype.  Identity in a world of one."""
    size = runtime.size()
    if size == 1 or not tensors:
        return
    flats, meta = fusion.flatten_group(tensors)
    for f in flats:
        dist.all_reduce(f, op=dist.ReduceOp.SUM)
        f.mul_(collectives.f32_reciprocal(size))
    for t, r in zip(tensors, fusion.unflatten_group(flats, meta)):
        t.copy_(r)


class TrainStep:
    """One data-parallel training step on this rank's batch:
    forward + backward, gradient exchange and optimizer update
    (``optimizer.step()``), then the loss and the model's floating
    buffers (BatchNorm running statistics) averaged across ranks, so
    every rank keeps identical running statistics.  Normalisation inside
    the step still uses each rank's local batch moments.

    ``loss_fn(model, batch) -> loss``.  ``step(batch)`` returns the
    averaged loss as a detached tensor.  Gradients are cleared after
    each step that applied an update, so with
    ``backward_passes_per_step=k`` they accumulate over k calls."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Callable[[torch.nn.Module, object], torch.Tensor]):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def __call__(self, batch) -> torch.Tensor:
        self.model.train()
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        self.optimizer.step()
        if not getattr(self.optimizer, "accumulating", False):
            self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            loss = loss.detach().clone()
            stats = [b for b in self.model.buffers() if b.is_floating_point()]
            _pmean_([loss] + stats)
        return loss
