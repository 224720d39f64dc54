"""DistributedOptimizer and the data-parallel train step.

Counterpart of ``horovod_tpu/optim/distributed_optimizer.py``:
``DistributedOptimizer`` (``:615``, with the predivide split of
``:648-657``, ``groups`` and ``sparse_as_dense`` of ``:209-224`` and
``:306-315``), the scheduler path of ``_reduce_gradients`` and
``TrainStep`` (``:815``, the semantics of ``:907-934``), with the
quantized wire's per-bucket dispatch (``:368-398``, ``:504-524``) and
its error-feedback residuals (``_ef_active`` ``:679-701``).  The API has
the shape of ``horovod_tpu/interop/torch.py`` and the reference's
``horovod.torch``: the wrapper IS-A ``type(optimizer)``, takes
``named_parameters``, reduces the gradients in ``step()`` (or an
explicit ``synchronize()``) before the wrapped optimizer applies them,
and has ``skip_synchronize()`` and ``set_backward_passes_per_step``
(``interop/torch.py:656-686``).

The reduction is the bucketed scheduler: gradients are compressed,
planned into buckets in reverse-backward order (the readiness order the
post-accumulate-grad hooks saw in the first backward, rank 0's copy),
and each bucket is allreduced as one flat buffer per dtype, with a bf16
wire around it when ``HVD_TPU_SCHED_WIRE=bf16``, or exchanged as a
quantized reduce-scatter + all-gather under ``HVD_TPU_SCHED_WIRE=int8``
/ ``fp8`` or ``Compression.int8`` / ``fp8`` (the compressor wins over
the knob).

Overlap (``HVD_TPU_SCHED_BARRIERS=1`` with the scheduler on; off by
default, see ``sched/plan.py`` ``SchedConfig``): from the second step,
each bucket is launched from the backward, as soon as its last gradient
has been accumulated and every earlier bucket of the schedule has been
launched (``sched/hooks.py`` ``ScheduleLauncher``), so every rank
issues the same collectives in the same order.  The hook only queues
the bucket: it runs on the exchange worker thread (``sched/execute.py``
``BucketChain``), on a card on the exchange stream, while the backward
goes on.  The first step exchanges after its backward: its plan needs
rank 0's observed order, a host collective, and every other host
collective of the exchange (the ring's window, the peer-access check)
is made there too, so none runs inside a hook.  ``step()`` /
``synchronize()`` launch, in schedule order, the buckets whose hooks
never fired (a parameter without a gradient sends zeros), wait for
every bucket and copy the results into ``p.grad``.  With the barriers
off, or ``HVD_TPU_SCHED=off``, the exchange runs after the backward.
Either way each bucket computes the same bits.  A second backward
before ``step()`` (more than ``backward_passes_per_step``) raises from
its hooks, as the reference's does; ``zero_grad()`` first finishes and
drops an exchange the backward launched.  The launch counters and
``residuals`` are complete once ``step()`` has returned.

Error feedback (``HVD_TPU_SCHED_WIRE_EF``, default on): when a quantized
wire is requested at construction with the scheduler on, every
parameter gets a float32 residual, zero at first; a quantized bucket
sends ``g + r`` and keeps ``r ← (g + r) − dequant(quantize(g + r))``,
written back when the bucket's result is used (``step()`` /
``synchronize()``); a result dropped (``skip_synchronize()`` without
``synchronize()``, ``zero_grad()``) leaves them as they were.  The residuals are rank-local: they
are not part of ``state_dict()`` and ``broadcast_optimizer_state``
leaves them alone.

Process sets (``process_set=``, ``:625``): on the dense wires (plain and
bf16) the set's members average over the set's group, and a non-member
keeps its own gradient, launching nothing (the JAX package's masked
``jnp.where(mask, y, x)``, ``traced.py:397-399``); on the quantized
wires every rank reduces within its tile of a set that tiles the world
(``ops/quantized.py``), and a set that does not tile raises
:class:`QuantizedWireError` (``:192-205``).  The plan, the loss and the
BatchNorm statistics of :class:`TrainStep` stay world-wide.

Lowering (``lowering=``, else ``HVD_TPU_TOPO_LOWER``; ``:97``,
``:411-479``): each bucket is planned ``flat``, ``hier`` or
``hier_adasum`` (``sched/plan.py`` ``resolve_lowering``).  ``hier``
serves Average and Sum on the world: an intra-domain reduce-scatter,
the cross-domain allreduce of the 1/k shard (the bucket's wire on that
hop only, without error feedback) and an intra-domain all-gather
(``topo/hierarchical.py``), whose groups the plan makes.  ``op=Adasum``
combines the gradients adaptively (``ops/adasum.py``): ``hier_adasum``
on the world (a sum inside each domain, Adasum across), unless the
lowering is ``flat``, and the flat tree otherwise.  On one host, with no
``HVD_TPU_TOPO``, every bucket resolves ``flat``.  The quantized wire
serves Adasum only where ``hier_adasum`` does (``:162-190``, ``:379-391``).

Autotuning (``HVD_TPU_AUTOTUNE=1``, ``:974-990``, ``:1040-1142``): a
:class:`TrainStep` over a ``DistributedOptimizer`` built without
``fusion_threshold_bytes`` tunes the fusion threshold, then the
hierarchical allreduce, then (``HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED=1``,
where :attr:`quant_eligible`) the int8 wire, with
``utils/autotune.py`` ``AutotuneDriver``.  Each call runs under the
driver's suggestion, which the step hands to the optimizer
(:attr:`_DistributedOptimizer.variant`): the fusion threshold where the
optimizer was given none, the hierarchical allreduce of its dense
buckets (else ``HVD_TPU_HIERARCHICAL_ALLREDUCE``), and an int8 wire on
every eligible bucket, without error feedback, as the JAX probe runs.
The variant is part of the plan's key, so each variant plans its own
buckets; nothing outside the optimizer sees it.

Sparse gradients (``nn.Embedding(sparse=True)``; ``:208-270``): unless
``sparse_as_dense``, a sparse gradient leaves its bucket (a zero-length
placeholder there) and is reduced as an allgather of its indices and
rows (``ops/sparse.py``), compressed and scaled as the dense wire is,
then densified; a non-member of the set keeps its own gradient.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import faults, metrics, runtime
from ..compression import Compression, Compressor
from ..exceptions import HorovodTpuError, ProcessSetTilingError, QuantizedWireError
from ..ops import LAUNCH_COUNTED, collectives, fusion
from ..ops.collectives import Adasum, Average, Sum
from ..ops.quantized import quantized_allreduce
from ..ops.sparse import densify
from ..process_sets import ProcessSet, resolve
from ..sched import execute
from ..sched.hooks import GradOrder, ScheduleLauncher
from ..sched.plan import (
    QUANTIZED_WIRES,
    BucketSchedule,
    SchedConfig,
    _canon_lowering,
    build_schedule,
    dtype_name,
    resolve_lowering,
)
from ..utils import env
from ..xir.interp import onestep_engaged, onestep_mode


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
        groups: Optional[Sequence[Sequence[torch.Tensor]]] = None,
        sparse_as_dense: bool = False,
        process_set: Optional[ProcessSet] = None,
        lowering: Optional[str] = None,
    ):
        cfg = SchedConfig.from_env()
        self._quantized = getattr(compression, "quantized_wire", False)
        quantized_req = self._quantized or (
            cfg.enabled and cfg.wire in QUANTIZED_WIRES
        )
        self._lowering = None if lowering is None else _canon_lowering(lowering)
        if op not in (Average, Sum, Adasum):
            if quantized_req:
                raise QuantizedWireError(
                    "the quantized wire requires op=Average or Sum; unset "
                    "HVD_TPU_SCHED_WIRE or use a cast compressor"
                )
            raise ValueError("DistributedOptimizer supports op=Average, Sum or Adasum")
        if op == Adasum and quantized_req and not self._adasum_hier_eligible(
                cfg, process_set):
            raise QuantizedWireError(
                "the quantized wire requires op=Average/Sum; flat Adasum has no "
                "quantized lowering — on a multi-domain topology hier_adasum "
                "quantizes just the cross-domain hop"
            )
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
        ps = resolve(process_set)
        if quantized_req and ps is not None:
            # What the JAX package raises when it reduces: the
            # compressor's check (:192-205), else the quantized wire's
            # (ops/quantized.py _axis_groups).
            table = runtime.get_runtime().process_set_table
            if table.partition_groups(ps) is None:
                if not self._quantized:
                    raise ProcessSetTilingError(ps.ranks, table.world_size,
                                                "quantized wire over the 'hvd' axis")
                raise QuantizedWireError(
                    f"the quantized wire serves the global set or sets "
                    f"that tile the axis into equal replica groups; "
                    f"{ps!r} does neither — use the dense "
                    "path for arbitrary subsets"
                )
        # The set as the caller holds it: resolved again at each step, so
        # a set removed since raises and one re-added is used anew.
        self._process_set = process_set
        self._member = ps is None or runtime.rank() in ps.ranks
        self._opt = optimizer
        self.set_backward_passes_per_step(backward_passes_per_step)
        self._op = op
        self._compression = compression
        self._quantized_req = quantized_req
        self._avg_agg = average_aggregated_gradients
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._fusion_threshold = fusion_threshold_bytes
        # The autotune driver's (threshold, hierarchical, quantized), set
        # by TrainStep before each call (None: not tuned).
        self.variant: Optional[tuple] = None
        self._sparse_as_dense = sparse_as_dense
        self._params: List[torch.Tensor] = [
            p for group in optimizer.param_groups for p in group["params"]
            if p.requires_grad
        ]
        if named_parameters is not None:
            self._check_names(named_parameters)
        self._pinned = self._group_indices(groups)
        # Error-feedback residuals, one float32 tensor per parameter.
        self._residuals: Optional[List[torch.Tensor]] = None
        if cfg.enabled and cfg.wire_ef and quantized_req:
            self._residuals = [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in self._params
            ]
        self._order = (
            GradOrder(self._params, self._grad_ready) if cfg.enabled else None
        )
        self._schedule_key = None
        self._schedule: Optional[BucketSchedule] = None
        self._calls = 0
        self._synchronized = False
        self._should_synchronize = True
        # The step's exchange: the chain and its launcher once a bucket
        # may launch, each launched leaf's wire tensor and compression
        # context, the residuals its quantized buckets computed, the
        # leaves the k-th backward made ready, and the plan the next
        # k-th backward launches from.
        self._chain: Optional[execute.BucketChain] = None
        self._launcher: Optional[ScheduleLauncher] = None
        self._leaves: Dict[int, torch.Tensor] = {}
        self._ctx: Dict[int, object] = {}
        self._sparse: Dict[int, torch.Tensor] = {}
        self._pending: List[tuple] = []
        self._marked: set = set()
        self._overlap_plan: Optional[BucketSchedule] = None

    def _adasum_hier_eligible(self, cfg: SchedConfig, process_set) -> bool:
        """Whether ``op=Adasum`` takes ``hier_adasum`` (JAX ``:97``): the
        scheduler on, the world (not a set), a multi-domain topology that
        factors the world, and a lowering that is not forced ``flat``."""
        if not cfg.enabled or resolve(process_set) is not None:
            return False
        return resolve_lowering(self._lower_request(cfg, Adasum, None), 0,
                                runtime.size(), ("float32",)) == "hier_adasum"

    def _lower_request(self, cfg: SchedConfig, op: int, ps) -> str:
        """The lowering the plan asks of each bucket (JAX ``:430-463``):
        the requested one (``lowering=``, else ``HVD_TPU_TOPO_LOWER``) for
        Average and Sum on the world, ``hier_adasum`` for Adasum on the
        world unless ``flat`` is asked for, else ``flat``."""
        req = cfg.lowering if self._lowering is None else self._lowering
        if ps is not None:
            return "flat"
        if op in (Average, Sum):
            return req
        if op == Adasum:
            return "flat" if req == "flat" else "hier_adasum"
        return "flat"

    @property
    def lowering(self) -> Optional[str]:
        """The lowering asked for at construction (None: the knob's)."""
        return self._lowering

    @property
    def fusion_threshold_bytes(self) -> Optional[int]:
        """The threshold given at construction; None lets
        ``HVD_TPU_AUTOTUNE`` tune it (JAX ``_hvd_fusion_threshold``)."""
        return self._fusion_threshold

    @property
    def quant_eligible(self) -> bool:
        """Whether the autotune driver may probe the int8 wire (JAX
        ``_hvd_quant_eligible``, ``:793-797``): no quantized compressor
        already, op Average or Sum, the world."""
        return (not self._quantized and self._op in (Average, Sum)
                and resolve(self._process_set) is None)

    def _tuned_int8(self) -> bool:
        """Whether the tuned variant probes the int8 wire (``:50-55``)."""
        return self.variant is not None and bool(self.variant[2])

    def _quantizing(self) -> bool:
        """An explicit quantized compressor, or the tuner's int8 probe."""
        return self._quantized or self._tuned_int8()

    def _threshold(self) -> Optional[int]:
        """The fusion threshold given at construction, else the tuned
        variant's (None: the knob's)."""
        if self._fusion_threshold is not None or self.variant is None:
            return self._fusion_threshold
        return self.variant[0]

    def _hierarchical(self) -> bool:
        """The tuned variant's hierarchical allreduce where it sets one,
        else ``HVD_TPU_HIERARCHICAL_ALLREDUCE``."""
        tuned = None if self.variant is None else self.variant[1]
        return collectives.hierarchical_enabled() if tuned is None else bool(tuned)

    @property
    def point_to_point(self) -> bool:
        """Whether a bucket of the exchange runs Adasum's flat tree, whose
        halves go point to point (``ops/adasum.py``): ``op=Adasum`` over
        more than one rank with a lowering that resolves ``flat``."""
        if self._op != Adasum:
            return False
        ps = resolve(self._process_set)
        if (runtime.size() if ps is None else len(ps.ranks)) == 1:
            return False
        cfg = self._config()
        lower = self._lower_request(cfg, self._op, ps) if cfg.enabled else "flat"
        return resolve_lowering(lower, 0, runtime.size(), ("float32",)) == "flat"

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

    def _group_indices(self, groups) -> Tuple[Tuple[int, ...], ...]:
        """``groups`` (lists of parameters) as the plan's pinned groups of
        parameter indices (the JAX package's ``groups`` of leaf indices)."""
        if groups is None:
            return ()
        index = {id(p): i for i, p in enumerate(self._params)}
        pinned, seen = [], set()
        for group in groups:
            idx = []
            for p in group:
                i = index.get(id(p))
                if i is None:
                    raise ValueError(
                        "groups names a parameter the optimizer does not update"
                    )
                if i in seen:
                    raise ValueError("groups names a parameter twice")
                seen.add(i)
                idx.append(i)
            if idx:
                pinned.append(tuple(idx))
        return tuple(pinned)

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
        self._discard()
        return self._opt.zero_grad(set_to_none=set_to_none)

    @property
    def backward_passes_per_step(self) -> int:
        return self._k

    def set_backward_passes_per_step(self, k: int) -> None:
        """Reduce and apply on every k-th ``step()`` only; the calls
        between accumulate gradients locally."""
        if int(k) < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._k = int(k)

    def skip_synchronize(self):
        """Context manager: the ``step()`` inside applies the gradients
        without reducing them.  Pair it with an explicit
        ``synchronize()`` before, e.g. to clip the reduced gradients
        (reference ``torch/optimizer.py`` ``skip_synchronize``)."""

        @contextlib.contextmanager
        def ctx():
            self._should_synchronize = False
            try:
                yield
            finally:
                self._should_synchronize = True

        return ctx()

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
    def process_set(self) -> Optional[ProcessSet]:
        """The set the gradients are reduced over (None: the world)."""
        return self._process_set

    @property
    def schedule(self) -> Optional[BucketSchedule]:
        """The exchange plan of the last reduction (None before it)."""
        return self._schedule

    def _key(self, wire: Sequence[torch.Tensor], cfg: SchedConfig) -> tuple:
        """What the plan is a function of: the leaves' wire sizes (one
        byte per element under a quantized compressor, so buckets fill to
        the intended wire-size threshold), their dtypes and the config."""
        return (
            tuple(w.numel() * (1 if self._quantizing() else w.element_size())
                  for w in wire),
            tuple(dtype_name(w.dtype) for w in wire),
            cfg,
            env.get_env(env.TOPO),
            self.variant,
            self._hierarchical(),
        )

    def _plan(self, key: tuple) -> BucketSchedule:
        sizes, dtypes, cfg = key[:3]
        observed = self._order.consume() if self._order is not None else None
        if not cfg.capture_order:
            observed = None
        if self._schedule is not None and key == self._schedule_key:
            return self._schedule
        if cfg.enabled:
            # Every rank plans from rank 0's observation and prices the
            # lowerings with rank 0's measured fit, so all ranks issue the
            # same collectives in the same order.  An explicit quantized
            # compressor wins over HVD_TPU_SCHED_WIRE.
            from ..topo import fit

            several = runtime.size() > 1
            mine = fit.local_params() if several and runtime.rank() == 0 else None
            order, shared = runtime.broadcast_object((observed, mine), root_rank=0)
            if several:
                fit.share(shared)
            wire = (self._compression.wire_format if self._quantized
                    else "int8" if self._tuned_int8() else None)
            schedule = build_schedule(
                sizes, dtypes, cfg, order=order, pinned=self._pinned, wire=wire,
                lowering=self._lower_request(cfg, self._op, resolve(self._process_set)),
                axis_size=runtime.size())
            if (any(b.lowering != "flat" for b in schedule.buckets)
                    or self._hierarchical()):
                from ..topo import hierarchical

                # The intra and cross groups, made here on every rank (never
                # on the exchange worker or in a backward hook), for the
                # hierarchical buckets and the hierarchical allreduce.
                hierarchical.phase_context()
        else:
            # HVD_TPU_SCHED=off: in-order buckets on the dense wire.
            schedule = build_schedule(
                sizes, dtypes,
                dataclasses.replace(cfg, bucket_bytes=self._threshold()),
                order=range(len(sizes)), pinned=self._pinned, wire="off",
            )
        self._schedule_key, self._schedule = key, schedule
        return schedule

    def _config(self) -> SchedConfig:
        cfg = SchedConfig.from_env()
        if cfg.bucket_bytes is None and self._threshold() is not None:
            cfg = dataclasses.replace(cfg, bucket_bytes=self._threshold())
        return cfg

    def _grad_ready(self, idx: int) -> None:
        """Post-accumulate-grad hook: on the k-th backward, mark ``idx``
        ready (a second time raises) and, once the plan is known, launch
        what may go."""
        if self._synchronized or (self._calls + 1) % self._k:
            return
        if idx in self._marked:
            raise RuntimeError(
                "gradients were computed more than backward_passes_per_step "
                "times before step(); increase backward_passes_per_step to "
                "accumulate gradients locally, or call zero_grad() first"
            )
        self._marked.add(idx)
        if self._launcher is None:
            if self._overlap_plan is None:
                return
            self._open(self._overlap_plan, side=True)
        self._launcher.ready(idx)

    def _open(self, schedule: BucketSchedule, side: bool) -> None:
        self._chain = execute.BucketChain(
            schedule, self._reduce_bucket, self._params[0].device, side=side,
        )
        self._launcher = ScheduleLauncher(schedule.buckets, self._launch)

    def _launch(self, k: int, from_hook: bool) -> None:
        indices = self._chain.schedule.buckets[k].indices
        self._chain.launch(
            k, lambda: [self._wire_leaf(i) for i in indices], from_hook
        )

    def _wire_leaf(self, i: int) -> torch.Tensor:
        """Parameter ``i``'s gradient as it goes on the wire: zeros when
        it has none, else times 1/k in place when averaging k accumulated
        passes and densified when sparse; then compressed.  Made once per
        step, where its bucket runs."""
        w = self._leaves.get(i)
        if w is not None:
            return w
        p = self._params[i]
        g = p.grad
        if g is None:
            g = torch.zeros_like(p)
        else:
            if g.is_cuda and not g.is_sparse:  # read where the bucket runs
                g.record_stream(torch.cuda.current_stream(g.device))
            if self._k > 1 and self._avg_agg:
                g.mul_(1.0 / self._k)
            if g.is_sparse:
                g = self._densify(i, g)
        w, self._ctx[i] = self._compression.compress(g)
        self._leaves[i] = w
        return w

    def _densify(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """A sparse gradient's stand-in on the bucket's wire: densified
        under ``sparse_as_dense``, else kept for :meth:`_sparse_reduce` and
        replaced by a zero-length placeholder."""
        if self._sparse_as_dense:
            return densify(g)
        if self._quantized_req or self._tuned_int8():
            raise QuantizedWireError(
                "the quantized wire does not take sparse gradients (the "
                "quantizer lives inside the dense two-phase reduction); "
                "use sparse_as_dense=True or a cast compressor"
            )
        if self._op not in (Average, Sum):
            raise ValueError(
                "sparse gradients support op=Average or Sum only (the "
                "reference's sparse path is allgather-based and has no Adasum "
                "variant); pass sparse_as_dense=True to adasum embedding "
                "gradients as dense tensors"
            )
        self._sparse[i] = g
        return torch.zeros(0, dtype=g.dtype, device=g.device)

    def _sparse_reduce(self, g: torch.Tensor) -> torch.Tensor:
        """A sparse gradient reduced as the JAX package's ``reduce_sparse``
        (``:229-252``): its rows compressed and prescaled, gathered with its
        indices over the set (``ops/sparse.py``), decompressed, postscaled
        and densified; a non-member keeps its own gradient, densified."""
        from ..ops.sparse import sparse_allreduce

        ps = resolve(self._process_set)
        if ps is not None and runtime.rank() not in ps.ranks:
            return densify(g)
        wire, ctx = self._compression.compress(g._values())
        if self._prescale != 1.0:
            wire = wire * self._prescale
        out = sparse_allreduce(
            torch.sparse_coo_tensor(g._indices(), wire, g.shape, check_invariants=False),
            self._op, self._process_set)
        vals = self._compression.decompress(out._values(), ctx)
        if self._postscale != 1.0:
            vals = vals * self._postscale
        return densify(torch.sparse_coo_tensor(out._indices(), vals, g.shape,
                                               check_invariants=False))

    def _reduce_bucket(self, f: torch.Tensor, bucket) -> torch.Tensor:
        """One bucket's flat buffer through its lowering and wire; a
        non-member of the set keeps it as it is on the dense wires."""
        if f.numel() == 0:  # only sparse gradients' placeholders
            return f
        if bucket.lowering == "hier_adasum":
            return execute.hier_adasum_flat(
                f, average=self._op != Sum, wire=bucket.wire,
                prescale_factor=self._prescale, postscale_factor=self._postscale)
        if bucket.lowering == "hier":
            return execute.hier_allreduce_flat(
                f, average=self._op == Average, wire=bucket.wire,
                prescale_factor=self._prescale, postscale_factor=self._postscale)
        if bucket.wire in QUANTIZED_WIRES:
            return self._quantized_bucket(f, bucket)
        if not self._member and not (self._quantized and f.is_floating_point()):
            return f
        if bucket.wire == "bf16":
            return execute.bf16_wire(self._dense)(f)
        return self._dense(f)

    def _dense(self, f: torch.Tensor) -> torch.Tensor:
        if self._quantized and f.is_floating_point():
            # Compression.int8/fp8 on a bucket the plan left "off" (or
            # HVD_TPU_SCHED=off): quantized, without residuals.
            g = f if self._prescale == 1.0 else f * self._prescale
            g = quantized_allreduce(
                g, self._op, self._process_set, wire=self._compression.wire_format
            )
            return g if self._postscale == 1.0 else g * self._postscale
        return collectives.allreduce_(
            f, self._op, self._prescale, self._postscale,
            process_set=self._process_set, hierarchical=self._hierarchical(),
        )

    def synchronize(self) -> None:
        """Reduce every gradient across ranks, in place: launch the
        buckets not yet launched, in schedule order, and wait for all."""
        n = len(self._params)
        cfg = self._config()
        ps = resolve(self._process_set)
        self._member = ps is None or runtime.rank() in ps.ranks
        with torch.no_grad():
            if self._launcher is None:
                wire = [self._wire_leaf(i) for i in range(n)]
                self._open(self._plan(self._key(wire, cfg)), side=False)
            elif self._order is not None:
                self._order.consume()  # the plan is fixed: drop the order
            chain = self._chain
            try:
                chain.mark_backward_end()
                self._launcher.flush()
                reduced = chain.finish()
                key = self._key([self._leaves[i] for i in range(n)], cfg)
                grads, outs = [], []
                for i, p in enumerate(self._params):
                    if i in self._sparse:
                        p.grad = self._sparse_reduce(self._sparse[i]).to(p.dtype)
                        continue
                    out = self._compression.decompress(reduced[i], self._ctx[i])
                    if p.grad is None or p.grad.is_sparse:
                        p.grad = out.to(p.dtype).clone()
                    else:
                        grads.append(p.grad)
                        outs.append(out)
                if grads:
                    torch._foreach_copy_(grads, outs)  # one call: host time
                self._commit_residuals()
            finally:
                self._close()
        self._synchronized = True
        # The next k-th backward launches from its hooks when the
        # barriers are on and this plan still holds: a knob changed since
        # it was made takes effect at the next step, planned after its
        # backward.
        self._overlap_plan = (
            chain.schedule
            if cfg.enabled and cfg.barriers and key == self._schedule_key
            else None
        )

    def _close(self) -> None:
        self._chain, self._launcher = None, None
        self._leaves, self._ctx, self._pending, self._sparse = {}, {}, [], {}
        self._marked = set()

    def _discard(self) -> None:
        """Finish the buckets the backward launched, and launch the rest,
        every rank alike; drop their results and the residuals they
        computed."""
        try:
            if self._launcher is not None:
                with torch.no_grad():
                    self._launcher.flush()
                    self._chain.finish()
        finally:
            self._close()

    def _commit_residuals(self) -> None:
        for indices, r_new, rmeta in self._pending:
            if r_new.is_cuda:  # made on the exchange stream
                r_new.record_stream(torch.cuda.current_stream(r_new.device))
            torch._foreach_copy_([self._residuals[i] for i in indices],
                                 fusion.unflatten_group([r_new], rmeta))

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
            process_set=self._process_set,
        )
        if r_new is not None:  # written back once the result is used
            self._pending.append((bucket.indices, r_new, rmeta))
        return out

    def step(self, closure=None):
        self._calls += 1
        if self.accumulating:
            return None  # no reduce, no apply
        # An explicit synchronize() before step() (gradient clipping)
        # already reduced; reducing again would re-sum the sums.
        if not self._synchronized:
            if self._should_synchronize:
                self.synchronize()
            else:
                self._drain()
        self._synchronized = False
        return self._opt.step(closure)

    def _drain(self) -> None:
        """``step()`` under ``skip_synchronize()`` with no
        ``synchronize()`` before it: the gradients are applied as they
        are (times 1/k when averaging k passes, as the reference scales
        them); buckets the backward launched are finished, every rank
        alike, and their results dropped."""
        if self._launcher is not None:
            self._discard()  # every gradient was scaled where it launched
            return
        self._close()
        if self._k > 1 and self._avg_agg:
            with torch.no_grad():
                for p in self._params:
                    if p.grad is not None:
                        p.grad.mul_(1.0 / self._k)


def DistributedOptimizer(
    optimizer: torch.optim.Optimizer,
    named_parameters: Optional[Iterable[Tuple[str, torch.Tensor]]] = None,
    **kwargs,
):
    """Wrap ``optimizer`` so ``step()`` first averages the gradients
    across ranks, or across ``process_set`` (keyword arguments as
    :class:`_DistributedOptimizer`).

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


# Eager steps a TrainStep runs, on a side stream, before it captures:
# the first makes the plan (rank 0's observed order, broadcast), the
# ring's peer window and peer check, the NCCL communicators and SGD's
# momentum buffers; the second runs as every later step does (from the
# backward's hooks under HVD_TPU_SCHED_BARRIERS=1, momentum in use).
CAPTURE_WARMUP = 2

# The side stream of the warm-up steps, one per card for the process:
# PyTorch keeps a cuBLAS workspace per (handle, stream) for good, so a
# new stream per warm-up would leave ~64 MiB more behind each time.
_WARMUP_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = _WARMUP_STREAMS.get(index)
    if stream is None:
        stream = _WARMUP_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def capture_blocker(backend: Optional[str], backward_passes: int, sparse: bool,
                    optimizer_capturable: bool = True,
                    point_to_point: bool = False,
                    fault_plan: bool = False) -> Optional[str]:
    """Why a data-parallel step on a card cannot be captured as one CUDA
    graph, from static facts alone (None: it can).  ``backend`` is the
    process group's (None without a runtime: no collective runs);
    ``backward_passes`` the optimizer's ``backward_passes_per_step``;
    ``sparse`` whether the model has a sparse-gradient module;
    ``optimizer_capturable`` False when a parameter group of the
    optimizer has ``capturable=False`` (Adam, AdamW: their step count is
    read on the host); ``point_to_point`` whether the exchange runs
    Adasum's flat tree (the optimizer's ``point_to_point``);
    ``fault_plan`` whether a fault plan arms a site on the step's path
    (``faults.FaultPlan.arms_step``)."""
    if backend is not None and backend != "nccl":
        return (f"its process group is {backend}, not NCCL: each collective "
                "waits on the host")
    if backward_passes != 1:
        return (f"backward_passes_per_step is {backward_passes}: the steps "
                "that only accumulate differ from the ones that apply")
    if sparse:
        return "the model has a sparse-gradient module (sparse=True)"
    if not optimizer_capturable:
        return ("the optimizer was built with capturable=False: its update "
                "reads its step count on the host")
    if point_to_point:
        return ("op=Adasum's flat tree exchanges its halves point to point "
                "(batch_isend_irecv), which is not captured; the hier_adasum "
                "lowering is")
    if fault_plan:
        return ("fault_plan: HVD_TPU_FAULT_PLAN arms a site on the step's path "
                f"({', '.join(faults.STEP_SITES)}); an injected host delay or raise "
                "cannot be recorded into a CUDA graph")
    return None


# Captured steps a TrainStep keeps, one per batch signature (shapes,
# dtypes, devices and structure): an epoch's short last batch keeps its
# own graph beside the full batch's, as ``jax.jit`` keeps one executable
# per shape.  Past this many, the least recently replayed is dropped.
MAX_GRAPHS = 4


class _Captured:
    """One step captured as a CUDA graph: its static inputs, its loss,
    the kernel launches it records, per wrapper of
    ``ops.LAUNCH_COUNTED`` (added to their counters on every replay: the
    replay's counts are inferred from the capture's, not counted at a
    launch), the bytes the card's reserved memory grew by across its
    capture (its memory pool) and the buckets of the exchange it
    captured."""

    def __init__(self, graph, static: list, loss: torch.Tensor, launches: dict,
                 reserved: int = 0, buckets: int = 0):
        self.graph = graph
        self.static = static
        self.loss = loss
        self.launches = launches
        self.reserved = reserved
        self.buckets = buckets

    def replay(self, leaves: list) -> torch.Tensor:
        for s, t in zip(self.static, leaves):
            if torch.is_tensor(s):
                s.copy_(t)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.loss.clone()  # a later replay overwrites self.loss


def _signature(leaves: list) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) if torch.is_tensor(t) else t
                 for t in leaves)


def _frozen(value):
    """A hashable stand-in for a hyperparameter: a tensor on the card by
    its storage (a replay reads its value there), one on the host by its
    value too (the update reads it at capture), a container item by
    item."""
    if torch.is_tensor(value):
        host = _frozen(value.tolist()) if value.device.type == "cpu" else None
        return ("tensor", value.data_ptr(), value.device, host)
    if isinstance(value, (list, tuple)):
        return tuple(_frozen(v) for v in value)
    if isinstance(value, dict):
        return tuple((k, _frozen(v)) for k, v in sorted(value.items()))
    try:
        hash(value)
    except TypeError:
        return repr(value)
    return value


def host_state(optimizer) -> tuple:
    """What a captured step holds fixed besides the batch and the
    scheduler's knobs, and the eager step reads anew on every call: each
    parameter group's size and hyperparameters (SGD's ``lr``, ``momentum``
    and ``weight_decay`` are Python numbers, baked into the update's
    kernels at capture) and the quantized wire's knobs
    (``HVD_TPU_QUANT_BACKEND``, ``HVD_TPU_QUANT_BLOCK``, read per
    collective).  A change of any drops the captured step."""
    groups = tuple(
        (len(g["params"]),) + tuple((k, _frozen(v)) for k, v in sorted(g.items())
                                    if k != "params")
        for g in optimizer.param_groups)
    return groups, env.get_env(env.QUANT_BACKEND), env.get_env(env.QUANT_BLOCK)


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
    ``backward_passes_per_step=k`` they accumulate over k calls.

    On a card the whole step is captured as one CUDA graph when
    ``HVD_TPU_ONESTEP`` engages it (``xir/interp.py``; the counterpart of
    the JAX package's whole-step emission, ``TrainStep`` ``:1034-1063``):
    after ``CAPTURE_WARMUP`` eager steps on a side stream, one step is
    captured (forward, backward, every bucket's exchange, the update and
    the cross-rank means) and every later call copies the batch into the
    graph's inputs, replays it (one ``cudaGraphLaunch``) and returns a
    copy of its loss, bitwise what the eager step computes.  One graph is
    kept per batch signature (structure, shapes, dtypes and devices), up
    to ``MAX_GRAPHS``, each in its own memory pool: a new signature warms
    up and captures on its own, one seen before replays at once (an
    epoch's short last batch and the full batch each keep theirs, as the
    JAX package keeps one compiled step per shape), and past the bound
    the least recently replayed graph is dropped.  A change of the
    scheduler's knobs (``HVD_TPU_SCHED_WIRE``, ``HVD_TPU_SCHED_BARRIERS``,
    ...), of the optimizer's hyperparameters or the quantized wire's
    knobs (:func:`host_state`: a learning-rate schedule's new ``lr``) or
    of the mode, or of the optimizer's process set (its id and ranks:
    ``remove_process_set`` drops the graphs of a set before it destroys
    the set's groups, and a set added again gets a new id) drops every
    graph and its memory; the next calls warm up and capture anew, as
    the JAX package retraces.  So a key that changes
    at every step (a per-step schedule) runs every step eagerly, on the
    warm-up stream, and never captures.  ``auto`` captures a step
    of two or more units (buckets, plus the update) that
    :func:`capture_blocker` lets through and runs any other eagerly;
    ``on`` raises for a step it blocks; ``off`` runs eagerly.  On the CPU
    every mode runs eagerly (no graphs there).  A capture that fails
    raises: nothing falls back to the eager step.  Python state is
    frozen at the capture: the ``sched.*`` metrics count once per
    capture (``xir.onestep.steps`` too), the kernels' launch counters
    once per replay, and ``p.grad`` stays None after each step, as the
    eager step leaves it.

    Every call observes its host time in ``train.step_seconds`` and
    counts ``train.steps`` (``:1130-1136``), the feed of
    ``sched/tune.py`` ``ScheduleTuner``.

    Under ``HVD_TPU_AUTOTUNE=1``, over a ``DistributedOptimizer`` built
    without ``fusion_threshold_bytes``, the step tunes itself
    (``utils/autotune.py`` ``AutotuneDriver``, built here as at
    ``:974-990``, with the optimizer's ``quant_eligible``).  Each call
    runs under the driver's variant, (threshold, hierarchical,
    quantized), set around it as the plan's overrides (module
    docstring).  The variant is part of each graph's signature beside
    the batch's, so the variants explored keep their graphs side by side
    up to ``MAX_GRAPHS`` (least recently replayed dropped past it) and a
    variant seen before replays at once.  The variant reaches the plan
    through the optimizer alone (``optimizer.variant``), so the
    collectives a user's ``loss_fn`` issues keep their own knobs.  In a
    world of several ranks every rank follows rank 0's scores
    (``AutotuneDriver.after_step``).  A window times only settled
    steps: a new variant's ``CAPTURE_WARMUP`` eager steps and its capture
    are reported unsettled (:attr:`last_settled`), so the window's clock
    starts after them and its scores compare replays with replays, where
    the JAX package fences out the first step of each window, which pays
    its compile.  Once the driver has converged, every graph but the
    frozen variant's is dropped and its memory pool returned to the card
    (``:1047-1058``).  A quantized probe whose step raises
    :class:`QuantizedWireError` (a sparse gradient) makes the driver
    reject the knob and the call is run again on the variant without it
    (``:1104-1117``), within the same call: ``train.steps`` counts it
    once.  Its gradients are cleared first, but its forward ran twice
    (BatchNorm's running statistics saw the batch twice)."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Callable[[torch.nn.Module, object], torch.Tensor]):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        # (variant, batch signature) -> its graph, least recently replayed
        # first; and the eager warm-up steps each of them has run.
        self._graphs: "OrderedDict[tuple, _Captured]" = OrderedDict()
        self._warm: "OrderedDict[tuple, int]" = OrderedDict()
        self._key = None  # what every graph holds fixed besides the batch
        # Whether the last call was settled: not a warm-up step or a
        # capture of a new graph (AutotuneDriver.after_step).
        self.last_settled = True
        self.autotune = None
        marker = getattr(optimizer, "fusion_threshold_bytes", "absent")
        if env.get_bool(env.AUTOTUNE) and marker is None:
            from ..utils.autotune import AutotuneDriver

            self.autotune = AutotuneDriver(
                quant_eligible=getattr(optimizer, "quant_eligible", False))
        self._seen_variants: set = set()

    def __call__(self, batch) -> torch.Tensor:
        at = self.autotune
        t0 = time.perf_counter()
        try:
            while True:
                variant = None if at is None else self._variant()
                try:
                    out = self._call(batch, variant)
                    break
                except QuantizedWireError:
                    if (variant is None or not variant[2] or at.converged
                            or variant in self._seen_variants):
                        raise
                    # The probe's step cannot take the int8 wire: reject the
                    # knob, clear what the failed step left and run again.
                    at.reject_quantized()
                    self.optimizer.zero_grad(set_to_none=True)
                    self._forget(variant)
        finally:
            metrics.observe("train.step_seconds", time.perf_counter() - t0)
            metrics.inc_counter("train.steps")
        if at is not None:
            self._seen_variants.add(variant)
            at.after_step(out, settled=self.last_settled)
        return out

    def _variant(self) -> tuple:
        """The driver's variant, handed to the optimizer; once the driver
        has converged, the losing variants' graphs are dropped."""
        at = self.autotune
        variant = (at.threshold_bytes(), at.hierarchical(), at.quantized())
        if at.converged and any(sig[0] != variant for sig in self._graphs):
            self._evict([sig for sig in self._graphs if sig[0] != variant])
            for sig in [sig for sig in self._warm if sig[0] != variant]:
                del self._warm[sig]
        self.optimizer.variant = variant
        return variant

    def _forget(self, variant) -> None:
        """Drop what the step holds of ``variant``."""
        self._evict([sig for sig in self._graphs if sig[0] == variant])
        for sig in [sig for sig in self._warm if sig[0] == variant]:
            del self._warm[sig]

    def _call(self, batch, variant) -> torch.Tensor:
        mode = onestep_mode()
        device = self._device()
        self.last_settled = True
        if mode == "off" or device.type != "cuda":
            self.drop()
            return self._eager(batch, mode)
        reason = self.blocker()
        if reason is not None:
            if mode == "on":
                raise HorovodTpuError(
                    f"HVD_TPU_ONESTEP=on: this step cannot be captured as one "
                    f"CUDA graph: {reason} (ROADMAP Queue A item A12a)"
                )
            self.drop()
            return self._eager(batch, mode)
        leaves, spec = tree_flatten(batch)
        key = (mode, SchedConfig.from_env(), host_state(self.optimizer),
               self._set_key(), env.get_env(env.TOPO))
        if key != self._key:
            self.drop()
            self._key = key
        sig = (variant, spec, _signature(leaves))
        captured = self._graphs.get(sig)
        if captured is None:
            warm = self._warm.pop(sig, 0)
            if warm < CAPTURE_WARMUP:
                self._warm[sig] = warm + 1
                if len(self._warm) > MAX_GRAPHS:  # bound those warming up
                    self._warm.popitem(last=False)
                self.last_settled = False
                return self._side_stream_step(batch, mode, device)
            if not onestep_engaged(self._units()):
                self._warm[sig] = warm
                return self._eager(batch, mode)
            if len(self._graphs) >= MAX_GRAPHS:
                self._evict([next(iter(self._graphs))])
            self.last_settled = False
            captured = self._graphs[sig] = self._capture(leaves, spec)
            if runtime.is_initialized():  # shutdown() drops it first
                runtime.get_runtime().captured_steps.add(self)
        else:
            self._graphs.move_to_end(sig)
        metrics.set_gauge("sched.onestep.engaged", 1.0, {"mode": mode})
        return captured.replay(leaves)

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _set_key(self) -> Optional[tuple]:
        """The optimizer's process set as the graphs hold it fixed: its id
        and ranks (None: the world).  A set removed and added again gets
        a new id, so the step captures anew on its new groups."""
        ps = getattr(self.optimizer, "process_set", None)
        return None if ps is None else (ps.process_set_id, ps.ranks)

    def holds_set(self, process_set_id: int) -> bool:
        """Whether the captured graphs were made on the set
        ``process_set_id`` (``remove_process_set`` drops them first)."""
        held = self._key[3] if self._key is not None else None
        return held is not None and held[0] == process_set_id

    def blocker(self) -> Optional[str]:
        """:func:`capture_blocker` of this step's model and optimizer."""
        rt = runtime.get_runtime() if runtime.is_initialized() else None
        sparse = any(isinstance(m, (torch.nn.Embedding, torch.nn.EmbeddingBag))
                     and m.sparse for m in self.model.modules())
        plan = faults.get_plan()
        return capture_blocker(
            rt.backend if rt is not None else None,
            getattr(self.optimizer, "backward_passes_per_step", 1), sparse,
            all(g.get("capturable", True) for g in self.optimizer.param_groups),
            getattr(self.optimizer, "point_to_point", False),
            plan is not None and plan.arms_step())

    def drop(self) -> None:
        """Drop every captured graph and give their memory pools back to
        the card; the next call on a card warms up and captures anew.
        ``shutdown()`` drops every captured step before it leaves the
        process group."""
        self._evict(list(self._graphs))
        self._warm.clear()
        self._key = None

    def _evict(self, sigs: list) -> None:
        """Drop the graphs of ``sigs`` and return their pools to the card
        (an in-flight replay finishes first: ``empty_cache`` frees
        through ``cudaFree``, which waits for the device).  Nothing else
        holds a graph's static inputs and loss, which live in its pool."""
        if not sigs:
            return
        for sig in sigs:
            self._graphs.pop(sig).graph.reset()
        torch.cuda.empty_cache()

    @property
    def graphs(self) -> int:
        """How many captured graphs the step holds."""
        return len(self._graphs)

    def _units(self) -> int:
        schedule = getattr(self.optimizer, "schedule", None)
        return (len(schedule) if schedule is not None else 0) + 1

    def _side_stream_step(self, batch, mode: str, device) -> torch.Tensor:
        main = torch.cuda.current_stream(device)
        side = _warmup_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            loss = self._eager(batch, mode)
        main.wait_stream(side)
        loss.record_stream(main)
        return loss

    def _capture(self, leaves: list, spec) -> _Captured:
        """Capture one step on a copy of ``leaves`` into a new graph, in its
        own memory pool (``torch.cuda.graph``'s default: replays of
        alternating signatures do not follow capture order, which a
        shared pool needs)."""
        static = [t.clone() if torch.is_tensor(t) else t for t in leaves]
        before = {fn: fn.launches for fn in LAUNCH_COUNTED}
        device = self._device()
        # torch.cuda.graph empties the cache as it starts: do so first,
        # so that the growth across the capture is the graph's pool.
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                loss = self._step(tree_unflatten(static, spec))
            launches = {fn: fn.launches - before.get(fn, 0) for fn in LAUNCH_COUNTED}
        finally:  # the capture launched nothing on the device
            for fn in LAUNCH_COUNTED:
                fn.launches = before.get(fn, 0)
        metrics.inc_counter("xir.onestep.steps")
        return _Captured(graph, static, loss, launches,
                         torch.cuda.memory_reserved(device) - reserved,
                         self._units() - 1)

    def _eager(self, batch, mode: str) -> torch.Tensor:
        metrics.set_gauge("sched.onestep.engaged", 0.0, {"mode": mode})
        return self._step(batch)

    def _step(self, batch) -> torch.Tensor:
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
