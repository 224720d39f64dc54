"""Gradient synchronization for hybrid-parallel training.

Counterpart of ``horovod_tpu/parallel/grad_sync.py`` (``:44-93``) and of
its scheduled form, ``horovod_tpu/sched/execute.py``
``sync_gradients_bucketed`` (``:809-900``).  Each rank's raw gradient is
``d(Σ_ranks L_r)/dθ_local`` (the backward of every mesh collective sums
or routes the cotangents across ranks: ``parallel/tensor.py``
``AxisSum``, ``ring_attention``'s hop, ``ulysses``' flip), so the mean
per-rank loss's gradient is recovered per parameter:

* the mean over every present sync axis the parameter is NOT sharded
  over (its replicas each collected a part);
* divided by the size of every present sync axis it IS sharded over.

``param_shard_axes`` maps each gradient to the space-separated axes its
parameter is sharded over (``""``: replicated), as
``models/transformer.py`` ``param_shard_axes`` gives it.  A mean is a
sum on the group of the mean's axes (``Mesh.group``) times
``float32(1/n)`` (``collectives.f32_reciprocal``), as ``lax.pmean``
compiles.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..ops import fusion
from ..ops.collectives import _scale, f32_reciprocal
from ..utils import env
from .mesh import DP_AXIS, EP_AXIS, SP_AXIS, TP_AXIS, Mesh, refuse_in_capture

Grads = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


def _parse(axes: str) -> Tuple[str, ...]:
    return tuple(a for a in axes.split() if a)


def _flat(grads: Grads, param_shard_axes) -> Tuple[list, list, Optional[list]]:
    """The gradients as a list, their shard strings, and the names (None
    for a sequence)."""
    if isinstance(grads, Mapping):
        names = list(grads)
        leaves = [grads[n] for n in names]
        if param_shard_axes is None:
            shards = [""] * len(leaves)
        else:
            missing = [n for n in names if n not in param_shard_axes]
            if missing:
                raise ValueError(f"param_shard_axes has no entry for {missing}")
            shards = [param_shard_axes[n] for n in names]
        return leaves, shards, names
    leaves = list(grads)
    shards = [""] * len(leaves) if param_shard_axes is None else list(param_shard_axes)
    if len(shards) != len(leaves):
        raise ValueError("param_shard_axes structure does not match grads")
    return leaves, shards, None


def _rebuild(out: list, names):
    return out if names is None else dict(zip(names, out))


def lowering() -> str:
    """The exchange lowering ``HVD_TPU_TOPO_LOWER`` asks for, canonical
    (``auto``, ``flat``, ``hier`` or ``hier_adasum``).  The scheduled
    form resolves it per bucket through the topology model over the
    mean's axis (``sched/plan.py`` ``resolve_lowering``): on one host, or
    an axis the topology does not factor, every request is ``flat``."""
    from ..sched.plan import _canon_lowering

    return _canon_lowering(env.get_env("TOPO_LOWER", "auto") or "auto")


def pmean_(f: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """``lax.pmean(f, axes)`` over the group of ``axes``: in place on a
    contiguous ``f`` (the result of a half-precision ``f`` is a new
    tensor)."""
    dist.all_reduce(f, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return _scale(f, f32_reciprocal(mesh.group_size(axes)))


def wire_groups(mesh: Mesh, axes: Tuple[str, ...]):
    """Where the quantized exchange of a bucket averaged over ``axes``
    runs: the mesh's own group of ``axes`` (``ops/quantized.py``
    ``Groups``), so the mesh stays the one owner of its communicators."""
    from ..ops.quantized import Groups

    return Groups(mesh.tiles(axes), mesh.group_size(axes), mesh.group(axes),
                  mesh.ranks(axes).index(mesh.rank))


def _divisor(mesh: Mesh, present, sharded) -> int:
    scale = 1
    for a in present:
        if a in sharded:
            scale *= mesh.axis_size(a)
    return scale


def sync_gradients(
    grads: Grads,
    param_shard_axes=None,
    mesh: Optional[Mesh] = None,
    axes: Sequence[str] = (DP_AXIS, SP_AXIS, TP_AXIS, EP_AXIS),
    scheduled: Optional[bool] = None,
    residuals: Optional[Grads] = None,
):
    """Synchronize ``grads`` (a mapping of names to tensors, or a
    sequence) over ``mesh``; returns the same structure, new tensors.

    ``param_shard_axes`` matches ``grads`` (None: every parameter
    replicated).  ``axes`` are the axes to synchronize over; those the
    mesh lacks are skipped, so one call works across mesh shapes, and
    with ``mesh=None`` the gradients come back as they are.
    ``scheduled`` routes the means through the bucketed scheduler
    (:func:`sync_gradients_bucketed`; None follows ``HVD_TPU_SCHED``,
    on by default): the same values on the dense wire.  ``residuals``
    (scheduled only) engages error feedback on quantized buckets and
    the call returns ``(synced, new_residuals)``."""
    if scheduled is None:
        from ..sched.plan import SchedConfig

        scheduled = SchedConfig.from_env().enabled
    if scheduled:
        return sync_gradients_bucketed(grads, param_shard_axes, mesh, axes,
                                       residuals=residuals)
    if residuals is not None:
        raise ValueError("residuals= needs the scheduled form (scheduled=True)")
    leaves, shards, names = _flat(grads, param_shard_axes)
    present = () if mesh is None else tuple(a for a in axes if mesh.present(a))
    out = []
    for g, s in zip(leaves, shards):
        sharded = _parse(s)
        mean_over = tuple(a for a in present if a not in sharded)
        g = g.detach().clone()
        if mean_over and mesh.group_size(mean_over) > 1:
            refuse_in_capture("sync_gradients")
            g = pmean_(g.reshape(-1), mesh, mean_over).view(g.shape)
        scale = _divisor(mesh, present, sharded) if present else 1
        if scale != 1:
            g = g / scale
        out.append(g)
    return _rebuild(out, names)


def sync_gradients_bucketed(
    grads: Grads,
    param_shard_axes=None,
    mesh: Optional[Mesh] = None,
    axes: Sequence[str] = (DP_AXIS, SP_AXIS, TP_AXIS, EP_AXIS),
    cfg=None,
    *,
    residuals: Optional[Grads] = None,
):
    """The scheduled form of :func:`sync_gradients`: the gradients are
    grouped by their set of mean axes, each group planned into buckets
    (``sched/plan.py`` ``build_schedule``, reverse registration order)
    and each bucket's flat buffer averaged with one collective on the
    set's group (``sched/execute.py`` ``BucketChain``).  The division by
    the sharded axes' sizes stays per gradient.  On the dense wire this
    is bitwise :func:`sync_gradients` (a mean is elementwise).

    ``cfg.lowering`` (``HVD_TPU_TOPO_LOWER``): a group whose mean is over
    one axis is planned with it over that axis
    (``horovod_tpu/sched/execute.py:888-941``), so a bucket may go
    ``hier`` (``topo/hierarchical.py`` ``hierarchical_all_reduce`` on the
    mesh axis, its wire on the cross-domain hop only, without error
    feedback) or ``hier_adasum`` (the domains' means combined by Adasum);
    the intra and cross groups are made here, before the buckets run.

    ``cfg.wire`` (``HVD_TPU_SCHED_WIRE``): ``bf16`` casts each bucket
    around its mean (kernel B1); ``int8``/``fp8`` send a bucket whose
    mean is over one axis through the quantized reduce-scatter +
    all-gather on the mesh's group of that axis (:func:`wire_groups`;
    kernels B3-B5), with error feedback when ``residuals`` is given,
    while a group over several axes stays dense, as in the JAX
    package."""
    from ..ops.collectives import Average
    from ..sched import execute
    from ..sched.plan import QUANTIZED_WIRES, SchedConfig, build_schedule, dtype_name
    from ..topo import hierarchical

    if cfg is None:
        cfg = SchedConfig.from_env()
    leaves, shards, names = _flat(grads, param_shard_axes)
    res_leaves = None
    if residuals is not None:
        res_leaves = ([residuals[n] for n in names] if names is not None
                      else list(residuals))
        if len(res_leaves) != len(leaves):
            raise ValueError("residuals structure does not match grads")
    present = () if mesh is None else tuple(a for a in axes if mesh.present(a))
    out: List[torch.Tensor] = [g.detach().clone() for g in leaves]
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, s in enumerate(shards):
        sharded = _parse(s)
        mean_over = tuple(a for a in present if a not in sharded)
        if mean_over and mesh.group_size(mean_over) > 1:
            groups.setdefault(mean_over, []).append(i)

    for mean_over, idxs in groups.items():
        refuse_in_capture("sync_gradients")
        wire = cfg.wire
        if wire in QUANTIZED_WIRES and len(mean_over) != 1:
            wire = "off"  # the quantized exchange has one axis's groups
        one_axis = len(mean_over) == 1
        schedule = build_schedule(
            [out[i].numel() * out[i].element_size() for i in idxs],
            [dtype_name(out[i].dtype) for i in idxs], cfg, wire=wire,
            lowering=cfg.lowering if one_axis else "flat",
            axis_size=mesh.axis_size(mean_over[0]) if one_axis else None)
        where = wire_groups(mesh, mean_over)
        if any(b.lowering != "flat" for b in schedule.buckets):
            hierarchical.phase_context(mean_over[0], mesh=mesh)

        def reduce_flat(f, bucket, _m=mean_over, _idxs=idxs, _where=where):
            if bucket.lowering == "hier_adasum":
                return hierarchical.hierarchical_adasum_all_reduce(
                    f, _m[0], op=Average, wire=bucket.wire, mesh=mesh)
            if bucket.lowering == "hier":
                return hierarchical.hierarchical_all_reduce(
                    f, _m[0], op=Average, wire=bucket.wire, mesh=mesh)
            if bucket.wire in QUANTIZED_WIRES:
                res_flat = rmeta = None
                if res_leaves is not None:
                    flats, rmeta = fusion.flatten_group(
                        [res_leaves[_idxs[j]] for j in bucket.indices])
                    res_flat = flats[0]
                red, r_new = execute.quantized_exchange_flat(
                    f, average=True, wire=bucket.wire, residual=res_flat,
                    groups=_where)
                if r_new is not None:
                    for j, r in zip(bucket.indices,
                                    fusion.unflatten_group([r_new], rmeta)):
                        res_leaves[_idxs[j]] = r.to(res_leaves[_idxs[j]].dtype)
                return red
            if bucket.wire == "bf16":
                return execute.bf16_wire(lambda x: pmean_(x, mesh, _m))(f)
            return pmean_(f, mesh, _m)

        chain = execute.BucketChain(schedule, reduce_flat, out[idxs[0]].device)
        for k, bucket in enumerate(schedule.buckets):
            chain.launch(k, lambda b=bucket: [out[idxs[j]] for j in b.indices])
        for j, t in enumerate(chain.finish()):
            out[idxs[j]] = t.view(out[idxs[j]].shape)

    for i, s in enumerate(shards):
        scale = _divisor(mesh, present, _parse(s)) if present else 1
        if scale != 1:
            out[i] = out[i] / scale
    synced = _rebuild(out, names)
    if res_leaves is not None:
        return synced, _rebuild(res_leaves, names)
    return synced
