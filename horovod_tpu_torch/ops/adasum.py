"""Adasum: adaptive summation allreduce.

Counterpart of ``horovod_tpu/ops/adasum.py`` in the per-rank call
shape: ``_adasum_pair`` (``:47``), ``_bitrev``, ``_vhdd_over_groups``
(``:79``), ``_hierarchical_adasum`` (``:206``) and ``adasum_allreduce``
(``:256``).  For a pair of gradients a, b the combination

    a' = (1 - dot(a,b) / (2*||a||^2)) * a + (1 - dot(a,b) / (2*||b||^2)) * b

is scale-invariant (orthogonal gradients add, parallel ones average);
a zero norm gives a plain sum (``:53-55``).  It is applied over a binary
tree of the set's ranks by vector-halving / distance-doubling:

* non-power-of-two sets first fold each straggler (members ``p..k-1``,
  p the largest power of two <= k) into a core member by one pair
  exchange;
* level l exchanges half of the current segment with partner
  ``i XOR 2^l`` (paired ``isend``/``irecv``, posted together on every
  rank, through host memory under gloo on a card), so each rank moves
  O(V) in all;
* the pair coefficients need the dot products and norms of the whole
  subtree vectors, which after halving lie across the merging group: one
  slotted ``(groups, 3)`` float32 all_reduce per level over the set
  supplies them (the reference's ``SumAllreduceWithComm``), and the
  coefficients are computed on the device, with no host read;
* one all_gather and the bit-reversed row order rebuild the vector.

The wire carries the input dtype; only the scalars are float32
(``:294-296``), as the reference's fp16 kernels accumulate in fp32.
Non-members of a process set keep their input.  The point-to-point
hops refuse under a CUDA graph's capture (``runtime.refuse_in_capture``),
as the mesh's do: a step with a flat Adasum exchange runs eagerly
(``optim/distributed_optimizer.py`` ``capture_blocker``); the
hierarchical ``hier_adasum`` lowering (``topo/hierarchical.py``) has
collectives only.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import runtime
from ..process_sets import member_group, resolve
from ..utils import env


def coefficients(sums: torch.Tensor):
    """``(ca, cb)`` of each row ``[dot, |a|², |b|²]`` (the last dim):
    ``1 - dot/(2|a|²)`` and ``1 - dot/(2|b|²)``, 1 where the norm is zero
    (a plain sum), on the device."""
    dot, na, nb = sums[..., 0], sums[..., 1], sums[..., 2]
    one = torch.ones_like(dot)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * na), one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * nb), one)
    return ca, cb


def _adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Adasum of two whole vectors, in float32, back to ``a``'s dtype."""
    af, bf = a.float(), b.float()
    ca, cb = coefficients(torch.stack([torch.sum(af * bf), torch.sum(af * af),
                                       torch.sum(bf * bf)]))
    return (ca * af + cb * bf).to(a.dtype)


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


_JOINED: set = set()


def _join(group, device) -> None:
    """One all_reduce on ``group`` before its first point-to-point hop:
    NCCL wants every member in a group's first batched send/receive,
    and a fold or a tree level leaves some out."""
    key = (id(group), device.type)
    if key not in _JOINED:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        _JOINED.add(key)


def _exchange(send: torch.Tensor, partner: int, group) -> torch.Tensor:
    """Send ``send`` to global rank ``partner`` and receive its half, the
    two posted together (``parallel/ring_attention.py`` ``_post``: under
    gloo on a card through host buffers, copied back without autograd)."""
    from ..parallel.ring_attention import _post

    recv = torch.empty_like(send)
    for w in _post([send.contiguous()], [recv], partner, partner, group):
        w.wait()
    return recv


def _slot_sum(nslots: int, slot: Optional[int], scalars: Optional[torch.Tensor],
              group, device) -> torch.Tensor:
    """The slotted all_reduce: a ``(nslots, 3)`` float32 zero table with
    this rank's scalars in row ``slot`` (none off the tree), summed over
    ``group``."""
    table = torch.zeros((nslots, 3), dtype=torch.float32, device=device)
    if slot is not None:
        table[slot] = scalars
    dist.all_reduce(table, op=dist.ReduceOp.SUM, group=group)
    return table


def _tree(y: torch.Tensor, my: int, p: int, levels: int, core: List[int],
          pair_group, scal_group) -> torch.Tensor:
    """The VHDD levels over the ``p`` core members (global ranks
    ``core``; this rank at position ``my``, or ``my >= p`` off the tree,
    which only joins the scalar sums with zeros).  ``y`` is this rank's
    padded segment; returns its final ``1/p`` segment."""
    dtype = y.dtype
    on_tree = my < p
    for level in range(levels):
        d = 1 << level
        nmerge = p // (2 * d)
        if not on_tree:
            _slot_sum(nmerge, None, None, scal_group, y.device)
            continue
        half = y.shape[0] // 2
        bit = (my >> level) & 1
        keep = y[bit * half:(bit + 1) * half]
        send = y[(1 - bit) * half:(2 - bit) * half]
        recv = _exchange(send, core[my ^ d], pair_group)
        keep32, recv32 = keep.float(), recv.float()
        dot = torch.sum(keep32 * recv32)
        n_keep, n_recv = torch.sum(keep32 * keep32), torch.sum(recv32 * recv32)
        # Lower-half ranks (bit 0) hold the "a" pieces of their pair.
        scal = torch.stack([dot, n_keep, n_recv] if bit == 0 else [dot, n_recv, n_keep])
        merge = my // (2 * d)
        ca, cb = coefficients(_slot_sum(nmerge, merge, scal, scal_group, y.device)[merge])
        c_keep, c_recv = (ca, cb) if bit == 0 else (cb, ca)
        y = (c_keep * keep32 + c_recv * recv32).to(dtype)
    return y


def _host_grid():
    """``(local_groups, cross_groups)`` of a homogeneous multi-host world
    (``ops/traced.py`` ``host_groups``: each host's ranks, and the i-th
    rank of every host), or None."""
    rt = runtime.get_runtime()
    L, H = rt.local_size, rt.cross_size
    if L <= 1 or H <= 1 or L * H != rt.size:
        return None
    by_host: dict = {}
    for r, h in enumerate(rt.hosts):
        by_host.setdefault(h, []).append(r)
    local_groups = list(by_host.values())
    if len(local_groups) != H or any(len(g) != L for g in local_groups):
        return None
    return local_groups, [[g[i] for g in local_groups] for i in range(L)]


def _topo_slice_grid():
    """``(local_groups, cross_groups)`` of a multi-domain topology
    (``topo/model.py``, ``HVD_TPU_TOPO`` included), or None."""
    from ..exceptions import HorovodTpuError
    from ..topo import model as topo_model

    topo = topo_model.current()
    n = runtime.size()
    if topo.factor_axis(n)[0] == 1:
        return None
    try:
        return topo.axis_groups(n)
    except HorovodTpuError:
        return None


def _vhdd_over_groups(v: torch.Tensor, ctx) -> torch.Tensor:
    """VHDD Adasum across the rails (``:79``): this rank's rail is its
    cross group, which holds shard i of every host's vector; each rail
    runs the halving exchanges on its own shard, but the per-level
    scalars of every rail and merge member are summed together in one
    slotted all_reduce over the world, so the coefficients are those of
    the full vectors and the sharded result is the Adasum of the
    unsharded host vectors."""
    rail, pair_group = ctx.cross_ranks, ctx.cross
    k = len(rail)
    if k == 1:
        return v
    p = 1 << (k.bit_length() - 1)
    extras, levels = k - p, p.bit_length() - 1
    my = rail.index(runtime.rank())
    _join(pair_group, v.device)
    dtype, size = v.dtype, v.numel()
    seg = -(-size // p)
    y = F.pad(v, (0, seg * p - size)) if seg * p != size else v
    if extras:
        fold = my < extras
        if my >= p:  # a straggler hands its vector to its core partner
            _exchange(y, rail[my - p], pair_group)
        elif fold:
            recv = _exchange(y, rail[p + my], pair_group)
        scal = None
        if fold:
            y32, r32 = y.float(), recv.float()
            scal = torch.stack([torch.sum(y32 * r32), torch.sum(y32 * y32),
                                torch.sum(r32 * r32)])
        sums = _slot_sum(extras, my if fold else None, scal, None, y.device)
        if fold:
            ca, cb = coefficients(sums[my])
            y = (ca * y32 + cb * r32).to(dtype)
    y = _tree(y, my, p, levels, rail, pair_group, None)
    if my >= p:  # off the tree: its segment is not gathered
        y = y.new_zeros((seg,))
    gathered = y.new_empty((k * y.shape[0],))
    from .collectives import _all_gather

    _all_gather(gathered, y.contiguous(), group=pair_group)
    rows = gathered.view(k, -1)[[_bitrev(j, levels) for j in range(p)]]
    return rows.reshape(-1)[:size]


def _hierarchical_adasum(x: torch.Tensor) -> Optional[torch.Tensor]:
    """Intra-host sum + cross-host Adasum (``:206``, the reference's
    ``AdasumGpuAllreduceOp``): an intra-host reduce-scatter, the
    cross-host VHDD Adasum of each rail's shard, an intra-host all-gather
    and the division by the host's size, so the result is the Adasum of
    per-host *average* gradients.  The grid is the hosts', else the
    topology's domains (a forced ``HVD_TPU_TOPO`` included); None when
    neither is a grid (the caller runs the flat tree)."""
    from ..topo import hierarchical

    grid = _host_grid() or _topo_slice_grid()
    if grid is None:
        return None
    local_groups, cross_groups = grid
    L = len(local_groups[0])
    ctx = hierarchical.grid_context(local_groups, cross_groups)
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % L
    if pad:
        flat = F.pad(flat, (0, pad))
    shard = hierarchical.ici_reduce_scatter_phase(flat, ctx)
    reduced = _vhdd_over_groups(shard, ctx)
    out = hierarchical.ici_all_gather_phase(reduced, ctx)
    return (out[:size] / L).to(dtype).view(shape)


def adasum_allreduce(x: torch.Tensor, process_set=None,
                     hierarchical: Optional[bool] = None) -> torch.Tensor:
    """Adasum of every member's ``x`` (``:256``), returned on every member;
    a non-member of ``process_set`` gets ``x`` back.  Any set size works
    (stragglers fold in first).  ``hierarchical`` (default:
    ``HVD_TPU_HIERARCHICAL_ALLREDUCE``) takes the two-level schedule on a
    host grid or a multi-domain topology, for the world only; elsewhere
    the flat tree."""
    if hierarchical is None:
        hierarchical = env.get_bool(env.HIERARCHICAL_ALLREDUCE, False)
    ps = resolve(process_set)
    if hierarchical and ps is None:
        y = _hierarchical_adasum(x)
        if y is not None:
            return y
    group, ranks, member = member_group(ps)
    if ranks is None:
        ranks = list(range(runtime.size()))
    k = len(ranks)
    if not member or k == 1:
        return x
    runtime.refuse_in_capture("Adasum's point-to-point exchange")
    _join(group, x.device)
    p = 1 << (k.bit_length() - 1)
    extras, levels = k - p, p.bit_length() - 1
    my = list(ranks).index(runtime.rank())
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    size = flat.numel()
    seg = -(-size // p)
    y = F.pad(flat, (0, seg * p - size)) if seg * p != size else flat.clone()

    # Fold: the extras pair-combine into the first `extras` cores.
    if extras:
        if my >= p:
            _exchange(y, ranks[my - p], group)
        elif my < extras:
            y = _adasum_pair(y, _exchange(y, ranks[p + my], group))

    y = _tree(y, my, p, levels, list(ranks[:p]), group, group)
    if my >= p:  # off the tree: its segment is not gathered
        y = y.new_zeros((seg,))
    from .collectives import _all_gather

    gathered = y.new_empty((k * y.shape[0],))
    _all_gather(gathered, y.contiguous(), group=group)
    rows = gathered.view(k, -1)[[_bitrev(j, levels) for j in range(p)]]
    return rows.reshape(-1)[:size].view(shape).to(dtype)
