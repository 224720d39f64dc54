"""Sparse gradient collectives: allreduce as an allgather of slices.

Counterpart of ``horovod_tpu/ops/sparse.py``: ``sparse_allreduce``
(``:130-154``), ``sparse_allreduce_eager`` (``:157``) and ``densify``
(``:94``), on torch sparse COO tensors, as ``nn.Embedding(sparse=True)``
makes them (the JAX package's ``IndexedSlices``: indices along dim 0 and
their rows).  Every member's indices and rows are gathered, in rank
order (reference ``tensorflow/__init__.py:95-162``); Average divides
the rows by the set's size; duplicate indices stay duplicated and sum
on :func:`densify`.  Each rank touches its own number of rows, so the
gathers are ``ops/eager.py`` ``allgather_v`` (the row counts first: a
host wait, which refuses under a CUDA graph's capture).

A compressed ``HVD_TPU_XIR_WIRE`` on the rows follows
``parallel/wire.py``'s rule for a shuffle (the gathered rows are a
shuffle, not a sum): int8/fp8, and bf16 on a bf16 payload, ride dense;
bf16 on a float32 payload raises, naming ROADMAP Queue A entry
A12 (rest), where the JAX package casts them through its exchange IR.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..process_sets import resolve
from .collectives import Average, Sum


def densify(grad: torch.Tensor) -> torch.Tensor:
    """A sparse COO tensor as a dense one: its rows scatter-added into
    zeros in index order (``:94``)."""
    if grad.sparse_dim() != 1:
        return grad.to_dense()
    out = torch.zeros(grad.shape, dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, grad._indices()[0], grad._values())


def _gather(t: torch.Tensor, process_set, name: Optional[str]):
    from ..parallel.wire import dense_shuffle
    from . import eager

    values = t._values()
    dense_shuffle("the sparse allreduce's rows", values.dtype)
    idx = eager.allgather_v(t._indices()[0].contiguous(), process_set=process_set,
                            name=name)
    vals = eager.allgather_v(values.contiguous(), process_set=process_set, name=name)
    return idx, vals


def _members(process_set) -> int:
    from .. import runtime

    ps = resolve(process_set)
    return runtime.size() if ps is None else len(ps.ranks)


def sparse_allreduce(t: torch.Tensor, op: int = Average, process_set=None,
                     name: Optional[str] = None) -> torch.Tensor:
    """Allreduce of a sparse COO tensor ``t`` (sparse along dim 0) by an
    allgather of its indices and rows; Average divides the gathered rows
    by the set's size in float32.  Returns an uncoalesced sparse COO
    tensor of ``t``'s shape; a non-member of ``process_set`` gets no
    rows (an empty one)."""
    if op not in (Average, Sum):
        raise ValueError("sparse_allreduce supports op=Average or Sum")
    if not t.is_sparse or t.sparse_dim() != 1:
        raise ValueError("sparse_allreduce takes a sparse COO tensor sparse along dim 0")
    idx, vals = _gather(t, process_set, name)
    if op == Average:
        vals = (vals.float() / _members(process_set)).to(t.dtype)
    return torch.sparse_coo_tensor(idx.view(1, -1), vals, t.shape, check_invariants=False)


def sparse_allreduce_eager(t: torch.Tensor, average: bool = True, process_set=None,
                           name: Optional[str] = None) -> torch.Tensor:
    """The eager form (``:157``, reference ``torch/mpi_ops.py``
    ``sparse_allreduce_async``): this rank's sparse tensor in, every
    member's slices out, the rows divided by the set's size when
    ``average`` (in the rows' dtype, as the JAX eager form divides)."""
    if not t.is_sparse or t.sparse_dim() != 1:
        raise ValueError("sparse_allreduce_eager takes a sparse COO tensor sparse along "
                         "dim 0")
    idx, vals = _gather(t, process_set, name)
    if average:
        vals = vals / _members(process_set)
    return torch.sparse_coo_tensor(idx.view(1, -1), vals, t.shape, check_invariants=False)
