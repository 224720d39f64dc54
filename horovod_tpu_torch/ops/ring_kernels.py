"""Kernels B6 (quantized reduce-scatter ring) and B7 (quantized
all-gather ring), and their plain PyTorch versions.

Counterpart of ``horovod_tpu/ops/pallas_quant.py`` ``_rs_ring_tpu``
(``:477``, body ``_rs_ring_kernel`` ``:371``) and ``_ag_ring_tpu``
(``:563``, body ``_ag_ring_kernel`` ``:515``): one kernel per
collective, each contribution quantized once by its producer and stored
straight into the receiver's slot through the peer window
(``ops/peer.py``), the arrivals summed in float32 in hop order.  The
kernels are ``csrc/quant_ring.cu``, built with ``nvcc`` for ``sm_90a``
at first use and called through ctypes on PyTorch's current stream.

A wrapper takes the rows of the ranks this process launches, in the
order of ``window.ranks``: one row in a world of processes, all ``n``
for a window of virtual ranks on one card.  On a CPU tensor it computes
its plain version, which takes every rank's row at once; on a CUDA
tensor it launches its kernel or raises.  ``<wrapper>.launches`` counts
kernel launches (one per launch, whatever the number of ranks in it) as
the device runs them: a launch recorded into a CUDA graph is not counted
at capture, and is counted once on each replay (``TrainStep``,
``optim/distributed_optimizer.py``, over the wrappers in
``ops.LAUNCH_COUNTED``).

The plain versions use B3's quantization and B4's rounding
(``quant_kernels.py``): every product and every sum rounded to
float32, the sum of rank r's chunk taken in hop order, its own
contribution first, then sources r - 1, r - 2, ... (mod n), as the JAX
ring and its interpret path (``pallas_quant.py:294-309``) take it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import runtime
from . import counted, peer
from .collectives import f32_reciprocal
from .quant_kernels import WIRE_FORMATS, _WIRE_CODE, quant_math_reference



def spin_timeout_s() -> float:
    """Bound on every spin of the kernels (a slot's flag): past it the
    kernel prints which flag it waited on and traps.
    It is the process group's timeout (``init``'s ``timeout_s``), so a
    late peer is waited for as long as the reference's unbounded
    semaphore wait would be before the group itself gives up; with no
    runtime (virtual ranks on one card), ``runtime.DEFAULT_TIMEOUT_S``."""
    if runtime.is_initialized():
        return float(runtime.get_runtime().timeout_s)
    return runtime.DEFAULT_TIMEOUT_S


def _chunks(x: torch.Tensor, n: int, block: int) -> Tuple[int, int]:
    """(c, nb) of a rank's flat row of n chunks."""
    if x.shape[-1] % (n * block) != 0:
        raise ValueError(f"a row of {x.shape[-1]} elements is not n·c with c a "
                         f"multiple of the block ({n} x {block})")
    c = x.shape[-1] // n
    return c, c // block


def rs_ring_reference(x: torch.Tensor, wire: str, block: int,
                      want_deq: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of B6 for every rank of one collective: ``x`` is
    ``(n, n·c)``, row r rank r's input of n chunks.  Returns ``acc``
    ``(n, c)``, row r the sum of chunk r over the ranks in hop order, and
    with ``want_deq`` each rank's dequant of its chunks, ``(n, n, c)``."""
    n = x.shape[0]
    c, nb = _chunks(x, n, block)
    _, _, deq = quant_math_reference(x.reshape(n, n, nb, block), wire)
    acc = torch.empty(n, nb, block, dtype=torch.float32, device=x.device)
    for r in range(n):
        a = deq[r, r]
        for t in range(1, n):
            a = a + deq[(r - t) % n, r]
        acc[r] = a
    return acc.view(n, c), (deq.view(n, n, c) if want_deq else None)


def ag_ring_reference(shards: torch.Tensor, wire: str, block: int) -> torch.Tensor:
    """Plain version of B7 for every rank of one collective: ``shards``
    is ``(n, c)``, row r rank r's shard.  Returns ``(n, n·c)``: every
    rank's gathered dequant in rank order (all rows equal)."""
    n = shards.shape[0]
    c, nb = _chunks(shards, 1, block)
    _, _, deq = quant_math_reference(shards.reshape(n, nb, block), wire)
    return deq.reshape(1, n * c).repeat(n, 1)


# ---------------------------------------------------------------- CUDA


def _check(x: torch.Tensor, name: str, window, block: int, wire: str) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises on anything else."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"{name}: unknown wire {wire!r}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected (ranks, elements), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if block < 1:
        raise ValueError(f"{name}: block must be positive, got {block}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if window is None or x.device != window.device:
        raise ValueError(f"{name}: needs a peer window on {x.device}")
    if x.shape[0] != len(window.ranks):
        raise ValueError(f"{name}: {x.shape[0]} rows for the window's ranks "
                         f"{window.ranks}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    return True


# float32(1 / qmax) of each wire, the kernels' argument.
_INV_QMAX = {w: f32_reciprocal(q) for w, (_, q) in WIRE_FORMATS.items()}


def _tables(window, rows):
    """The ctypes tables of a launch: every rank's window base, and one
    table of n pointers per entry of ``rows`` (tensors of the launched
    ranks, one row each, or None) with each row's address at its rank's
    index, the rest null.  The tables are made once per window and each
    call writes its own tensors' addresses into them: the C entry copies
    them into the kernel's arguments (``RingArgs``) by value before it
    returns, so a launch captured into a CUDA graph keeps the addresses
    of its own call whatever later calls write here."""
    cached = getattr(window, "_launch_tables", None)
    if cached is None:
        n = window.n
        cached = ((ctypes.c_void_p * n)(*window.bases),
                  [(ctypes.c_void_p * n)() for _ in range(3)])
        window._launch_tables = cached
    wins, tables = cached
    ranks = window.ranks
    out = []
    for table, t in zip(tables, rows):
        if t is None:
            out.append(None)
        elif len(ranks) == 1:
            table[ranks[0]] = t.data_ptr()
            out.append(table)
        else:
            base, step = t.data_ptr(), t.stride(0) * t.element_size()
            for i, r in enumerate(ranks):
                table[r] = base + i * step
            out.append(table)
    return wins, out


def _launched(fn, lib, rc: int) -> None:
    peer.check(lib, rc, f"{fn.__name__} kernel launch")
    fn.launches += 1


def rs_ring(x: torch.Tensor, window, wire: str, block: int, want_deq: bool = False,
            timeout_s: Optional[float] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B6: ``x`` is ``(R, n·c)`` float32, one row per rank this process
    launches (``window.ranks``).  Returns ``acc`` ``(R, c)``: each rank's
    float32 sum of its chunk over the n ranks; with ``want_deq`` also
    ``(R, n, c)``: the dequant of every chunk the rank quantized, the
    error-feedback residual's input.  ``timeout_s`` bounds each spin
    (default :func:`spin_timeout_s`)."""
    if not _check(x, "rs_ring", window, block, wire):
        return rs_ring_reference(x, wire, block, want_deq)
    n, ranks = window.n, len(window.ranks)
    c, nb = _chunks(x, n, block)
    if nb * (block + 4) > window.slot_bytes:
        raise ValueError(f"rs_ring: a packed chunk of {nb * (block + 4)} bytes "
                         f"exceeds the window's {window.slot_bytes}-byte slots")
    acc = torch.empty((ranks, c), dtype=torch.float32, device=x.device)
    deq = (torch.empty((ranks, n, c), dtype=torch.float32, device=x.device)
           if want_deq else None)
    if nb == 0:
        return acc, deq
    wins, (xs, accs, deqs) = _tables(window, (x, acc, deq))
    lib = peer.library()
    with torch.cuda.device(x.device):
        rc = lib.hvd_rs_ring(
            xs, accs, deqs, wins, n, window.ranks[0], ranks, nb, block,
            _WIRE_CODE[wire], _INV_QMAX[wire],
            window.epochs, window.slot_bytes,
            spin_timeout_s() if timeout_s is None else timeout_s,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _launched(rs_ring, lib, rc)
    return acc, deq


def ag_ring(shards: torch.Tensor, window, wire: str, block: int,
            timeout_s: Optional[float] = None) -> torch.Tensor:
    """B7: ``shards`` is ``(R, c)`` float32, one shard per rank this
    process launches.  Returns ``(R, n·c)``: every rank's dequantized
    shard, in rank order.  ``timeout_s`` bounds each spin (default
    :func:`spin_timeout_s`)."""
    if not _check(shards, "ag_ring", window, block, wire):
        return ag_ring_reference(shards, wire, block)
    n, ranks = window.n, len(window.ranks)
    c, nb = _chunks(shards, 1, block)
    if nb * (block + 4) > window.slot_bytes:
        raise ValueError(f"ag_ring: a packed shard of {nb * (block + 4)} bytes "
                         f"exceeds the window's {window.slot_bytes}-byte slots")
    out = torch.empty((ranks, n * c), dtype=torch.float32, device=shards.device)
    if nb == 0:
        return out
    wins, (xs, outs) = _tables(window, (shards, out))
    lib = peer.library()
    with torch.cuda.device(shards.device):
        rc = lib.hvd_ag_ring(
            xs, outs, wins, n, window.ranks[0], ranks, nb, block,
            _WIRE_CODE[wire], _INV_QMAX[wire],
            window.epochs, window.slot_bytes,
            spin_timeout_s() if timeout_s is None else timeout_s,
            torch.cuda.current_stream(shards.device).cuda_stream,
        )
    _launched(ag_ring, lib, rc)
    return out


counted(rs_ring)
counted(ag_ring)
