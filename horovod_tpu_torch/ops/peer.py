"""The peer window of the quantized ring kernels B6 and B7.

On the TPU the runtime provides what ``_rs_ring_tpu`` and
``_ag_ring_tpu`` (``horovod_tpu/ops/pallas_quant.py:477``, ``:563``)
write into: receive slots in every chip's VMEM and a barrier semaphore
per ``collective_id``.  Here each rank owns one window of device memory
(``csrc/quant_ring.cu`` ``hvd_ring_window_bytes`` gives its layout): two
epoch-parity sets of ``n - 1`` receive slots, each sized for a chunk of
the largest payload the ring serves (``CAP`` over ``n``), then one flag
per (parity, slot, stripe).  The kernels need no barrier word: the
previous launch proves the slots free (``quant_ring.cu``).

:meth:`PeerWindow.world` makes the window of a world of processes, once,
on first use: every rank ``cudaMalloc``s and zeroes its window and
exports a CUDA IPC handle; the handles are all-gathered over the process
group and every rank opens its peers' with
``cudaIpcMemLazyEnablePeerAccess``, so the kernels store into a peer's
slots through its pointer, over NVLink.  :meth:`PeerWindow.virtual`
makes the windows of ``n`` ranks on one card, for the one-card checks,
which launch every rank's blocks in one grid.  A refused IPC call raises
with the CUDA error.  :meth:`close` (``runtime.shutdown()`` calls it)
closes the mappings and frees the windows.

Every launch takes the next epoch; the kernels' flags hold epochs, so
nothing is reset between launches, and every rank counts the same
epochs because every rank runs the same collectives.  The epoch lives on
the card, one 32-bit word per launched rank (``epochs``, zero at first,
made with the window and freed by :meth:`close`), and each launch
advances it there before the ring kernel reads it (``csrc/quant_ring.cu``
``bump_epochs``): a launch captured into a CUDA graph takes a new epoch
on every replay, and eager launches go on from where the replays left
it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch
import torch.distributed as dist

from .. import runtime
from . import build

# Largest per-rank packed payload, n·(c + 4·c/block) bytes, the ring
# serves: the reference's ``_TPU_VMEM_CAP`` (``pallas_quant.py:64``),
# which ``mosaic_quant.py:81`` keeps for the GPU family too, so the two
# lowerings take the ring for the same buckets.
CAP = 8 * 1024 * 1024
# Ranks of one window: the kernels' pointer tables (kMaxRanks).
MAX_RANKS = 16


def library() -> ctypes.CDLL:
    """``csrc/quant_ring.cu``, built on first use."""
    lib = build.load("quant_ring")
    if lib.hvd_rs_ring.argtypes is None:
        vp, pp, i, ll = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                         ctypes.c_int, ctypes.c_longlong)
        f, d = ctypes.c_float, ctypes.c_double
        lib.hvd_ring_error_string.argtypes = [i]
        lib.hvd_ring_error_string.restype = ctypes.c_char_p
        lib.hvd_ring_window_bytes.argtypes = [i, ll]
        lib.hvd_ring_window_bytes.restype = ll
        lib.hvd_ring_slot_align.argtypes = []
        lib.hvd_ring_slot_align.restype = ll
        lib.hvd_ring_alloc.argtypes = [ll, ctypes.POINTER(vp)]
        lib.hvd_ring_free.argtypes = [vp]
        lib.hvd_ring_handle_size.argtypes = []
        lib.hvd_ring_export.argtypes = [vp, ctypes.c_char_p]
        lib.hvd_ring_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(vp)]
        lib.hvd_ring_close.argtypes = [vp]
        lib.hvd_rs_ring.argtypes = [pp, pp, pp, pp, i, i, i, ll, i, i, f, vp, ll,
                                    d, vp]
        lib.hvd_ag_ring.argtypes = [pp, pp, pp, i, i, i, ll, i, i, f, vp, ll, d,
                                    vp]
        # B6's and B7's per-block timeline buffers, for chip_smoke.py.
        for fn in (lib.hvd_rs_ring_trace, lib.hvd_ag_ring_trace):
            fn.argtypes = [vp]
            fn.restype = None
        for fn in (lib.hvd_ring_alloc, lib.hvd_ring_free, lib.hvd_ring_handle_size,
                   lib.hvd_ring_export, lib.hvd_ring_open, lib.hvd_ring_close,
                   lib.hvd_rs_ring, lib.hvd_ag_ring):
            fn.restype = i
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise with the CUDA error's name if ``rc`` is not 0."""
    if rc != 0:
        name = lib.hvd_ring_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: cudaError {rc} ({name})")


def slot_bytes(n: int) -> int:
    """Bytes of one receive slot: a chunk of a ``CAP`` payload."""
    align = int(library().hvd_ring_slot_align())
    per_rank = -(-CAP // n)
    return -(-per_rank // align) * align


class PeerWindow:
    """Every rank's window, as this process addresses it.

    ``bases[r]`` is rank r's window (this process's own, or a peer's
    mapped through IPC); ``ranks`` are the ranks this process launches
    (its own rank in a world, all n for virtual ranks); ``epochs`` is the
    address of their epoch words on the card, ``ranks[i]``'s at byte
    4·i."""

    def __init__(self, device: torch.device, n: int, ranks: List[int],
                 bases: List[int], slot: int, owned: List[int],
                 opened: List[int], group_barrier: bool):
        self.device = device
        self.n = n
        self.ranks = ranks
        self.bases = bases
        self.slot_bytes = slot
        self._owned = owned
        self._opened = opened
        self._group_barrier = group_barrier
        with torch.cuda.device(device):
            self.epochs = _alloc(library(), 4 * len(ranks))

    @classmethod
    def virtual(cls, n: int, device: Optional[torch.device] = None) -> "PeerWindow":
        """``n`` ranks' windows on one card, for one-card checks."""
        _check_size(n)
        device = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        lib = library()
        slot = slot_bytes(n)
        owned: List[int] = []
        try:
            with torch.cuda.device(device):
                for _ in range(n):
                    owned.append(_alloc(lib, lib.hvd_ring_window_bytes(n, slot)))
            return cls(device, n, list(range(n)), list(owned), slot, owned, [], False)
        except RuntimeError:
            with torch.cuda.device(device):
                for p in owned:
                    lib.hvd_ring_free(p)
            raise

    @classmethod
    def world(cls, rt) -> "PeerWindow":
        """The window of ``rt``'s world (a ``runtime.Runtime`` on CUDA):
        allocate this rank's, exchange IPC handles, open the peers'.
        Collective: every rank calls it at the same point."""
        n, rank, device = rt.size, rt.rank, rt.device
        _check_size(n)
        runtime.refuse_in_capture("the peer window's IPC handle exchange")
        lib = library()
        slot = slot_bytes(n)
        handle = ctypes.create_string_buffer(lib.hvd_ring_handle_size())
        with torch.cuda.device(device):
            own = _alloc(lib, lib.hvd_ring_window_bytes(n, slot))
            opened: List[int] = []
            try:
                check(lib, lib.hvd_ring_export(own, handle), "cudaIpcGetMemHandle")
                handles = [None] * n
                dist.all_gather_object(handles, handle.raw)
                bases = []
                for r, h in enumerate(handles):
                    if r == rank:
                        bases.append(own)
                        continue
                    ptr = ctypes.c_void_p()
                    check(lib, lib.hvd_ring_open(h, ctypes.byref(ptr)),
                          f"cudaIpcOpenMemHandle of rank {r}'s window on rank {rank}")
                    opened.append(ptr.value)
                    bases.append(ptr.value)
                return cls(device, n, [rank], bases, slot, [own], opened, True)
            except BaseException:
                for p in opened:
                    lib.hvd_ring_close(p)
                lib.hvd_ring_free(own)
                raise

    def close(self) -> None:
        """Close the peers' mappings, wait for every rank to have done so,
        then free this process's windows and epoch words.  Idempotent."""
        if not self._owned and not self._opened and not self.epochs:
            return
        lib = library()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            for p in self._opened:
                check(lib, lib.hvd_ring_close(p), "cudaIpcCloseMemHandle")
            self._opened = []
            if self._group_barrier and dist.is_initialized():
                dist.barrier()
            for p in self._owned + [self.epochs]:
                check(lib, lib.hvd_ring_free(p), "cudaFree")
            self._owned, self.epochs = [], 0


def _check_size(n: int) -> None:
    if not 2 <= n <= MAX_RANKS:
        raise ValueError(f"a peer window serves 2 to {MAX_RANKS} ranks, not {n}")


def _alloc(lib: ctypes.CDLL, nbytes: int) -> int:
    ptr = ctypes.c_void_p()
    check(lib, lib.hvd_ring_alloc(nbytes, ctypes.byref(ptr)),
          f"cudaMalloc of a {nbytes}-byte peer window")
    return ptr.value


def world_window(rt) -> PeerWindow:
    """``rt``'s window, made on first use and released by its shutdown."""
    if rt.peer_window is None:
        rt.peer_window = PeerWindow.world(rt)
    return rt.peer_window
