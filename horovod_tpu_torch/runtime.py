"""Process runtime on ``torch.distributed``.

Counterpart of ``horovod_tpu/runtime.py`` (``init`` ``:258``,
``shutdown``) and of the rank, size, local and cross queries of
``horovod_tpu/__init__.py`` (``:121-168``).  Where the JAX runtime
builds a device mesh, this one joins a ``torch.distributed`` process
group: NCCL for ``device="cuda"`` (the default), gloo for
``device="cpu"``.  At ``init`` every rank's host name and card are
gathered once: they give ``local_size``, ``cross_rank`` and
``cross_size`` (ranks on one host, the host's index in order of first
rank, the number of hosts), and tell the quantized wire whether its
NVLink ring can serve the world (``ops/quantized.py``).

Rank and world size come from ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
as a launcher such as ``torchrun`` sets them (with ``MASTER_ADDR`` /
``MASTER_PORT`` for the ``env://`` rendezvous), or from an explicit
``init_method``.  With none of them set, the world is this one process,
joined through an in-process store: no port is opened.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import weakref
from typing import Any, List, Optional, Union

import torch
import torch.distributed as dist

from .exceptions import NotInitializedError

# The process group's timeout when ``init`` is given none.
DEFAULT_TIMEOUT_S = 300.0


class Runtime:
    """One process's place in the world and the device it computes on."""

    def __init__(self, device: torch.device, rank: int, size: int,
                 local_rank: int, owns_group: bool, backend: str,
                 hosts: Optional[List[str]] = None,
                 cards: Optional[List[str]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.device = device
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.backend = backend
        # How long a collective waits for a late peer: the process
        # group's timeout, and the bound of the ring kernels' spins.
        self.timeout_s = timeout_s
        self._owns_group = owns_group
        # Per rank: host name, and the card's UUID ("" on the CPU).
        self.hosts = hosts or [socket.gethostname()] * size
        self.cards = cards or [_card_id(device)] * size
        order = list(dict.fromkeys(self.hosts))
        self.local_size = self.hosts.count(self.hosts[rank])
        self.cross_rank = order.index(self.hosts[rank])
        self.cross_size = len(order)
        # The quantized wire's ring: whether every pair of the world's
        # cards reaches each other's memory (asked once, on first use),
        # and the peer window (``ops/peer.py``), mapped on first use and
        # released by shutdown().
        self.peers_reach: Optional[bool] = None
        self.peer_window = None
        # The TrainSteps holding a captured CUDA graph, dropped at
        # shutdown: a graph that captured NCCL operations keeps its
        # communicator alive, and destroying the group waits for it.
        self.captured_steps: "weakref.WeakSet" = weakref.WeakSet()

    def shutdown(self) -> None:
        for step in list(self.captured_steps):
            step.drop()
        if self.peer_window is not None:
            self.peer_window.close()
            self.peer_window = None
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()


_runtime: Optional[Runtime] = None
_runtime_lock = threading.Lock()


def _card_id(device: torch.device) -> str:
    """A card's UUID, the same in every process; "" for the CPU."""
    if device.type != "cuda":
        return ""
    return str(torch.cuda.get_device_properties(device).uuid)


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return None if val in (None, "") else int(val)


def init(
    device: Union[str, torch.device] = "cuda",
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent).

    ``device="cuda"`` needs a card: it raises when
    ``torch.cuda.is_available()`` is false, and pins this process to
    card ``LOCAL_RANK`` modulo the number of cards (ranks beyond it share
    cards).  ``device="cpu"`` runs gloo, as the tests do.
    ``rank``/``size`` override ``RANK``/``WORLD_SIZE``.  ``backend`` is
    the process group's: NCCL on ``cuda`` and gloo on ``cpu`` by
    default; NCCL refuses two ranks on one card, gloo serves them.  An
    already initialized default process group is adopted and left to
    its owner.  ``timeout_s`` bounds how long a collective waits for a
    late peer: the process group's timeout, and every spin of the
    quantized ring's kernels (``ops/ring_kernels.py``).
    """
    global _runtime
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    with _runtime_lock:
        if _runtime is not None:
            if _runtime.device.type != dev.type:
                raise RuntimeError(
                    f"already initialized on {_runtime.device}; call "
                    "shutdown() before init() on another device"
                )
            return
        rank = _env_int("RANK") if rank is None else rank
        size = _env_int("WORLD_SIZE") if size is None else size
        local_rank = _env_int("LOCAL_RANK")
        if (rank is None) != (size is None):
            raise ValueError("set both RANK and WORLD_SIZE, or neither")
        rank = 0 if rank is None else rank
        size = 1 if size is None else size
        if local_rank is None:
            local_rank = rank  # one host
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init(device='cuda') needs a CUDA "
                    "device; pass device='cpu' to run on the CPU"
                )
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        owns = not dist.is_initialized()
        if owns:
            timeout = datetime.timedelta(seconds=timeout_s)
            if init_method is not None or size > 1:
                dist.init_process_group(
                    backend, init_method=init_method or "env://",
                    rank=rank, world_size=size, timeout=timeout,
                )
            else:
                dist.init_process_group(
                    backend, store=dist.HashStore(), rank=0, world_size=1,
                    timeout=timeout,
                )
        else:
            rank, size = dist.get_rank(), dist.get_world_size()
            backend = dist.get_backend()
        hosts = cards = None
        if size > 1:
            places = [None] * size
            dist.all_gather_object(places, (socket.gethostname(), _card_id(dev)))
            hosts, cards = [p[0] for p in places], [p[1] for p in places]
        _runtime = Runtime(dev, rank, size, local_rank, owns, backend, hosts, cards,
                           timeout_s)


def shutdown() -> None:
    """Leave the process group this runtime created (idempotent)."""
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def get_runtime() -> Runtime:
    rt = _runtime
    if rt is None:
        raise NotInitializedError()
    return rt


def rank() -> int:
    return get_runtime().rank


def size() -> int:
    return get_runtime().size


def local_rank() -> int:
    return get_runtime().local_rank


def local_size() -> int:
    """Ranks on this rank's host."""
    return get_runtime().local_size


def cross_rank() -> int:
    """This rank's host's index, hosts numbered in order of first rank."""
    return get_runtime().cross_rank


def cross_size() -> int:
    """Number of hosts in the world."""
    return get_runtime().cross_size


def device() -> torch.device:
    return get_runtime().device


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def refuse_in_capture(what: str) -> None:
    """Raise if a CUDA graph is being captured: ``what`` waits on the host
    (a host collective), which a graph cannot hold."""
    if capturing():
        raise RuntimeError(
            f"{what} waits on the host and cannot run while a CUDA graph is "
            "captured: call it before or after the capture (TrainStep's eager "
            "warm-up steps make its host collectives before it captures; "
            "HVD_TPU_ONESTEP, ROADMAP Queue A item A12a)"
        )


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """Pickle ``obj`` on ``root_rank`` and return it on every rank."""
    rt = get_runtime()
    if rt.size == 1:
        return obj
    refuse_in_capture("broadcast_object")
    box = [obj]
    dist.broadcast_object_list(
        box, src=root_rank,
        device=rt.device if rt.backend == "nccl" else None,
    )
    return box[0]
