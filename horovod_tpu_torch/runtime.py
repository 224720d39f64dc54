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

The process-set table (``process_sets.py``) lives on the runtime: sets
passed as ``init(process_sets=[...])`` or in ``HVD_TPU_PROCESS_SETS``
are registered, with their groups, before ``init`` returns
(``horovod_tpu/runtime.py:68-80``).
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import weakref
from typing import Any, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .exceptions import NotInitializedError
from .process_sets import ProcessSet, ProcessSetTable
from .utils import env

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
        # The quantized wire's explicit groups= (ops/quantized.py): one
        # torch.distributed group per tile, made on every rank at first
        # use, by the tiles.
        self.wire_groups: dict = {}
        # The hierarchical collectives' intra and cross groups
        # (topo/hierarchical.py), per factored layout: made on every rank
        # the first time the layout is asked for.
        self.topo_groups: dict = {}
        # A gloo group over the world for host-side agreement on an NCCL
        # world (host_group()), made on every rank at first use.
        self.host_group = None
        self.process_set_table = ProcessSetTable(
            size, rank,
            new_group=(lambda ranks: dist.new_group(
                ranks, timeout=datetime.timedelta(seconds=timeout_s)))
            if size > 1 else None,
            destroy=dist.destroy_process_group,
        )

    def register_sets(self, process_sets: Sequence[ProcessSet]) -> None:
        """Register ``process_sets`` and those of ``HVD_TPU_PROCESS_SETS``
        ("0,1;2,3"), in that order, on every rank alike."""
        for ps in process_sets:
            self.process_set_table.add(ps, dynamic_ok=True)
        spec = env.get_env(env.PROCESS_SETS)
        if spec:
            for group in spec.split(";"):
                ranks = [int(r) for r in group.split(",") if r.strip()]
                if ranks:
                    self.process_set_table.add(ProcessSet(ranks), dynamic_ok=True)

    def drop_captured(self, process_set_id: Optional[int] = None) -> None:
        """Drop every captured step, or those whose key holds the set
        ``process_set_id``: a graph that captured NCCL operations on a
        group keeps its communicator alive."""
        for step in list(self.captured_steps):
            if process_set_id is None or step.holds_set(process_set_id):
                step.drop()

    def shutdown(self) -> None:
        self.drop_captured()
        if self.peer_window is not None:
            self.peer_window.close()
            self.peer_window = None
        if dist.is_initialized():
            self.process_set_table.close()
            for tiles, made in self.wire_groups.items():
                for ranks, group in zip(tiles, made):
                    if group is not None and self.rank in ranks:
                        dist.destroy_process_group(group)
            self.wire_groups = {}
            for made in self.topo_groups.values():
                for kind in ("intra", "cross"):
                    dist.destroy_process_group(made[kind][0])
            self.topo_groups = {}
            if self.host_group is not None:
                dist.destroy_process_group(self.host_group)
                self.host_group = None
            if self._owns_group:
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
    process_sets: Optional[Union[str, Sequence[ProcessSet]]] = None,
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

    ``process_sets`` registers rank subsets up front, every rank the
    same (reference ``horovod_init_multi_comm``), or is the string
    ``"dynamic"``, which sets ``HVD_TPU_DYNAMIC_PROCESS_SETS=1`` so that
    ``add_process_set`` may register sets later (``:277-284``).
    """
    global _runtime
    if isinstance(process_sets, str):
        if process_sets.lower() != "dynamic":
            raise ValueError(
                f"process_sets={process_sets!r}: only 'dynamic' or a "
                "sequence of ProcessSet is accepted"
            )
        env.set_env(env.DYNAMIC_PROCESS_SETS, "1")
        process_sets = None
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
        rt = Runtime(dev, rank, size, local_rank, owns, backend, hosts, cards,
                     timeout_s)
        rt.register_sets(process_sets or ())
        _runtime = rt


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


def host_group():
    """The world's group for a collective of host tensors that must not
    wait for the card: the process group itself on gloo, else a gloo
    group made on every rank the first time it is asked for (every rank
    must ask at the same point of its program)."""
    rt = get_runtime()
    if rt.backend == "gloo":
        return None
    if rt.host_group is None:
        rt.host_group = dist.new_group(backend="gloo")
    return rt.host_group


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


def is_homogeneous() -> bool:
    """True when every host runs the same number of ranks (reference
    ``horovod_is_homogeneous``)."""
    rt = get_runtime()
    return rt.size == rt.local_size * rt.cross_size


# Capability flags (reference ``common/basics.py`` ``*_built`` /
# ``*_enabled``), answered by this PyTorch build and the runtime.

def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_available() and dist.is_gloo_available()


def gloo_enabled() -> bool:
    """Whether the runtime's process group runs gloo."""
    return is_initialized() and get_runtime().backend == "gloo"


def nccl_built() -> bool:
    return dist.is_available() and dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def xla_built() -> bool:
    return False


def tpu_enabled() -> bool:
    return False


# Process sets (reference ``common/process_sets.py``).

def add_process_set(ranks_or_set) -> ProcessSet:
    """Register a set after init, on every rank alike (needs
    ``HVD_TPU_DYNAMIC_PROCESS_SETS=1`` or ``init(process_sets="dynamic")``);
    the ranks of a set already registered return that set."""
    ps = ranks_or_set if isinstance(ranks_or_set, ProcessSet) else ProcessSet(ranks_or_set)
    return get_runtime().process_set_table.add(ps)


def remove_process_set(ps: ProcessSet) -> None:
    """Unregister ``ps`` on every rank alike: first drop every captured
    step whose key holds it, then destroy its groups.  The global set
    and an unknown set raise."""
    rt = get_runtime()
    if ps.process_set_id not in (None, 0):
        rt.drop_captured(ps.process_set_id)
    rt.process_set_table.remove(ps)


def get_process_set_ids() -> List[int]:
    return get_runtime().process_set_table.ids()


def global_process_set() -> ProcessSet:
    return get_runtime().process_set_table.global_set
