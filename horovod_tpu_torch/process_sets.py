"""Process sets: collectives on subsets of ranks.

Counterpart of ``horovod_tpu/process_sets.py``: ``tiling_groups``
(``:22``), ``ProcessSet`` (``:52``) and ``ProcessSetTable`` (``:101``),
copied with their ids, errors and dynamic gate.  Where the JAX package
lowers a set to XLA replica groups or a masked collective, each
registered set here owns ``torch.distributed`` groups, as each set of
the reference owns its communicator (``common/process_set.h``):

* its members' group (``dist.new_group(ranks)``), on which the eager
  ops run (``ops/collectives.py``); the global set uses the default
  group;
* when the set tiles the world into equal groups (:func:`tiling_groups`),
  one group per tile, for the quantized wire, which reduces within
  every tile on every rank (``ops/quantized.py``); the set's own tile is
  its members' group.

``dist.new_group`` is collective over the whole world: every rank makes
every group, in the same order, non-members too.  The table makes a
set's groups when the set is registered, and every rank registers the
same sets in the same order (``init(process_sets=...)``,
``HVD_TPU_PROCESS_SETS``, then ``add_process_set`` on every rank).
Removing a set destroys the groups this rank belongs to.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from .exceptions import HorovodTpuError, ProcessSetTilingError
from .utils import env


def tiling_groups(
    ranks: Sequence[int], world_size: int, *, context: str = ""
) -> List[List[int]]:
    """Equal-size groups covering ``range(world_size)`` with ``ranks``
    as the first group: a k-rank subset tiles the world iff the other
    ``world_size - k`` ranks split into further groups of k, taken in
    rank order.  Raises :class:`ProcessSetTilingError` when they cannot."""
    members = sorted(int(r) for r in ranks)
    k = len(members)
    if k == 0 or len(set(members)) != k:
        raise ProcessSetTilingError(ranks, world_size, context)
    if members[0] < 0 or members[-1] >= world_size:
        raise ProcessSetTilingError(ranks, world_size, context)
    rest = [r for r in range(world_size) if r not in set(members)]
    if len(rest) % k != 0:
        raise ProcessSetTilingError(ranks, world_size, context)
    groups = [members]
    for i in range(0, len(rest), k):
        groups.append(rest[i : i + k])
    return groups


class ProcessSet:
    """An ordered subset of global ranks that collectives can be limited
    to: created detached with a list of ranks, given an ``id`` once
    registered (reference ``horovod/common/process_sets.py:18``)."""

    def __init__(self, ranks: Sequence[int]):
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"process set ranks must be unique, got {ranks}")
        self.ranks: tuple[int, ...] = tuple(sorted(int(r) for r in ranks))
        self.process_set_id: Optional[int] = None

    def included(self, rank: Optional[int] = None) -> bool:
        from . import runtime

        if rank is None:
            rank = runtime.get_runtime().rank
        return rank in self.ranks

    def rank(self) -> int:
        """Rank of the current global rank within this set, or -1."""
        from . import runtime

        grank = runtime.get_runtime().rank
        if grank not in self.ranks:
            return -1
        return self.ranks.index(grank)

    def size(self) -> int:
        return len(self.ranks)

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessSet) and self.ranks == other.ranks

    def __hash__(self) -> int:
        return hash(self.ranks)

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={list(self.ranks)})"


class SetGroups:
    """One registered set's ``torch.distributed`` groups, as this rank
    sees them: ``members`` (the set's group; None for the global set,
    which is the default group), ``tiles`` (the equal groups the set
    tiles the world into, or None) and ``tile``/``tile_ranks`` (the group
    of the tile this rank is in and its ranks; the set's own when this
    rank is a member)."""

    def __init__(self, members, tiles: Optional[List[List[int]]], tile,
                 tile_ranks: Optional[List[int]], owned: list):
        self.members = members
        self.tiles = tiles
        self.tile = tile
        self.tile_ranks = tile_ranks
        self.owned = owned  # the groups this rank belongs to


class ProcessSetTable:
    """Registry of process sets; id 0 is always the global set
    (reference ``common/process_set.h:26-80``).  Registering after init
    is gated by ``HVD_TPU_DYNAMIC_PROCESS_SETS``.

    ``new_group(ranks)``, when given, makes a ``torch.distributed`` group
    of ``ranks`` (collective over the world; it returns a non-member
    marker on other ranks) and ``destroy(group)`` destroys one: the
    table then keeps each set's :class:`SetGroups` (:meth:`groups`).
    Without them the table is the registry alone."""

    def __init__(self, world_size: int, rank: int = 0,
                 new_group: Optional[Callable] = None,
                 destroy: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._next_id = 0
        self._by_id: Dict[int, ProcessSet] = {}
        self._groups: Dict[int, SetGroups] = {}
        self.world_size = world_size
        self._rank = rank
        self._new_group = new_group
        self._destroy = destroy
        self.global_set = self._register(ProcessSet(range(world_size)))

    def _register(self, ps: ProcessSet) -> ProcessSet:
        for existing in self._by_id.values():
            if existing.ranks == ps.ranks:
                ps.process_set_id = existing.process_set_id
                return existing
        if ps.ranks and (ps.ranks[0] < 0 or ps.ranks[-1] >= self.world_size):
            raise HorovodTpuError(
                f"process set ranks {ps.ranks} out of range for world size "
                f"{self.world_size}"
            )
        ps.process_set_id = self._next_id
        self._by_id[ps.process_set_id] = ps
        self._next_id += 1
        if self._new_group is not None:
            self._groups[ps.process_set_id] = self._make_groups(ps)
        return ps

    def _make_groups(self, ps: ProcessSet) -> SetGroups:
        if len(ps.ranks) == self.world_size:
            return SetGroups(None, None, None, None, [])
        owned = []

        def make(ranks):
            group = self._new_group(list(ranks))
            if self._rank in ranks:
                owned.append(group)
            return group

        members = make(ps.ranks)
        try:
            tiles = tiling_groups(ps.ranks, self.world_size)
        except ProcessSetTilingError:
            tiles = None
        tile = tile_ranks = None
        if tiles is not None:
            for i, ranks in enumerate(tiles):
                group = members if i == 0 else make(ranks)
                if self._rank in ranks:
                    tile, tile_ranks = group, ranks
        return SetGroups(members, tiles, tile, tile_ranks, owned)

    def add(self, ps: ProcessSet, dynamic_ok: bool = False) -> ProcessSet:
        with self._lock:
            if ps.ranks in {p.ranks for p in self._by_id.values()}:
                return self._register(ps)
            if not dynamic_ok and not env.get_bool(env.DYNAMIC_PROCESS_SETS):
                raise HorovodTpuError(
                    "Attempted to add a process set after initialization "
                    "without dynamic process sets enabled; set "
                    "HVD_TPU_DYNAMIC_PROCESS_SETS=1 or pass process_sets= to "
                    "init() (reference horovod/common/operations.cc:1194)."
                )
            return self._register(ps)

    def remove(self, ps: ProcessSet) -> None:
        with self._lock:
            if ps.process_set_id is None or ps.process_set_id not in self._by_id:
                raise HorovodTpuError(f"unknown process set {ps}")
            if ps.process_set_id == 0:
                raise HorovodTpuError("cannot remove the global process set")
            del self._by_id[ps.process_set_id]
            groups = self._groups.pop(ps.process_set_id, None)
            ps.process_set_id = None
        if groups is not None:
            for group in groups.owned:
                self._destroy(group)

    def get(self, process_set_id: int) -> ProcessSet:
        with self._lock:
            return self._by_id[process_set_id]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._by_id)

    def groups(self, process_set_id: int) -> SetGroups:
        """The groups of a registered set (a table made with
        ``new_group`` only)."""
        with self._lock:
            return self._groups[process_set_id]

    def close(self) -> None:
        """Destroy every set's groups this rank belongs to (the default
        group is the runtime's to destroy)."""
        with self._lock:
            groups, self._groups = list(self._groups.values()), {}
        for g in groups:
            for group in g.owned:
                self._destroy(group)

    def partition_groups(self, ps: ProcessSet) -> Optional[List[List[int]]]:
        """Equal-size groups covering every rank with ``ps`` first, or None
        for the global set and for a set that does not tile."""
        if len(ps.ranks) == self.world_size:
            return None
        try:
            return tiling_groups(
                ps.ranks, self.world_size, context="process set partition"
            )
        except ProcessSetTilingError:
            return None


def resolve(process_set) -> Optional[ProcessSet]:
    """Validate ``process_set`` for a collective (the JAX package's
    ``ops/eager.py:244`` ``_ps_id``): None or the global set (id 0) give
    None; a registered :class:`ProcessSet` whose ranks match its
    registration is returned; anything else raises
    :class:`HorovodTpuError`."""
    if process_set is None:
        return None
    if not isinstance(process_set, ProcessSet):
        raise HorovodTpuError(
            f"process_set must be a ProcessSet, got {type(process_set).__name__}"
        )
    if process_set.process_set_id is None:
        raise HorovodTpuError(
            f"process set {list(process_set.ranks)} is not registered; call "
            "hvd.add_process_set() or pass it to init() first"
        )
    from . import runtime

    table = runtime.get_runtime().process_set_table
    try:
        registered = table.get(process_set.process_set_id)
    except KeyError:
        raise HorovodTpuError(
            f"process set id {process_set.process_set_id} is not registered"
        ) from None
    if registered.ranks != process_set.ranks:
        raise HorovodTpuError(
            f"process set id {process_set.process_set_id} is registered with "
            f"different ranks ({list(registered.ranks)} vs "
            f"{list(process_set.ranks)})"
        )
    return None if process_set.process_set_id == 0 else registered


def member_group(ps: Optional[ProcessSet]):
    """``(group, ranks, member)`` of a resolved set: the default group,
    None and True for the global set (None)."""
    if ps is None:
        return None, None, True
    from . import runtime

    rt = runtime.get_runtime()
    groups = rt.process_set_table.groups(ps.process_set_id)
    return groups.members, ps.ranks, rt.rank in ps.ranks
