"""Named multi-axis meshes of ranks for hybrid parallelism.

Counterpart of ``horovod_tpu/parallel/mesh.py``: ``ParallelConfig``,
``AXIS_ORDER``, ``sub_axis_names``, ``split_axis`` and ``make_mesh`` with
the same rules (one degree may be -1, unit axes are dropped unless
asked for, a product that does not match the world is an error), which
:func:`mesh_layout` applies without a runtime.

Where the JAX mesh reshapes a list of devices, this one reshapes the
runtime's ranks, in row-major ``AXIS_ORDER`` (the order ``np.reshape``
gives the JAX devices), and holds what ``shard_map`` gives a JAX
function implicitly: this rank's coordinate on each axis, each axis's
size, and one ``torch.distributed`` group per set of axes, the ranks
that share every coordinate outside the set (ordered by rank, which is
the order of their coordinates on the set).  The set of every axis is
the world, whose group is the default one.  The model, the layers and
``sync_gradients`` take the mesh explicitly; ``mesh=None`` (or an axis
the mesh lacks) is the single-device path, as an axis not bound under
``shard_map`` is in the JAX package.

Every group is made on every rank, in one fixed order (by the number of
axes in the set, then ``AXIS_ORDER``, then rank), as
``process_sets.py`` makes its groups; :meth:`Mesh.shutdown` destroys
the ones this rank belongs to.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

DP_AXIS = "dp"
PP_AXIS = "pp"
EP_AXIS = "ep"
SP_AXIS = "sp"
TP_AXIS = "tp"

# Outer-to-inner order: the innermost axes get neighbouring ranks.
AXIS_ORDER: Tuple[str, ...] = (DP_AXIS, PP_AXIS, EP_AXIS, SP_AXIS, TP_AXIS)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Degrees of each parallelism dimension; their product must equal
    the number of ranks (unset axes default to 1 and are dropped from
    the mesh unless kept)."""

    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def degree(self, axis: str) -> int:
        return getattr(self, axis)

    @property
    def total(self) -> int:
        return self.dp * self.pp * self.ep * self.sp * self.tp

    def axes(self, keep: Sequence[str] = ()) -> List[str]:
        """Axes of the mesh: degree > 1 axes plus any in ``keep``."""
        return [
            a for a in AXIS_ORDER if self.degree(a) > 1 or a in keep
        ] or [DP_AXIS]


def sub_axis_names(axis: str) -> Tuple[str, str]:
    """Canonical ``(outer, inner)`` sub-axis names of a factored axis:
    ``"dp" -> ("dp_dcn", "dp_ici")``."""
    return f"{axis}_dcn", f"{axis}_ici"


class Mesh:
    """Ranks ``0..size-1`` laid out row-major over ``axis_names`` of
    ``shape``, seen from ``rank``.

    ``shape`` maps each axis to its size, ``coords`` to this rank's
    coordinate.  :meth:`ranks` and :meth:`group` give, for a set of axes,
    the ranks that share this rank's coordinates on every other axis and
    their ``torch.distributed`` group (None: the default group, or no
    group at all for a single rank).  With ``new_group`` the groups of
    every set of axes are made at once (every rank must make the same
    mesh); without it the mesh holds geometry only, and a collective
    over more than one rank raises."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int,
                 new_group: Optional[Callable] = None,
                 destroy: Optional[Callable] = None):
        self.axis_names = tuple(axis_names)
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axis names {self.axis_names}")
        dims = tuple(int(s) for s in shape)
        if len(dims) != len(self.axis_names) or any(s < 1 for s in dims):
            raise ValueError(f"bad mesh shape {dims} for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))
        self.size = int(np.prod(dims))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size} ranks")
        self.rank = rank
        self._grid = np.arange(self.size).reshape(dims)
        self.coords: Dict[str, int] = dict(
            zip(self.axis_names, (int(c) for c in np.unravel_index(rank, dims))))
        self._destroy = destroy
        self._groups: Dict[FrozenSet[str], object] = {}
        self._owned: list = []
        if new_group is not None and self.size > 1:
            self._make_groups(new_group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def present(self, axis: str) -> bool:
        """Whether ``axis`` is an axis of the mesh (JAX: bound under
        ``shard_map``), whatever its size."""
        return axis in self.shape

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh lacks."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``; 0 for an axis the mesh lacks."""
        return self.coords.get(axis, 0)

    def _key(self, axes) -> FrozenSet[str]:
        if isinstance(axes, str):
            axes = (axes,)
        return frozenset(a for a in axes if a in self.shape)

    def tiles(self, axes) -> List[List[int]]:
        """Every group of ``axes``: the lists of ranks that share their
        coordinates outside ``axes``, each in rank order."""
        key = self._key(axes)
        inside = [i for i, a in enumerate(self.axis_names) if a in key]
        outside = [i for i, a in enumerate(self.axis_names) if a not in key]
        moved = np.transpose(self._grid, outside + inside)
        width = int(np.prod([self._grid.shape[i] for i in inside])) if inside else 1
        return [sorted(int(r) for r in row) for row in moved.reshape(-1, width)]

    def ranks(self, axes) -> List[int]:
        """The ranks of this rank's group of ``axes``, in rank order."""
        for tile in self.tiles(axes):
            if self.rank in tile:
                return tile
        raise AssertionError("the tiles cover every rank")

    def group_size(self, axes) -> int:
        """The number of ranks in a group of ``axes``."""
        return int(np.prod([self.shape[a] for a in self._key(axes)], dtype=np.int64))

    def group(self, axes):
        """This rank's ``torch.distributed`` group of ``axes`` (None: the
        default group, which spans the mesh)."""
        key = self._key(axes)
        if len(key) == len(self.axis_names) or self.group_size(key) == 1:
            return None
        if key not in self._groups:
            raise RuntimeError(
                f"{self!r} holds no process group for the axes {sorted(key)}: "
                "make it with make_mesh on an initialized runtime")
        return self._groups[key]

    def _make_groups(self, new_group: Callable) -> None:
        names = self.axis_names
        for n in range(1, len(names)):
            for axes in itertools.combinations(names, n):
                key = frozenset(axes)
                if self.group_size(key) == 1:
                    continue
                for tile in self.tiles(key):
                    group = new_group(tile)
                    if self.rank in tile:
                        self._groups[key] = group
                        self._owned.append(group)

    def shutdown(self) -> None:
        """Destroy the groups this rank belongs to (idempotent)."""
        owned, self._owned, self._groups = self._owned, [], {}
        if self._destroy is not None:
            for group in owned:
                self._destroy(group)


def refuse_in_capture(what: str) -> None:
    """Raise while a CUDA graph is captured: the mesh's collectives run
    eagerly (the hybrid step is not captured; ROADMAP Queue A entry A10)."""
    from .. import runtime

    if runtime.capturing():
        raise RuntimeError(
            f"{what} runs a collective on a mesh group, which is not captured "
            "into CUDA graphs: run the hybrid-parallel step eagerly (ROADMAP "
            "Queue A entry A10)"
        )


def split_axis(
    mesh: Mesh,
    axis: str,
    inner: int,
    names: Optional[Tuple[str, str]] = None,
) -> Mesh:
    """Factor one mesh axis into ``(outer, inner)`` sub-axes, as
    ``horovod_tpu/parallel/mesh.py`` ``split_axis`` reshapes the device
    array: consecutive blocks of ``inner`` ranks along ``axis`` land on
    the inner sub-axis.  The result holds geometry only (no groups)."""
    if axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has no axis {axis!r} (axes: {mesh.axis_names})"
        )
    size = mesh.shape[axis]
    if inner <= 0 or size % inner != 0:
        raise ValueError(
            f"axis {axis!r} of size {size} does not factor by "
            f"inner={inner}"
        )
    outer_name, inner_name = names or sub_axis_names(axis)
    for n in (outer_name, inner_name):
        if n in mesh.axis_names:
            raise ValueError(f"sub-axis name {n!r} already in the mesh")
    pos = mesh.axis_names.index(axis)
    dims = [mesh.shape[a] for a in mesh.axis_names]
    new_shape = dims[:pos] + [size // inner, inner] + dims[pos + 1:]
    new_names = (
        mesh.axis_names[:pos] + (outer_name, inner_name)
        + mesh.axis_names[pos + 1:]
    )
    return Mesh(new_names, new_shape, mesh.rank)


def mesh_layout(
    size: int,
    config: Optional[ParallelConfig] = None,
    keep_unit_axes: bool = False,
    **degrees: int,
) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The axes and shape of a mesh of ``size`` ranks, by the rules of
    ``horovod_tpu/parallel/mesh.py`` ``make_mesh``: one degree may be -1
    (inferred from ``size``), degree-1 axes are dropped unless passed as
    keywords or ``keep_unit_axes`` is set, and degrees that do not
    multiply to ``size`` raise ``ValueError``."""
    explicit = tuple(AXIS_ORDER) if keep_unit_axes else tuple(degrees)
    if config is None:
        config = ParallelConfig(**degrees)
    elif degrees:
        raise ValueError("pass either a ParallelConfig or keyword degrees")
    vals = {a: config.degree(a) for a in AXIS_ORDER}
    unknown = [a for a, v in vals.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis degree may be -1")
    if unknown:
        known = int(np.prod([v for v in vals.values() if v != -1]))
        if size % known != 0:
            raise ValueError(
                f"{size} devices not divisible by fixed degrees {known}"
            )
        vals[unknown[0]] = size // known
        config = ParallelConfig(**vals)
    if config.total != size:
        raise ValueError(
            f"mesh degrees {vals} multiply to {config.total}, but "
            f"{size} devices are available"
        )
    axes = config.axes(explicit)
    return tuple(axes), tuple(config.degree(a) for a in axes)


def make_mesh(
    config: Optional[ParallelConfig] = None,
    keep_unit_axes: bool = False,
    **degrees: int,
) -> Mesh:
    """Build a named mesh over the runtime's ranks, with its groups.

    ``make_mesh(dp=2, tp=2)`` in a world of four -> Mesh {'dp': 2,
    'tp': 2}.  The degrees follow :func:`mesh_layout`'s rules."""
    from .. import runtime

    rt = runtime.get_runtime()
    axes, shape = mesh_layout(rt.size, config, keep_unit_axes, **degrees)
    new_group = destroy = None
    if rt.size > 1:
        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=rt.timeout_s)

        def new_group(ranks):
            return dist.new_group(ranks, timeout=timeout)

        def destroy(group):  # shutdown() of the runtime destroys them all
            if dist.is_initialized():
                dist.destroy_process_group(group)

    return Mesh(axes, shape, rt.rank, new_group, destroy)
