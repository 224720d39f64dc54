"""Topology description + cost model for flat-vs-hierarchical lowering.

Counterpart of ``horovod_tpu/topo/model.py``: ``Topology`` (``:105``)
with ``factor_axis`` (``:149``), ``axis_groups`` (``:165``),
``estimate_cost``, ``rail_times``, ``choose_lowering``,
``fused_dispatch_cost``, ``rail_occupancy_seconds`` and
``lowering_bytes``; ``cost_coefficients`` (``:370``),
``rail_cost_coefficients`` (``:451``), ``canon_rail`` and the rail
labels; ``_from_spec`` (``:535``), ``discover`` (``:649``), ``current``
(``:674``), ``set_topology_override`` (``:704``), ``reset`` (``:709``)
and ``lower_mode`` (``:721``), copied whole.

A :class:`Topology` answers two questions the collective layer cannot
answer from the world alone:

1. **Where are the slow links?**  ``num_slices`` equal domains of
   ``slice_size`` ranks each; inside a domain the fast rail ("ici":
   NVLink on a GPU host) carries full-bandwidth traffic, between
   domains only the slow one ("dcn": InfiniBand).  Discovered from the
   hosts of the runtime's ranks (one NVLink domain per host,
   ``backend/gpu_topo.py``), or forced with ``HVD_TPU_TOPO`` ("2x2",
   "2x4", or a JSON object) so one host can run any shape.

2. **Which lowering is cheaper?**  :meth:`estimate_cost` prices a
   collective under the ring model (``phases * overhead + hops *
   latency + bytes / bandwidth`` per rail) and :meth:`choose_lowering`
   compares the flat single-collective lowering against the
   hierarchical three-phase one.

The link parameters are ``topo/fit.py`` ``effective_params``: the
measured fit when one exists for the topology's shape (and
``HVD_TPU_TOPO_FIT`` allows it), the static fields otherwise, as in the
JAX package.  One thing differs: the rail labels are the gpu family's
(``{"ici": "nvlink", "dcn": "ib"}``), since the port serves that family
only and has no backend registry yet.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import List, Optional, Sequence, Tuple

from ..exceptions import HorovodTpuError, ProcessSetTilingError
from ..process_sets import tiling_groups
from ..utils import env

# Lowering choices a collective (or a scheduler bucket) can carry.
# "hier_adasum" keeps hier's ICI staging but combines across slices
# with Adasum's adaptive summation (arXiv:2006.02924) instead of a
# plain sum — an algorithm choice, so "auto" never picks it; it is
# requested explicitly (knob / tuner / DistributedAdasumOptimizer).
LOWER_CHOICES = ("flat", "hier", "hier_adasum")

# Cost-model defaults: ~10x ICI-vs-DCN bandwidth (arXiv:1810.11112's
# two-level regime), per-hop wire latencies, and a fixed per-collective
# overhead (dispatch + fusion-boundary cost of one more XLA collective).
DEFAULT_ICI_GBPS = 100.0
DEFAULT_DCN_GBPS = 10.0
DEFAULT_ICI_LAT_S = 1e-6
DEFAULT_DCN_LAT_S = 25e-6
DEFAULT_PHASE_OVERHEAD_S = 200e-6

_COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather")

# --------------------------------------------------------- rail naming
#
# Every pricing/pipelining consumer keys on the two CANONICAL rails —
# "ici" (fast intra-domain) and "dcn" (slow inter-domain) — regardless
# of backend family; the physical spellings (NVLink/IB on gpu) are a
# display concern served by the backend registry.  canon_rail maps any
# spelling back to canonical (identity for unknown tags, never a
# KeyError) so a payload tagged "nvlink" aggregates with one tagged
# "ici".

RAILS = ("ici", "dcn")

_RAIL_CANON = {
    "ici": "ici", "nvlink": "ici", "nvswitch": "ici",
    "dcn": "dcn", "ib": "dcn", "infiniband": "dcn", "roce": "dcn",
}


def canon_rail(tag) -> str:
    """Canonical rail for any spelling; an unknown tag passes through
    lowercased (callers must tolerate it, never KeyError)."""
    t = str(tag or "").strip().lower()
    return _RAIL_CANON.get(t, t)


def rail_labels() -> dict:
    """Canonical rail tag -> the gpu family's physical label."""
    return {"ici": "nvlink", "dcn": "ib"}


def rail_label(rail: str) -> str:
    """Physical spelling of one rail tag under the resolved family."""
    canon = canon_rail(rail)
    return rail_labels().get(canon, canon)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-level network shape + link cost parameters.

    ``num_slices`` equal slices of ``slice_size`` devices; device order
    is slice-major (devices ``[j*slice_size, (j+1)*slice_size)`` form
    slice ``j``): ranks are host-major (``backend/gpu_topo.py`` checks
    it), and ``HVD_TPU_TOPO`` overlays the same contract on one host.
    """

    num_slices: int = 1
    slice_size: int = 1
    ici_shape: Tuple[int, ...] = ()
    ici_gbps: float = DEFAULT_ICI_GBPS
    dcn_gbps: float = DEFAULT_DCN_GBPS
    ici_latency_s: float = DEFAULT_ICI_LAT_S
    dcn_latency_s: float = DEFAULT_DCN_LAT_S
    phase_overhead_s: float = DEFAULT_PHASE_OVERHEAD_S
    source: str = "default"

    def __post_init__(self):
        if self.num_slices < 1 or self.slice_size < 1:
            raise HorovodTpuError(
                f"topology needs >=1 slice of >=1 device, got "
                f"{self.num_slices}x{self.slice_size}"
            )
        shape = tuple(int(d) for d in self.ici_shape) or (self.slice_size,)
        object.__setattr__(self, "ici_shape", shape)
        prod = 1
        for d in shape:
            prod *= d
        if prod != self.slice_size:
            raise HorovodTpuError(
                f"ici_shape {shape} does not multiply to slice_size "
                f"{self.slice_size}"
            )

    # ---------------------------------------------------------- shape
    @property
    def world(self) -> int:
        return self.num_slices * self.slice_size

    @property
    def multi_slice(self) -> bool:
        return self.num_slices > 1 and self.slice_size > 1

    def factor_axis(self, axis_size: int) -> Tuple[int, int]:
        """Factor a reduction axis into ``(dcn_degree, ici_degree)``.

        An axis of the full world factors as ``(num_slices,
        slice_size)``.  A smaller axis (e.g. the ``dp`` axis of a
        dp×tp mesh whose inner axes fit inside a slice) factors as
        ``(num_slices, axis_size // num_slices)`` — consecutive blocks
        of axis indices share a slice because the axis is outermost
        over slice-major device order.  Anything that cannot split
        evenly across every slice returns ``(1, axis_size)``: the flat
        degenerate (also the single-slice answer)."""
        if not self.multi_slice or axis_size <= self.num_slices:
            return 1, axis_size
        if axis_size % self.num_slices != 0:
            return 1, axis_size
        return self.num_slices, axis_size // self.num_slices

    def axis_groups(
        self, axis_size: int
    ) -> Tuple[List[List[int]], List[List[int]]]:
        """``(intra, cross)`` replica groups of a factored axis.

        ``intra[j]`` lists slice j's axis indices (ICI neighbors);
        ``cross[i]`` lists the i-th index of every slice (the DCN
        "rail").  Built on the shared tiling rule so a non-factorable
        axis raises the same structured
        :class:`~horovod_tpu.exceptions.ProcessSetTilingError` as the
        process-set and quantized-wire paths."""
        s, k = self.factor_axis(axis_size)
        if s == 1:
            raise ProcessSetTilingError(
                range(min(axis_size, self.slice_size)), axis_size,
                f"hierarchical groups over a {self.num_slices}-slice "
                "topology",
            )
        intra = tiling_groups(
            range(k), axis_size, context="hierarchical ICI groups"
        )
        cross = [[j * k + i for j in range(s)] for i in range(k)]
        return intra, cross

    # ----------------------------------------------------- cost model
    def estimate_cost(
        self,
        collective: str,
        nbytes: int,
        lowering: str = "flat",
        axis_size: Optional[int] = None,
        *,
        pipelined: bool = False,
    ) -> float:
        """Estimated seconds for ``collective`` over ``nbytes`` under a
        lowering.  Flat over a multi-slice axis rides the DCN
        bottleneck end to end; hierarchical pays three phase overheads
        but moves only the ``1/ici_degree`` shard over DCN.

        ``pipelined=True`` prices the collective as one stage of a
        rail-pipelined schedule (``xir/pipeline.py``): its ICI and DCN
        phases overlap neighbouring buckets' phases on the other rail,
        so the cost is the **max of the two rail times** instead of
        their sum — the per-op form of the max-of-rails schedule
        estimate.  Serialized (default) pricing is the sum of phases.

        Link parameters are this instance's static fields (the module
        docstring says why)."""
        if collective not in _COLLECTIVES:
            raise ValueError(
                f"unknown collective {collective!r}; "
                f"expected one of {_COLLECTIVES}"
            )
        if lowering not in LOWER_CHOICES:
            raise ValueError(
                f"unknown lowering {lowering!r}; expected {LOWER_CHOICES}"
            )
        n = self.world if axis_size is None else axis_size
        params = self._cost_params()
        if pipelined:
            ici_s, dcn_s = self.rail_times(collective, nbytes, lowering, n)
            return max(ici_s, dcn_s)
        coeff = cost_coefficients(collective, nbytes, lowering, n, self)
        return _dot_cost(coeff, params)

    def rail_times(
        self,
        collective: str,
        nbytes: int,
        lowering: str = "flat",
        axis_size: Optional[int] = None,
    ) -> Tuple[float, float]:
        """Per-rail seconds ``(ici_s, dcn_s)`` of one collective — the
        split the rail pipeliner schedules against.  The two times sum
        exactly to the serialized :meth:`estimate_cost` (the rail rows
        partition the coefficient row)."""
        n = self.world if axis_size is None else axis_size
        ici_row, dcn_row = rail_cost_coefficients(
            collective, nbytes, lowering, n, self
        )
        params = self._cost_params()
        return _dot_cost(ici_row, params), _dot_cost(dcn_row, params)

    def _cost_params(self) -> Tuple[float, float, float, float, float]:
        """(phase_overhead_s, ici_lat_s, dcn_lat_s, ici_bytes_per_s,
        dcn_bytes_per_s): fitted when a measured fit for this shape
        exists and ``HVD_TPU_TOPO_FIT`` allows it, static otherwise
        (``topo.fit.effective_params`` owns the preference order)."""
        from . import fit

        return fit.effective_params(self)

    def choose_lowering(
        self,
        collective: str,
        nbytes: int,
        axis_size: Optional[int] = None,
    ) -> str:
        """Pick ``flat`` or ``hier`` for one collective: the
        ``HVD_TPU_TOPO_LOWER`` policy when forced, else whichever the
        cost model prices cheaper.  Single-slice topologies and
        non-factorable axes always lower flat."""
        n = self.world if axis_size is None else axis_size
        s, _ = self.factor_axis(n)
        if s == 1:
            return "flat"
        mode = lower_mode()
        if mode == "hier_adasum" and collective != "all_reduce":
            # Adaptive summation is an allreduce-shaped combine; a
            # forced hier_adasum knob still stages RS/AG hierarchically.
            return "hier"
        if mode in LOWER_CHOICES:
            return mode
        # "auto" compares the two sum-preserving lowerings only:
        # hier_adasum changes the reduction algorithm, never a silent
        # cost-model pick.
        flat = self.estimate_cost(collective, nbytes, "flat", n)
        hier = self.estimate_cost(collective, nbytes, "hier", n)
        return "hier" if hier < flat else "flat"

    def fused_dispatch_cost(
        self,
        collective: str,
        nbytes_list,
        lowering: str = "flat",
        axis_size: Optional[int] = None,
    ) -> Tuple[float, float]:
        """``(serial_s, fused_s)`` for a batch of same-class exchanges:
        serial is the sum of each member priced alone; fused prices the
        concatenated payload as ONE collective.  The byte terms are
        identical by construction — the gap is the per-dispatch
        latency/phase-overhead terms the service-side fusion buffer
        (``svc/fuse.py``) amortizes, so ``fused_s <= serial_s`` always,
        with the gap widening as members shrink (the small-message
        regime of arXiv:1810.11112)."""
        sizes = [int(b) for b in nbytes_list]
        serial = sum(
            self.estimate_cost(collective, b, lowering, axis_size)
            for b in sizes
        )
        fused = self.estimate_cost(
            collective, sum(sizes), lowering, axis_size
        )
        return serial, fused

    def rail_occupancy_seconds(
        self, net_bytes: dict
    ) -> Tuple[float, float]:
        """Priced ``(ici_s, dcn_s)`` occupancy of a per-network byte
        split (the ``{"ici": ..., "dcn": ...}`` shape
        ``xir/lower.op_network_bytes`` produces): bytes over the fitted
        per-rail bandwidth plus one launch overhead per touched rail.
        This is the multi-tenant arbiter's fairness price
        (``svc/arbiter.py``) — coarse by design (per-hop latency terms
        are folded into the overhead), but it rides the same fitted
        parameters as :meth:`estimate_cost`, so a measured fit reprices
        tenant shares automatically."""
        po, _ici_lat, _dcn_lat, ici_bw, dcn_bw = self._cost_params()
        ici = int(net_bytes.get("ici") or 0)
        dcn = int(net_bytes.get("dcn") or 0)
        ici_s = (po + ici / max(ici_bw, 1.0)) if ici > 0 else 0.0
        dcn_s = (po + dcn / max(dcn_bw, 1.0)) if dcn > 0 else 0.0
        return ici_s, dcn_s

    def lowering_bytes(
        self,
        collective: str,
        nbytes: int,
        lowering: str = "flat",
        axis_size: Optional[int] = None,
    ) -> dict:
        """Per-rank wire bytes split by network class:
        ``{"dcn": ..., "ici": ...}`` under the ring convention (an
        allreduce moves ``2B(n-1)/n`` per rank).  Hier's DCN figure is
        exactly flat's divided by the ICI degree — the subsystem's
        headline ratio."""
        n = self.world if axis_size is None else axis_size
        s, k = self.factor_axis(n)
        phases = 2.0 if collective == "all_reduce" else 1.0
        if s == 1:
            moved = phases * nbytes * (n - 1) / max(n, 1)
            return {"dcn": 0, "ici": int(moved)}
        if lowering == "flat":
            return {
                "dcn": int(phases * nbytes * (s - 1) / s),
                "ici": int(phases * nbytes * (k - 1) / k),
            }
        if lowering == "hier_adasum":
            # One cross-slice all_gather of the 1/k shard (the scalar
            # dot-product rounds are byte-free): strictly no more DCN
            # bytes than hier's 1/k all_reduce.
            return {
                "dcn": int((nbytes / k) * (s - 1) / s),
                "ici": int(phases * nbytes * (k - 1) / k),
            }
        return {
            "dcn": int(phases * (nbytes / k) * (s - 1) / s),
            "ici": int(phases * nbytes * (k - 1) / k),
        }


def cost_coefficients(
    collective: str,
    nbytes: float,
    lowering: str,
    axis_size: int,
    topo: Topology,
) -> Tuple[float, float, float, float, float]:
    """Ring-model coefficient row of one collective: ``cost = c0 *
    phase_overhead + c1 * ici_lat + c2 * dcn_lat + c3 / ici_bytes_per_s
    + c4 / dcn_bytes_per_s``.

    The model is linear in these five parameters, so this one function
    serves both directions: :meth:`Topology.estimate_cost` dots the row
    with the current parameters, and the fitter (``topo/fit.py``)
    stacks rows from measured cells into the least-squares system —
    prediction and fit cannot drift apart.
    """
    n = axis_size
    s, k = topo.factor_axis(n)
    phases = 2.0 if collective == "all_reduce" else 1.0
    if n <= 1:
        return (0.0, 0.0, 0.0, 0.0, 0.0)
    if s == 1 or lowering == "flat":
        hops = phases * (n - 1)
        moved = phases * nbytes * (n - 1) / n
        if s > 1:  # flat over a multi-slice axis rides DCN end to end
            return (1.0, 0.0, hops, 0.0, moved)
        return (1.0, hops, 0.0, moved, 0.0)
    if lowering == "hier_adasum":
        # ICI legs as hier (RS + AG of the full buffer); the DCN leg is
        # one all_gather of the 1/k shard plus the extra dot-product
        # rounds — ceil(log2 p) tree levels (+1 fold on a non-power-of-
        # two slice count) of a 3-scalar psum each, priced as one phase
        # overhead and a DCN latency ring per round (their bytes are
        # negligible).  Still linear in the five parameters, so the
        # fitter (topo/fit.py) consumes the row unchanged.
        p2 = 1 << ((s).bit_length() - 1)
        rounds = (p2.bit_length() - 1) + (1 if s != p2 else 0)
        po = 0.0
        ici_hops = ici_bytes = 0.0
        if k > 1:
            po += 1.0
            ici_hops = phases * (k - 1)
            ici_bytes = phases * nbytes * (k - 1) / k
        po += 1.0 + rounds
        if collective == "all_reduce":
            po += 1.0  # separate ICI RS / AG launches
        dcn_hops = (s - 1) * (1.0 + rounds)
        dcn_bytes = (nbytes / k) * (s - 1) / s
        return (po, ici_hops, dcn_hops, ici_bytes, dcn_bytes)
    po = 0.0
    ici_hops = ici_bytes = 0.0
    if k > 1:
        po += 1.0
        ici_hops = phases * (k - 1)
        ici_bytes = phases * nbytes * (k - 1) / k
    po += 1.0
    dcn_hops = phases * (s - 1)
    dcn_bytes = phases * (nbytes / k) * (s - 1) / s
    if collective == "all_reduce":
        # RS(ici) + AR(dcn) + AG(ici): the two ICI phases are the halves
        # of one allreduce-equivalent, already counted above; their
        # separate launches cost one extra overhead.
        po += 1.0
    return (po, ici_hops, dcn_hops, ici_bytes, dcn_bytes)


def _dot_cost(coeff, params) -> float:
    """Dot one coefficient row with ``(po, ici_lat, dcn_lat,
    ici_bytes_per_s, dcn_bytes_per_s)`` — the single pricing expression
    every cost entry point shares."""
    po, ici_lat, dcn_lat, ici_bw, dcn_bw = params
    return (
        coeff[0] * po
        + coeff[1] * ici_lat
        + coeff[2] * dcn_lat
        + coeff[3] / ici_bw
        + coeff[4] / dcn_bw
    )


def rail_cost_coefficients(
    collective: str,
    nbytes: float,
    lowering: str,
    axis_size: int,
    topo: Topology,
) -> Tuple[Tuple[float, float, float, float, float],
           Tuple[float, float, float, float, float]]:
    """Split :func:`cost_coefficients` into its ``(ici_row, dcn_row)``
    rail halves: element-wise, the two rows sum exactly to the
    serialized row (a pinned test property), so serialized pricing is
    ``ici + dcn`` and pipelined pricing is ``max(ici, dcn)`` with the
    *same* fitted parameters.  Latency/byte columns split by network
    class; phase overheads go to the rail that launches the phase (the
    lone DCN-hop launch on the DCN row, the ICI staging launches on
    the ICI row).  Flat over a multi-slice axis is DCN-rail-only —
    every hop of the ring crosses a slice boundary in the model —
    which is what lets a slice-local shuffle workload merge into its
    idle ICI windows (``xir/pipeline.py`` merge rules)."""
    n = axis_size
    s, k = topo.factor_axis(n)
    phases = 2.0 if collective == "all_reduce" else 1.0
    zero = (0.0, 0.0, 0.0, 0.0, 0.0)
    if n <= 1:
        return zero, zero
    if s == 1 or lowering == "flat":
        row = cost_coefficients(collective, nbytes, lowering, n, topo)
        if s > 1:
            return zero, row  # flat multi-slice rides DCN end to end
        return row, zero
    if lowering == "hier_adasum":
        p2 = 1 << ((s).bit_length() - 1)
        rounds = (p2.bit_length() - 1) + (1 if s != p2 else 0)
        ici_po = ici_hops = ici_bytes = 0.0
        if k > 1:
            ici_po = 1.0
            ici_hops = phases * (k - 1)
            ici_bytes = phases * nbytes * (k - 1) / k
        if collective == "all_reduce":
            ici_po += 1.0  # separate ICI RS / AG launches
        dcn_po = 1.0 + rounds
        dcn_hops = (s - 1) * (1.0 + rounds)
        dcn_bytes = (nbytes / k) * (s - 1) / s
        return (
            (ici_po, ici_hops, 0.0, ici_bytes, 0.0),
            (dcn_po, 0.0, dcn_hops, 0.0, dcn_bytes),
        )
    # "hier"
    ici_po = ici_hops = ici_bytes = 0.0
    if k > 1:
        ici_po = 1.0
        ici_hops = phases * (k - 1)
        ici_bytes = phases * nbytes * (k - 1) / k
    if collective == "all_reduce":
        ici_po += 1.0  # separate ICI RS / AG launches
    dcn_hops = phases * (s - 1)
    dcn_bytes = phases * (nbytes / k) * (s - 1) / s
    return (
        (ici_po, ici_hops, 0.0, ici_bytes, 0.0),
        (1.0, 0.0, dcn_hops, 0.0, dcn_bytes),
    )


# ------------------------------------------------------------ discovery

_lock = threading.Lock()
_override: Optional[Topology] = None
_cache: dict = {}


def _link_params() -> dict:
    return dict(
        ici_gbps=env.get_float(env.TOPO_ICI_GBPS, DEFAULT_ICI_GBPS),
        dcn_gbps=env.get_float(env.TOPO_DCN_GBPS, DEFAULT_DCN_GBPS),
        ici_latency_s=env.get_float(
            env.TOPO_ICI_LAT_US, DEFAULT_ICI_LAT_S * 1e6) * 1e-6,
        dcn_latency_s=env.get_float(
            env.TOPO_DCN_LAT_US, DEFAULT_DCN_LAT_S * 1e6) * 1e-6,
        phase_overhead_s=env.get_float(
            env.TOPO_PHASE_OVERHEAD_US,
            DEFAULT_PHASE_OVERHEAD_S * 1e6) * 1e-6,
    )


def _from_spec(spec: str, n_devices: Optional[int]) -> Topology:
    """Parse an ``HVD_TPU_TOPO`` override: "SxK" / "SxK1xK2" (S slices
    of an ICI mesh) or a JSON object with ``slices`` / ``ici_shape`` /
    link-parameter keys.  A forced shape that contradicts the device
    count is an error, not a silent fallback."""
    params = _link_params()
    spec = spec.strip()
    if spec.startswith("{"):
        try:
            obj = json.loads(spec)
        except json.JSONDecodeError as e:
            raise HorovodTpuError(f"HVD_TPU_TOPO is not valid JSON: {e}")
        slices = int(obj.get("slices", 1))
        shape = tuple(int(d) for d in obj.get("ici_shape", ()) or ())
        size = int(obj.get("slice_size", 0))
        if not size:
            if shape:
                size = 1
                for d in shape:
                    size *= d
            elif n_devices and slices and n_devices % slices == 0:
                size = n_devices // slices
            else:
                raise HorovodTpuError(
                    "HVD_TPU_TOPO JSON needs slice_size or ici_shape "
                    "(or a device count divisible by slices)"
                )
        for key in ("ici_gbps", "dcn_gbps"):
            if key in obj:
                params[key] = float(obj[key])
        for key, tgt in (("ici_lat_us", "ici_latency_s"),
                         ("dcn_lat_us", "dcn_latency_s"),
                         ("phase_overhead_us", "phase_overhead_s")):
            if key in obj:
                params[tgt] = float(obj[key]) * 1e-6
    else:
        try:
            dims = [
                int(d) for d in spec.lower().replace("*", "x").split("x")
            ]
        except ValueError:
            dims = []
        if len(dims) < 2 or any(d < 1 for d in dims):
            raise HorovodTpuError(
                f"HVD_TPU_TOPO={spec!r}: expected 'SxK' / 'SxK1xK2' "
                "(slices x ICI mesh) or a JSON object"
            )
        slices, shape = dims[0], tuple(dims[1:])
        size = 1
        for d in shape:
            size *= d
    if n_devices is not None and slices * size != n_devices:
        raise HorovodTpuError(
            f"HVD_TPU_TOPO={spec!r} describes {slices}x{size} devices "
            f"but {n_devices} are present"
        )
    return Topology(
        num_slices=slices, slice_size=size, ici_shape=shape,
        source="env", **params,
    )


def discover(hosts: Optional[Sequence] = None) -> Topology:
    """Build the topology: the ``HVD_TPU_TOPO`` override when set (one
    host forcing any shape), else the gpu family's discovery
    (``backend/gpu_topo.py``: one NVLink domain per host, IB between).
    ``hosts`` lists each rank's host, in rank order (the runtime's when
    None: ``runtime.py`` gathers them at ``init``; a world of one
    without a runtime)."""
    spec = env.get_env(env.TOPO)
    if hosts is None:
        hosts = _runtime_hosts()
    if spec:
        return _from_spec(spec, len(hosts))
    from ..backend import gpu_topo

    return gpu_topo.discover(hosts)


def _runtime_hosts() -> List:
    from .. import runtime

    if runtime.is_initialized():
        return list(runtime.get_runtime().hosts)
    return ["localhost"]


def current() -> Topology:
    """The process-wide topology (cached per ``HVD_TPU_TOPO`` value and
    the ranks' hosts; :func:`set_topology_override` wins over
    everything)."""
    if _override is not None:
        return _override
    spec = env.get_env(env.TOPO) or ""
    hosts = _runtime_hosts()
    key = (spec, tuple(hosts))
    with _lock:
        topo = _cache.get(key)
        if topo is None:
            topo = discover(hosts)
            _cache[key] = topo
        return topo


def set_topology_override(topo: Optional[Topology]) -> None:
    global _override
    _override = topo


def reset() -> None:
    """Drop the discovery cache, the override and the fitted cost-model
    state (tests)."""
    global _override
    with _lock:
        _override = None
        _cache.clear()
    from . import fit

    fit.reset()


def lower_mode() -> str:
    """``HVD_TPU_TOPO_LOWER`` policy: ``auto`` (cost model decides
    between the sum-preserving lowerings), ``flat`` (``off``), ``hier``
    (``on``), or ``hier_adasum`` (``adasum`` — force the adaptive
    cross-slice combine on every eligible bucket)."""
    raw = (env.get_env(env.TOPO_LOWER, "auto") or "auto").strip().lower()
    if raw in ("off", "0", "false", "no", "flat", ""):
        return "flat"
    if raw in ("on", "1", "true", "yes", "hier", "hierarchical"):
        return "hier"
    if raw in ("hier_adasum", "adasum"):
        return "hier_adasum"
    if raw != "auto":
        raise HorovodTpuError(
            f"HVD_TPU_TOPO_LOWER must be auto|flat|hier|hier_adasum "
            f"(got {raw!r})"
        )
    return "auto"
