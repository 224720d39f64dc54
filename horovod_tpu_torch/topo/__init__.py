"""Topology-aware hierarchical collectives.

Counterpart of ``horovod_tpu/topo/``: ``model`` (the topology and its
cost model; discovered as one NVLink domain per host, or forced with
``HVD_TPU_TOPO``), ``fit`` (the measured cost model: the eager
collectives' dispatch times fitted into the link parameters the cost
model prefers, ``HVD_TPU_TOPO_FIT``) and ``hierarchical`` (the two-level
collectives on ``torch.distributed`` subgroups).
"""

from . import fit, hierarchical, model  # noqa: F401
from .fit import record_observation  # noqa: F401
from .hierarchical import (  # noqa: F401
    dcn_adasum,
    dcn_all_gather_phase,
    dcn_all_reduce,
    dcn_reduce_scatter_phase,
    dcn_sum_phase,
    hierarchical_adasum_all_reduce,
    hierarchical_all_gather,
    hierarchical_all_reduce,
    hierarchical_reduce_scatter,
    ici_all_gather_phase,
    ici_reduce_scatter_phase,
    phase_context,
)
from .model import (  # noqa: F401
    LOWER_CHOICES,
    RAILS,
    Topology,
    canon_rail,
    current,
    discover,
    lower_mode,
    rail_label,
    rail_labels,
    reset,
    set_topology_override,
)
