"""Environment-variable knobs the port reads.

Counterpart of ``horovod_tpu/utils/env.py``, trimmed to the knobs of the
data-parallel step, the eager collectives and their tuning.  Names and defaults are
the JAX package's, so one environment drives both sides of a parity
test: ``HVD_TPU_<name>``, with ``HOROVOD_<name>`` accepted as a
fallback.
"""

from __future__ import annotations

import os
from typing import Optional

FUSION_THRESHOLD = "FUSION_THRESHOLD"  # bytes; reference default 64MB
SCHED = "SCHED"  # on (default) | off
SCHED_BUCKET_BYTES = "SCHED_BUCKET_BYTES"  # default: fusion threshold
SCHED_LOOK_AHEAD = "SCHED_LOOK_AHEAD"  # bucket-close look-ahead, default 3
SCHED_BARRIERS = "SCHED_BARRIERS"  # exchange launched from the backward, default off
SCHED_CAPTURE_ORDER = "SCHED_CAPTURE_ORDER"  # backward-order hooks, default on
SCHED_WIRE = "SCHED_WIRE"  # off (default) | bf16 | int8 | fp8
# Error-feedback residuals for the quantized wires (default on).
SCHED_WIRE_EF = "SCHED_WIRE_EF"
QUANT_BLOCK = "QUANT_BLOCK"  # elements per quantization block, default 512
# Quantized-wire backend: phase | fused (default; the ring kernels on the
# card, see ops/quantized.py).
QUANT_BACKEND = "QUANT_BACKEND"
# Whole-step capture: off | on | auto (default), the JAX package's
# whole-step emission knob (see xir/interp.py).
ONESTEP = "ONESTEP"
# Every eager collective cross-checks its request (type, dtype, shape,
# name, root) across ranks before it runs (default off; ops/eager.py).
CONSISTENCY_CHECK = "CONSISTENCY_CHECK"
# grouped_allreduce runs one collective per tensor, in order, instead of
# one per dtype over a fused buffer (default off).
DISABLE_GROUP_FUSION = "DISABLE_GROUP_FUSION"
# add_process_set / remove_process_set after init (default off), as
# init(process_sets="dynamic") sets it.
DYNAMIC_PROCESS_SETS = "DYNAMIC_PROCESS_SETS"
# Sets registered at init, "0,1;2,3": one set per ";", ranks by ",".
PROCESS_SETS = "PROCESS_SETS"
# Log level of utils/logging.py: trace|debug|info|warning (default)|error|fatal.
LOG_LEVEL = "LOG_LEVEL"
# Two-level allreduce (reference HOROVOD_HIERARCHICAL_ALLREDUCE; default
# off): Sum and Average as an intra-host reduce-scatter, a cross-host sum
# of the shard and an intra-host all-gather (ops/collectives.py); Adasum
# as a sum inside each host and Adasum across hosts (ops/adasum.py).
HIERARCHICAL_ALLREDUCE = "HIERARCHICAL_ALLREDUCE"
# Topology (topo/model.py): a forced shape, "SxK" / "SxK1xK2" (S domains
# of K ranks) or a JSON object ({"slices": 2, "ici_shape": [2], ...});
# unset: one NVLink domain per host (backend/gpu_topo.py).
TOPO = "TOPO"
# Lowering of the gradient exchange over a multi-domain world: auto
# (default; the cost model picks flat or hier per bucket) | flat/off |
# hier/on | hier_adasum/adasum (topo/hierarchical.py).
TOPO_LOWER = "TOPO_LOWER"
# The cost model's link parameters: bandwidth GB/s, per-hop latency us,
# per-collective overhead us.
TOPO_ICI_GBPS = "TOPO_ICI_GBPS"
TOPO_DCN_GBPS = "TOPO_DCN_GBPS"
TOPO_ICI_LAT_US = "TOPO_ICI_LAT_US"
TOPO_DCN_LAT_US = "TOPO_DCN_LAT_US"
TOPO_PHASE_OVERHEAD_US = "TOPO_PHASE_OVERHEAD_US"
# The measured cost model (topo/fit.py): fit effective link parameters
# from the eager collectives' dispatch histograms and prefer them over the
# static TOPO_* fields; on | off (unset: off on an NCCL process group,
# whose cells hold enqueue times, on elsewhere).
TOPO_FIT = "TOPO_FIT"
TOPO_FIT_MIN_OBS = "TOPO_FIT_MIN_OBS"  # observations before the first fit
TOPO_FIT_REFIT_EVERY = "TOPO_FIT_REFIT_EVERY"  # new observations between refits
# TrainStep tunes the fusion threshold, the hierarchical allreduce and the
# quantized wire by itself (utils/autotune.py; default off); its window
# records go to AUTOTUNE_LOG as CSV when set.
AUTOTUNE = "AUTOTUNE"
AUTOTUNE_LOG = "AUTOTUNE_LOG"
# The persistent schedule store (sched/store.py): a JSON file of tuned
# winners, and how far the cost model may disagree with an entry's
# recorded price before the entry is stale (default 4x).
TUNE_DB = "TUNE_DB"
TUNE_STALE_FACTOR = "TUNE_STALE_FACTOR"
# The structured elastic event log (events.py): a JSONL path.
ELASTIC_EVENT_LOG = "ELASTIC_EVENT_LOG"

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# Fusion buffers are padded to this many bytes (ops/fusion.py
# pad_to_atomic_unit), the JAX package's value.
FUSION_BUFFER_ATOMIC_UNIT = 512


def _names(name: str) -> tuple[str, str]:
    return "HVD_TPU_" + name, "HOROVOD_" + name


def get_env(name: str, default: Optional[str] = None) -> Optional[str]:
    """Read a knob, preferring HVD_TPU_<name>, falling back to HOROVOD_<name>."""
    new, legacy = _names(name)
    val = os.environ.get(new)
    if val is None:
        val = os.environ.get(legacy)
    return default if val is None else val


def set_env(name: str, value: str) -> None:
    os.environ["HVD_TPU_" + name] = value


def get_int(name: str, default: int) -> int:
    val = get_env(name)
    if val is None or val == "":
        return default
    try:
        return int(val)
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    val = get_env(name)
    if val is None or val == "":
        return default
    try:
        return float(val)
    except ValueError:
        return default


def get_bool(name: str, default: bool = False) -> bool:
    val = get_env(name)
    if val is None or val == "":
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")
