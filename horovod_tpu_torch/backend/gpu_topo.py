"""GPU topology discovery: NVLink domains and IB links as the two rails.

Counterpart of ``horovod_tpu/backend/gpu_topo.py``: the link defaults
(``:37-40``) and ``discover`` (``:62``).  The topology model has two
network classes, a fast intra-domain rail ("ici") and a slower
inter-domain one ("dcn").  On a GPU cluster they are the NVLink island
inside a host and the InfiniBand fabric between hosts:

* one **NVLink domain** per host: the ranks that share a host form a
  "slice", and NVLink prices as the ici rail;
* **IB** between hosts prices as the dcn rail.

Where the JAX package reads each device's ``process_index``, the port
reads each rank's host, as ``runtime.py`` gathers them at ``init``.
``HVD_TPU_TOPO`` is honoured upstream, in ``topo/model.py``
``discover``, before this runs; the ``TOPO_*`` link knobs override the
defaults below.  The JAX package's backend registry (its peak tables,
the tpu family) waits for ROADMAP Queue A entry A13.
"""

from __future__ import annotations

from typing import Hashable, Sequence

from ..utils import env

# Link-parameter defaults for the gpu family (datasheet-order figures:
# NVLink4 ~450 GB/s/direction per GPU, 4x200Gbit HDR IB ~ 25 GB/s/GPU).
DEFAULT_NVLINK_GBPS = 300.0
DEFAULT_IB_GBPS = 25.0
DEFAULT_NVLINK_LAT_S = 2e-6
DEFAULT_IB_LAT_S = 10e-6


def _link_params() -> dict:
    """The link-parameter dict with the gpu family's defaults; the
    ``TOPO_*`` knobs override."""
    from ..topo import model as topo_model

    return dict(
        ici_gbps=env.get_float(env.TOPO_ICI_GBPS, DEFAULT_NVLINK_GBPS),
        dcn_gbps=env.get_float(env.TOPO_DCN_GBPS, DEFAULT_IB_GBPS),
        ici_latency_s=env.get_float(
            env.TOPO_ICI_LAT_US, DEFAULT_NVLINK_LAT_S * 1e6) * 1e-6,
        dcn_latency_s=env.get_float(
            env.TOPO_DCN_LAT_US, DEFAULT_IB_LAT_S * 1e6) * 1e-6,
        phase_overhead_s=env.get_float(
            env.TOPO_PHASE_OVERHEAD_US,
            topo_model.DEFAULT_PHASE_OVERHEAD_S * 1e6) * 1e-6,
    )


def discover(hosts: Sequence[Hashable]):
    """Build a Topology from each rank's host, in rank order: one NVLink
    domain per host, IB between domains.  Ragged domain sizes or an
    order that is not host-major collapse to one domain (the flat
    degenerate), with the JAX package's warning."""
    from ..topo import model as topo_model
    from ..utils.logging import get_logger

    params = _link_params()
    n = len(hosts)
    index = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    host_of = [index[h] for h in hosts]
    ids = sorted(set(host_of))
    sizes = {i: host_of.count(i) for i in ids}
    if len(ids) < 2 or len(set(sizes.values())) != 1:
        if len(ids) >= 2:
            get_logger().warning(
                "backend.gpu: ragged NVLink domain sizes %s; treating "
                "the world as one domain (flat lowering)", sizes,
            )
        return topo_model.Topology(
            num_slices=1, slice_size=n, source="gpu", **params
        )
    # Contiguity contract: rank order must be domain-major for the
    # slice-major group math to hold.
    size = sizes[ids[0]]
    blocks = [host_of[i * size:(i + 1) * size] for i in range(len(ids))]
    if any(len(set(b)) != 1 for b in blocks):
        get_logger().warning(
            "backend.gpu: device order is not NVLink-domain-major; "
            "treating the world as one domain (flat lowering)"
        )
        return topo_model.Topology(
            num_slices=1, slice_size=n, source="gpu", **params
        )
    return topo_model.Topology(
        num_slices=len(ids), slice_size=size, source="gpu", **params
    )
