"""Hybrid parallelism over a mesh of ranks: the mesh, tensor-parallel
layers, ring and Ulysses attention over a sequence axis, the
mixture-of-experts layer over an expert axis, the GPipe pipeline over a
stage axis, and the per-parameter gradient rule.

Counterpart of ``horovod_tpu/parallel/__init__.py`` for the mesh
(``mesh.py``), ``tensor.py``, ``ring_attention.py``, ``ulysses.py``,
``moe.py``, ``pipeline.py`` and ``grad_sync.py``, with the shuffles'
wire rule in ``wire.py``; :func:`make_mesh` needs an initialized
runtime.
"""

from .mesh import (  # noqa: F401
    AXIS_ORDER,
    DP_AXIS,
    EP_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    Mesh,
    ParallelConfig,
    make_mesh,
    mesh_layout,
    split_axis,
    sub_axis_names,
)
from .grad_sync import sync_gradients, sync_gradients_bucketed  # noqa: F401,E402
from .moe import MoELayer, moe_alltoall_combine, moe_alltoall_dispatch  # noqa: F401,E402
from .pipeline import pipeline_apply  # noqa: F401,E402
from .ring_attention import full_attention, ring_attention  # noqa: F401,E402
from .tensor import (  # noqa: F401,E402
    ColumnParallelDense,
    RowParallelDense,
    TensorParallelMLP,
)
from .ulysses import ulysses_attention  # noqa: F401,E402
