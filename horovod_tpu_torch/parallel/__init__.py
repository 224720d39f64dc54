"""Hybrid parallelism over a mesh of ranks: the mesh, tensor-parallel
layers, ring and Ulysses attention over a sequence axis, and the
per-parameter gradient rule.

Counterpart of ``horovod_tpu/parallel/__init__.py`` for the mesh
(``mesh.py``), ``tensor.py``, ``ring_attention.py``, ``ulysses.py`` and
``grad_sync.py``; :func:`make_mesh` needs an initialized runtime.  MoE
(``moe.py``) and the pipeline (``pipeline.py``) are not ported yet (ROADMAP Queue A entry A10).
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
from .ring_attention import full_attention, ring_attention  # noqa: F401,E402
from .tensor import (  # noqa: F401,E402
    ColumnParallelDense,
    RowParallelDense,
    TensorParallelMLP,
)
from .ulysses import ulysses_attention  # noqa: F401,E402
