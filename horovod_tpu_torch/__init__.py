"""horovod_tpu_torch: the data-parallel path of horovod_tpu on PyTorch
and CUDA (NVIDIA Hopper).

Counterpart of ``horovod_tpu/__init__.py`` for the ported slice:
``init``/``shutdown`` and the rank, local and cross queries on
``torch.distributed``,
``DistributedOptimizer`` over the bucketed scheduler, each bucket
launched from the backward, with the bf16 and the int8/fp8 quantized
wires (``Compression.int8``/``fp8``),
``broadcast_parameters``/``broadcast_optimizer_state``,
``broadcast_object``/``allgather_object``, the ResNet models (50, 101,
152) and their benchmark step, the MNIST models, and the GPT
transformer with flash attention and its language-model step
(``models.transformer``, ``ops.flash``,
``utils.benchmarks.build_lm_step``).

The eager collectives (``ops.eager``), each rank passing its own
tensor: ``allreduce`` with every ``ReduceOp`` (``Average``, ``Sum``,
``Adasum``, ``Min``, ``Max``, ``Product``), ``grouped_allreduce``,
``allgather``, ``allgather_v``, ``broadcast``, ``reducescatter``,
``alltoall`` (even or uneven splits), ``barrier`` and ``join``; the
in-place ``allreduce_``, ``grouped_allreduce_`` and ``broadcast_``; the
``*_async`` forms (and ``allreduce_async_``, ``grouped_allreduce_async_``,
``broadcast_async_``), each returning a ``Handle`` for ``synchronize``
and ``poll``.  Allreduce, grouped allreduce, allgather, broadcast and
alltoall are differentiable.

Topology and hierarchical lowering (``topo``): one NVLink domain per
host, or ``HVD_TPU_TOPO``; ``HVD_TPU_TOPO_LOWER`` and
``DistributedOptimizer(lowering=...)`` take each bucket ``hier`` or
``hier_adasum``.  Adasum (``ops/adasum.py``): ``op=Adasum`` in every
allreduce and in ``DistributedOptimizer``, and
``DistributedAdasumOptimizer``.  ``SyncBatchNorm`` (``sync_batch_norm``)
and sparse gradients (``ops/sparse.py``: ``sparse_allreduce``, and
``DistributedOptimizer`` on ``nn.Embedding(sparse=True)``).

Process sets (``process_sets.py``): ``ProcessSet``, registered by
``init(process_sets=[...])``, ``HVD_TPU_PROCESS_SETS`` or, after
``init(process_sets="dynamic")``, ``add_process_set``;
``remove_process_set``, ``get_process_set_ids`` and
``global_process_set``.  Every eager op, the quantized wire and
``DistributedOptimizer`` take ``process_set=``: members reduce over
the set, non-members keep their own tensor (allreduce, broadcast) or
get zeros (allgather, reducescatter, alltoall), and the quantized wire
reduces within each group of a set that tiles the world.
``is_homogeneous`` and the capability flags (``nccl_built``,
``cuda_built``, ...) answer from ``torch.distributed`` and ``torch.cuda``.

ZeRO-1 and FSDP (``optim/zero.py``): ``zero_train_step`` over a
``ShardedOptimizer``, ``fsdp_train_step``, ``global_norm`` and
``clip_by_global_norm``.  Hybrid parallelism (``parallel``): the mesh,
tensor parallelism, ring and Ulysses attention, the MoE layer over
``ep`` and the GPipe pipeline over ``pp``.

Infrastructure and tuning (PR 16): ``metrics`` (counters, gauges,
histograms, ``render_json``/``render_prometheus``, ``metric_average``),
``events``, ``faults`` (``HVD_TPU_FAULT_PLAN``), ``utils.retry``,
``topo.fit`` (the measured cost model), ``native`` (the C++ core, built
with ``g++`` at first use), and ``HVD_TPU_AUTOTUNE=1``: ``TrainStep``
tunes the fusion threshold, the hierarchical allreduce and the int8
wire by itself (``utils.autotune``); ``sched.tune.ScheduleTuner`` with
the persistent store of ``HVD_TPU_TUNE_DB`` (``sched.store``).

Importing it imports neither JAX nor ``horovod_tpu``.
"""

from .compression import Compression
from .functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .ops.eager import (
    Adasum,
    Average,
    Handle,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
    allgather,
    allgather_async,
    allgather_v,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allreduce,
    grouped_allreduce_,
    grouped_allreduce_async,
    grouped_allreduce_async_,
    join,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from .metrics import metric_average
from .ops.sparse import sparse_allreduce, sparse_allreduce_eager
from .optim.adasum_optimizer import DistributedAdasumOptimizer
from .optim.distributed_optimizer import DistributedOptimizer, TrainStep
from .optim.zero import (
    ShardedOptimizer,
    clip_by_global_norm,
    fsdp_train_step,
    global_norm,
    zero_train_step,
)
from .process_sets import ProcessSet
from .runtime import (
    add_process_set,
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    device,
    get_process_set_ids,
    global_process_set,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    remove_process_set,
    rocm_built,
    shutdown,
    size,
    tpu_enabled,
    xla_built,
)
from .sync_batch_norm import SyncBatchNorm
from .version import __version__

__all__ = [
    "Adasum", "Average", "Compression", "DistributedAdasumOptimizer",
    "DistributedOptimizer", "Handle", "Max", "Min", "ProcessSet", "Product", "ReduceOp",
    "ShardedOptimizer", "Sum", "SyncBatchNorm", "TrainStep",
    "__version__", "clip_by_global_norm", "fsdp_train_step", "global_norm",
    "zero_train_step",
    "add_process_set", "allgather", "allgather_async", "allgather_object",
    "allgather_v", "allreduce", "allreduce_", "allreduce_async",
    "allreduce_async_", "alltoall", "alltoall_async", "barrier", "broadcast",
    "broadcast_", "broadcast_async", "broadcast_async_", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "ccl_built",
    "cross_rank", "cross_size", "cuda_built", "ddl_built", "device",
    "get_process_set_ids", "global_process_set", "gloo_built", "gloo_enabled",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_", "init", "is_homogeneous", "is_initialized",
    "join", "local_rank", "local_size", "metric_average", "mpi_built", "mpi_enabled",
    "mpi_threads_supported", "nccl_built", "poll", "rank", "reducescatter",
    "reducescatter_async", "remove_process_set", "rocm_built", "shutdown",
    "size", "sparse_allreduce", "sparse_allreduce_eager", "synchronize", "tpu_enabled",
    "xla_built",
]
