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
tensor: ``allreduce`` with every ``ReduceOp`` but ``Adasum`` (``Average``,
``Sum``, ``Min``, ``Max``, ``Product``), ``grouped_allreduce``,
``allgather``, ``allgather_v``, ``broadcast``, ``reducescatter``,
``alltoall`` (even or uneven splits), ``barrier`` and ``join``; the
in-place ``allreduce_``, ``grouped_allreduce_`` and ``broadcast_``; the
``*_async`` forms (and ``allreduce_async_``, ``grouped_allreduce_async_``,
``broadcast_async_``), each returning a ``Handle`` for ``synchronize``
and ``poll``.  Allreduce, grouped allreduce, allgather, broadcast and
alltoall are differentiable.  A ``process_set`` raises
``NotImplementedError`` (ROADMAP Queue A entry A2), as does
``op=Adasum`` (A8).

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
from .optim.distributed_optimizer import DistributedOptimizer, TrainStep
from .runtime import (
    cross_rank,
    cross_size,
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from .version import __version__

__all__ = [
    "Adasum", "Average", "Compression", "DistributedOptimizer", "Handle", "Max",
    "Min", "Product", "ReduceOp", "Sum", "TrainStep", "__version__",
    "allgather", "allgather_async", "allgather_object", "allgather_v",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "alltoall", "alltoall_async", "barrier", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "cross_rank",
    "cross_size", "device", "grouped_allreduce", "grouped_allreduce_",
    "grouped_allreduce_async", "grouped_allreduce_async_", "init",
    "is_initialized", "join", "local_rank", "local_size", "poll", "rank",
    "reducescatter", "reducescatter_async", "shutdown", "size", "synchronize",
]
