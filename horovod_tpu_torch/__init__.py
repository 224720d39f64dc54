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
``utils.benchmarks.build_lm_step``).  Importing it imports neither JAX
nor ``horovod_tpu``.
"""

from .compression import Compression
from .functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .ops.collectives import (
    Average,
    ReduceOp,
    Sum,
    allreduce,
    allreduce_,
    broadcast,
    broadcast_,
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
    "Average", "Compression", "DistributedOptimizer", "ReduceOp", "Sum",
    "TrainStep", "__version__", "allgather_object", "allreduce",
    "allreduce_", "broadcast", "broadcast_", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters",
    "cross_rank", "cross_size", "device", "init", "is_initialized",
    "local_rank", "local_size", "rank", "shutdown", "size",
]
