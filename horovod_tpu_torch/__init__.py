"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The same Horovod-shaped API over ``torch`` tensors, ``torch.distributed``
and NCCL, for one process per card::

    import horovod_tpu_torch as hvd
    hvd.init()                                   # NCCL, cuda:<LOCAL_RANK>
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters()))
    loss.backward(); opt.step()

Module layout mirrors the JAX package: ``horovod_tpu/X.py`` maps to
``horovod_tpu_torch/X.py``. The package imports nothing of JAX.
"""

from . import callbacks, data, exceptions
from .callbacks import average_metrics, metric_average
from .exceptions import HorovodInternalError, HostsUpdatedInterrupt
from .functions import broadcast_optimizer_state, broadcast_parameters
from .ops.collectives import (Handle, allgather, allgather_async,
                              allgather_object, allreduce, allreduce_async,
                              alltoall, barrier, broadcast, broadcast_async,
                              broadcast_object, grouped_allreduce,
                              grouped_allreduce_async, grouped_broadcast,
                              grouped_broadcast_async, poll, reducescatter,
                              synchronize)
from .ops.compression import Compression, Compressor
from .ops.reduce_ops import (Adasum, Average, Max, Min, Product, ReduceOp,
                             Sum)
from .ops.sparse import (SparseRows, sparse_allreduce, sparse_allreduce_async,
                         sparse_allreduce_to_dense)
from .optim import DistributedOptimizer, grad, value_and_grad
from .models.sync_batch_norm import SyncBatchNorm
from .process_sets import (ProcessSet, add_process_set, global_process_set,
                           remove_process_set)
from .runtime import (NotInitializedError, cross_rank, cross_size, cuda_built,
                      device, init, is_homogeneous, is_initialized,
                      local_rank, local_size, nccl_built, rank, shutdown,
                      size, tpu_built, xla_built)

__all__ = [
    "Adasum", "Average", "Compression", "Compressor", "DistributedOptimizer",
    "Handle", "HorovodInternalError", "HostsUpdatedInterrupt", "Max", "Min",
    "NotInitializedError", "ProcessSet", "Product", "ReduceOp", "SparseRows",
    "Sum", "SyncBatchNorm", "add_process_set", "allgather", "allgather_async",
    "allgather_object", "allreduce", "allreduce_async", "alltoall",
    "average_metrics", "barrier", "broadcast", "broadcast_async",
    "broadcast_object", "broadcast_optimizer_state", "broadcast_parameters",
    "callbacks", "cross_rank", "cross_size", "cuda_built", "data", "device",
    "exceptions", "global_process_set", "grad", "grouped_allreduce",
    "grouped_allreduce_async", "grouped_broadcast", "grouped_broadcast_async",
    "init", "is_homogeneous", "is_initialized", "local_rank", "local_size",
    "metric_average", "nccl_built", "poll", "rank", "reducescatter",
    "remove_process_set", "shutdown", "size", "sparse_allreduce",
    "sparse_allreduce_async", "sparse_allreduce_to_dense", "synchronize",
    "tpu_built", "value_and_grad", "xla_built",
]
