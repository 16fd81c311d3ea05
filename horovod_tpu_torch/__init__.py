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

from . import autotune, callbacks, data, exceptions
from .callbacks import average_metrics, metric_average
from .conformance import conformance_dump, conformance_stats
from .engine_service import response_cache_stats
from .exceptions import (HorovodInternalError, HostsUpdatedInterrupt,
                         PeerFailureError, QosAdmissionError,
                         ResponseCacheJoinError)
from .health import health_stats
from .metrics import metrics_dump
from .timeline import start_timeline, stop_timeline
from .ops.adasum import adasum_allreduce
from .functions import broadcast_optimizer_state, broadcast_parameters
from .ops.collectives import (Handle, allgather, allgather_async,
                              allgather_object, allreduce, allreduce_async,
                              alltoall, barrier, broadcast, broadcast_async,
                              broadcast_object, grouped_allreduce,
                              grouped_allreduce_async, grouped_broadcast,
                              grouped_broadcast_async, join, poll,
                              reducescatter, synchronize)
from .ops.compression import Compression, Compressor
from .ops.dispatch_cache import stats as dispatch_cache_stats
from .ops.fusion_cycle import fusion_flush
from .ops.fusion_cycle import stats as fusion_stats
from .ops.step_capture import step_marker
from .qos import QosClass, qos_stats, set_qos
from .ops.hierarchical import hierarchical_allgather, hierarchical_allreduce
from .ops.reduce_ops import (Adasum, Average, Max, Min, Product, ReduceOp,
                             Sum)
from .ops.sparse import (SparseRows, sparse_allreduce, sparse_allreduce_async,
                         sparse_allreduce_to_dense)
from .optim import DistributedOptimizer, grad, value_and_grad
from .parallel.mesh import mesh_layout
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
    "NotInitializedError", "PeerFailureError", "ProcessSet", "Product",
    "QosAdmissionError", "QosClass", "ReduceOp", "ResponseCacheJoinError",
    "SparseRows",
    "Sum", "SyncBatchNorm", "adasum_allreduce", "add_process_set",
    "allgather", "allgather_async",
    "allgather_object", "allreduce", "allreduce_async", "alltoall",
    "autotune",
    "average_metrics", "barrier", "broadcast", "broadcast_async",
    "broadcast_object", "broadcast_optimizer_state", "broadcast_parameters",
    "callbacks", "conformance_dump", "conformance_stats", "cross_rank",
    "cross_size", "cuda_built", "data", "device", "dispatch_cache_stats",
    "exceptions", "fusion_flush", "fusion_stats", "global_process_set",
    "grad", "grouped_allreduce",
    "grouped_allreduce_async", "grouped_broadcast", "grouped_broadcast_async",
    "health_stats", "hierarchical_allgather", "hierarchical_allreduce",
    "init", "is_homogeneous", "is_initialized", "join", "local_rank",
    "local_size", "mesh_layout", "metric_average", "metrics_dump",
    "nccl_built", "poll", "qos_stats", "rank", "reducescatter",
    "remove_process_set", "response_cache_stats", "set_qos", "shutdown",
    "size",
    "sparse_allreduce", "sparse_allreduce_async",
    "sparse_allreduce_to_dense", "start_timeline", "step_marker",
    "stop_timeline",
    "synchronize", "tpu_built", "value_and_grad", "xla_built",
]
