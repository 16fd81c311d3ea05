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

from . import (autotune, callbacks, checkpoint, conformance, data, elastic,
               exceptions, metrics, parallel, qos)
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
from .functions import (broadcast_optimizer_state, broadcast_parameters,
                        broadcast_variables)
from .ops.collectives import (Handle, allgather, allgather_async,
                              allgather_object, allreduce, allreduce_,
                              allreduce_async, alltoall, alltoall_async,
                              barrier, broadcast, broadcast_,
                              broadcast_async,
                              broadcast_object, grouped_allreduce,
                              grouped_allreduce_async, grouped_broadcast,
                              grouped_broadcast_async, join, poll,
                              reducescatter, synchronize)
from .ops.compression import Compression, Compressor
from .ops.dispatch_cache import stats as dispatch_cache_stats
from .ops.fusion_cycle import fusion_flush
from .ops.fusion_cycle import stats as fusion_stats
from .ops.gspmd_cache import cached_step
from .ops.gspmd_cache import stats as gspmd_cache_stats
from .ops.step_capture import step_marker
from .qos import QosClass, qos_stats, set_qos
from .ops.hierarchical import hierarchical_allgather, hierarchical_allreduce
from .ops.reduce_ops import (Adasum, Average, Max, Min, Product, ReduceOp,
                             Sum)
from .ops.sparse import (SparseRows, rows_from_dense, rows_to_dense,
                         sparse_allreduce, sparse_allreduce_async,
                         sparse_allreduce_to_dense)
from .optim import DistributedOptimizer, grad, value_and_grad
from .parallel.mesh import (MeshLayout, MeshLayoutError, composed_mesh,
                            mesh_layout, sync_gradients)
from .models.sync_batch_norm import SyncBatchNorm
from .process_sets import (ProcessSet, add_process_set, global_process_set,
                           remove_process_set)
from .runtime import (NotInitializedError, ccl_built, cross_rank, cross_size,
                      cuda_built, ddl_built, device, gloo_built,
                      gloo_enabled, init, is_homogeneous, is_initialized,
                      local_rank, local_ranks, local_size, mpi_built,
                      mpi_enabled, mpi_threads_supported, nccl_built,
                      process_count, process_of_rank, process_rank, rank,
                      rocm_built, shutdown, size, tpu_built, xla_built,
                      xla_enabled)
from .version import __version__

__all__ = [
    "Adasum", "Average", "Compression", "Compressor", "DistributedOptimizer",
    "Handle", "HorovodInternalError", "HostsUpdatedInterrupt", "Max",
    "MeshLayout", "MeshLayoutError", "Min", "NotInitializedError",
    "PeerFailureError", "ProcessSet", "Product", "QosAdmissionError",
    "QosClass", "ReduceOp", "ResponseCacheJoinError", "SparseRows", "Sum",
    "SyncBatchNorm", "__version__", "adasum_allreduce", "add_process_set",
    "allgather", "allgather_async", "allgather_object", "allreduce",
    "allreduce_", "allreduce_async", "alltoall", "alltoall_async",
    "autotune", "average_metrics", "barrier", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_object", "broadcast_optimizer_state",
    "broadcast_parameters", "broadcast_variables", "cached_step",
    "callbacks", "ccl_built", "checkpoint", "composed_mesh", "conformance",
    "conformance_dump", "conformance_stats", "cross_rank", "cross_size",
    "cuda_built", "data", "ddl_built", "device", "dispatch_cache_stats",
    "elastic", "exceptions", "fusion_flush", "fusion_stats", "gloo_built",
    "gloo_enabled", "global_process_set", "grad", "grouped_allreduce",
    "grouped_allreduce_async", "grouped_broadcast", "grouped_broadcast_async",
    "gspmd_cache_stats", "health_stats", "hierarchical_allgather",
    "hierarchical_allreduce", "init", "is_homogeneous", "is_initialized",
    "join", "local_rank", "local_ranks", "local_size", "mesh_layout",
    "metric_average", "metrics", "metrics_dump", "mpi_built", "mpi_enabled",
    "mpi_threads_supported", "nccl_built", "parallel", "poll",
    "process_count", "process_rank", "qos", "qos_stats", "rank",
    "reducescatter", "remove_process_set", "response_cache_stats",
    "rocm_built", "rows_from_dense", "rows_to_dense", "set_qos", "shutdown",
    "size", "sparse_allreduce", "sparse_allreduce_async",
    "sparse_allreduce_to_dense", "start_timeline", "step_marker",
    "stop_timeline", "sync_gradients", "synchronize", "tpu_built",
    "value_and_grad", "xla_built", "xla_enabled",
]
