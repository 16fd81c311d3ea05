"""Environment-variable knobs read by the port.

Only the knobs the port reads, with the names and defaults of
``horovod_tpu/utils/envs.py``. Every knob is spelled ``HVD_<NAME>``; the
reference Horovod's ``HOROVOD_<NAME>`` spelling is accepted as a fallback.
"""

from __future__ import annotations

import os

FUSION_THRESHOLD = "FUSION_THRESHOLD"  # bytes per fused wire buffer
BUCKET_BYTES = "BUCKET_BYTES"  # gradient bucket size (0 = whole tree)
LOG_LEVEL = "LOG_LEVEL"  # trace|debug|info|warning|error|fatal
LOG_TIMESTAMP = "LOG_TIMESTAMP"  # prefix log lines with the time (default on)
DYNAMIC_PROCESS_SETS = "DYNAMIC_PROCESS_SETS"  # add_process_set after init
SPARSE_AS_DENSE = "SPARSE_AS_DENSE"  # sparse gradients take a dense allreduce
HIERARCHICAL_ALLREDUCE = "HIERARCHICAL_ALLREDUCE"  # two-level global allreduce
HIERARCHICAL_ALLGATHER = "HIERARCHICAL_ALLGATHER"  # two-level global allgather
HIERARCHICAL_ICI_SIZE = "HIERARCHICAL_ICI_SIZE"  # ranks a node; default local_size
MESH_AXES = "MESH_AXES"  # model-axis carve, e.g. "seq:2" or "expert:4,stage:2"
# The port's own: seconds a collective may wait on its peers before the
# process group declares it hung (torch's default when unset); NCCL's
# watchdog then aborts the rank, dumping its flight recorder if
# TORCH_NCCL_DUMP_ON_TIMEOUT is set.
PROCESS_GROUP_TIMEOUT = "PROCESS_GROUP_TIMEOUT"
# The negotiation service of multi-process eager collectives
# (engine_service.py): on by default where a launcher's KV store is set
DYNAMIC_ENGINE = "DYNAMIC_ENGINE"  # 0 disables multi-process negotiation
KV_ADDR = "KV_ADDR"  # the launcher's KV server (runner/http_kv.py)
KV_PORT = "KV_PORT"
SECRET_KEY = "SECRET_KEY"  # the job's HMAC secret of KV messages
STALL_CHECK_DISABLE = "STALL_CHECK_DISABLE"
STALL_CHECK_TIME_SECONDS = "STALL_CHECK_TIME_SECONDS"  # warn after (60 s)
STALL_SHUTDOWN_TIME_SECONDS = "STALL_SHUTDOWN_TIME_SECONDS"  # 0: never
CYCLE_TIME = "CYCLE_TIME"  # ms between idle negotiation cycles
ADAPTIVE_CYCLE = "ADAPTIVE_CYCLE"  # event-driven negotiation tick (default on)
PENDING_CYCLE_TIME = "PENDING_CYCLE_TIME"  # ms; cycle floor while work is in flight

_PREFIXES = ("HVD_", "HOROVOD_")

# Reference Horovod's fusion-buffer default (operations.cc:491-496), and half
# of it for the optimizer's gradient buckets, as in the JAX package.
DEFAULT_FUSION_THRESHOLD_BYTES = 128 * 1024 * 1024
DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024
# the reference's stall warning (stall_inspector.h:78)
DEFAULT_STALL_WARNING_SECONDS = 60.0


def get(name: str, default: str | None = None) -> str | None:
    """The value of knob ``name`` under the first prefix that is set."""
    for prefix in _PREFIXES:
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


def get_bool(name: str, default: bool = False) -> bool:
    val = get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def get_int(name: str, default: int) -> int:
    val = get(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    val = get(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        return default


def fusion_threshold_bytes() -> int:
    return get_int(FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES)


def bucket_bytes() -> int:
    return get_int(BUCKET_BYTES, DEFAULT_BUCKET_BYTES)


def mesh_axes() -> str:
    """``HVD_MESH_AXES``: the model axes carved out of a node
    (``parallel/mesh.py``), a comma list of ``name:size`` pairs such as
    ``"seq:2"`` or ``"expert:4,stage:2"``; empty for none."""
    return (get(MESH_AXES, "") or "").strip()
