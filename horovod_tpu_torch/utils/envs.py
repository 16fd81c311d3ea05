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

_PREFIXES = ("HVD_", "HOROVOD_")

# Reference Horovod's fusion-buffer default (operations.cc:491-496), and half
# of it for the optimizer's gradient buckets, as in the JAX package.
DEFAULT_FUSION_THRESHOLD_BYTES = 128 * 1024 * 1024
DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024


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


def fusion_threshold_bytes() -> int:
    return get_int(FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES)


def bucket_bytes() -> int:
    return get_int(BUCKET_BYTES, DEFAULT_BUCKET_BYTES)
