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
# The launcher's worker contract (runner/launch.py worker_env), the JAX
# package's names; torch.distributed's RANK, WORLD_SIZE, LOCAL_RANK,
# LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT go beside them
RANK = "RANK"
SIZE = "SIZE"
LOCAL_RANK = "LOCAL_RANK"
LOCAL_SIZE = "LOCAL_SIZE"
CROSS_RANK = "CROSS_RANK"
CROSS_SIZE = "CROSS_SIZE"
COORDINATOR_ADDR = "COORDINATOR_ADDR"  # rank 0's host: MASTER_ADDR
COORDINATOR_PORT = "COORDINATOR_PORT"  # its TCPStore port: MASTER_PORT
NUM_PROCESSES = "NUM_PROCESSES"
PROCESS_ID = "PROCESS_ID"
HOSTNAME = "HOSTNAME"  # the launcher's name of this worker's host
# The port's own: the card this worker drives, an index among the visible
# ones, from the launcher's per-machine pool (runtime.init reads it before
# LOCAL_RANK, so two aliases of one machine never share a card)
CUDA_DEVICE = "CUDA_DEVICE"
START_TIMEOUT = "START_TIMEOUT"  # s a run() worker waits for its function
ELASTIC = "ELASTIC"  # "1" in workers launched by an elastic driver
ELASTIC_ROUND = "ELASTIC_ROUND"  # the round a worker runs in
ELASTIC_TIMEOUT = "ELASTIC_TIMEOUT"  # s to wait for slots or a next round
ELASTIC_GRACE = "ELASTIC_GRACE"  # s a slot-removed worker gets to exit (0: kill)
ELASTIC_WARM = "ELASTIC_WARM"  # auto|1|0: plans and cache entries survive a re-form
# The closed-loop autoscale policy (elastic/policy.py)
AUTOSCALE = "AUTOSCALE"  # the driver-side policy (0 = scripted/manual churn only)
AUTOSCALE_SLO_MS = "AUTOSCALE_SLO_MS"  # step-time SLO; 0 = breach/idle rules off (evict only)
AUTOSCALE_INTERVAL = "AUTOSCALE_INTERVAL"  # s per policy evaluation window
AUTOSCALE_BREACH_WINDOWS = "AUTOSCALE_BREACH_WINDOWS"  # breach windows in a row before a scale-up
AUTOSCALE_IDLE_WINDOWS = "AUTOSCALE_IDLE_WINDOWS"  # idle windows in a row before a graceful scale-down
AUTOSCALE_EVICT_WINDOWS = "AUTOSCALE_EVICT_WINDOWS"  # windows blaming one straggler before eviction
AUTOSCALE_COOLDOWN = "AUTOSCALE_COOLDOWN"  # s after a membership decision before the next
AUTOSCALE_MIN = "AUTOSCALE_MIN"  # world floor (default: the driver's min_np)
AUTOSCALE_MAX = "AUTOSCALE_MAX"  # world ceiling (default: the driver's max_np)
AUTOSCALE_GRACE = "AUTOSCALE_GRACE"  # s of slot-lost grace a policy departure gets
AUTOSCALE_IDLE_FACTOR = "AUTOSCALE_IDLE_FACTOR"  # share of the SLO under which a window is idle
SPARK_START_TIMEOUT = "SPARK_START_TIMEOUT"  # s Spark's barrier tasks may take to start
STALL_CHECK_DISABLE = "STALL_CHECK_DISABLE"
STALL_CHECK_TIME_SECONDS = "STALL_CHECK_TIME_SECONDS"  # warn after (60 s)
STALL_SHUTDOWN_TIME_SECONDS = "STALL_SHUTDOWN_TIME_SECONDS"  # 0: never
CYCLE_TIME = "CYCLE_TIME"  # ms between idle negotiation cycles
ADAPTIVE_CYCLE = "ADAPTIVE_CYCLE"  # event-driven negotiation tick (default on)
PENDING_CYCLE_TIME = "PENDING_CYCLE_TIME"  # ms; cycle floor while work is in flight
# The negotiation control plane (negotiation/) and the observability it
# reports to (timeline.py, metrics.py, health.py, conformance.py,
# utils/faults.py, utils/retry.py)
RESPONSE_CACHE = "RESPONSE_CACHE"  # auto|0|1|capacity: the coordinator ResponseCache
NEGOTIATION_GROUP_SIZE = "NEGOTIATION_GROUP_SIZE"  # ranks a leader group
HIER_NEGOTIATION = "HIER_NEGOTIATION"  # auto|1|0: the two-level exchange
TIMELINE = "TIMELINE"  # Chrome-trace output path (operations.cc:466-488)
TIMELINE_MARK_CYCLES = "TIMELINE_MARK_CYCLES"  # an instant a negotiation cycle
METRICS = "METRICS"  # unified metrics registry (0 = hot instruments off)
METRICS_PORT = "METRICS_PORT"  # base port of the per-worker /metrics server
HEALTH_INTERVAL = "HEALTH_INTERVAL"  # s between liveness beats (0 = watchdog off)
HEALTH_TIMEOUT = "HEALTH_TIMEOUT"  # s without a beat: the peer is dead
STRAGGLER_THRESHOLD = "STRAGGLER_THRESHOLD"  # s of submit lag of a straggler
CONFORMANCE = "CONFORMANCE"  # cross-rank lockstep conformance recorder (0 = off)
CONFORMANCE_DIR = "CONFORMANCE_DIR"  # trace directory (empty: on demand only)
CONFORMANCE_RING = "CONFORMANCE_RING"  # full-payload ring capacity of the recorder
FAULT_SPEC = "FAULT_SPEC"  # deterministic fault-injection spec (tests, chaos runs)
RETRY_MAX_ATTEMPTS = "RETRY_MAX_ATTEMPTS"  # attempts per retried KV call
RETRY_BACKOFF_MS = "RETRY_BACKOFF_MS"  # backoff before the first retry
RETRY_MAX_BACKOFF_MS = "RETRY_MAX_BACKOFF_MS"  # backoff growth cap
RETRY_JITTER = "RETRY_JITTER"  # +/- fraction of deterministic jitter on backoff
# The fusion and plan machinery (ops/fusion_cycle.py, ops/dispatch_cache.py,
# ops/step_capture.py, qos.py, autotune.py, utils/invariants.py)
FUSION_MAX_PENDING = "FUSION_MAX_PENDING"  # bytes; fusion-cycle backpressure cap (default 4x FUSION_THRESHOLD)
MAX_INFLIGHT_FLUSHES = "MAX_INFLIGHT_FLUSHES"  # pipelined flush executor slots (0/1 = synchronous)
PIPELINE_THRESHOLD = "PIPELINE_THRESHOLD"  # bytes; fused wire buffers past this split into chunks
PIPELINE_CHUNKS = "PIPELINE_CHUNKS"  # chunk count for the large-buffer software pipeline
CACHE_CAPACITY = "CACHE_CAPACITY"  # dispatch plans kept (reference default 1024; 0 = off)
STEP_CAPTURE = "STEP_CAPTURE"  # capture-and-replay of the per-step collective stream (0 = off)
GSPMD_CACHE = "GSPMD_CACHE"  # hvd.cached_step's whole-step plans (0 = plain calls)
GSPMD_CACHE_DONATE = "GSPMD_CACHE_DONATE"  # auto|1|0: a cached step returns its graph's own tensors
CKPT_DIR = "CKPT_DIR"  # sharded background snapshot directory (empty = state plane off)
CKPT_INTERVAL = "CKPT_INTERVAL"  # commits between background snapshots
CKPT_PEER_RESTORE = "CKPT_PEER_RESTORE"  # state re-sync from peers' shards (0 = rank-0 broadcast)
CKPT_SHARD_QUORUM = "CKPT_SHARD_QUORUM"  # least survivors of one consistent state before peer restore
DEBUG_INVARIANTS = "DEBUG_INVARIANTS"  # dev-mode runtime invariant checker
QOS = "QOS"  # multi-tenant QoS collective engine (0 = single-tenant FIFO)
QOS_WINDOW = "QOS_WINDOW"  # arbitration window: parked batches before a pump grants
QOS_QUANTUM = "QOS_QUANTUM"  # DRR quantum bytes credited per weight unit per round
QOS_STARVE_LIMIT = "QOS_STARVE_LIMIT"  # grants between forced oldest-first grants (0 = off)
QOS_DEFAULT_PRIORITY = "QOS_DEFAULT_PRIORITY"  # tier for unconfigured tenants
QOS_DEFAULT_WEIGHT = "QOS_DEFAULT_WEIGHT"  # DRR weight for unconfigured tenants
QOS_PENDING_QUOTA = "QOS_PENDING_QUOTA"  # default per-tenant pending-bytes quota (0 = unlimited)
QOS_SHED_POLICY = "QOS_SHED_POLICY"  # quota policy for unconfigured tenants: block | shed
QOS_CLASSES = "QOS_CLASSES"  # per-tenant class spec string (the JAX package's docs/qos.md grammar)
AUTOTUNE = "AUTOTUNE"
AUTOTUNE_STRATEGY = "AUTOTUNE_STRATEGY"  # coordinate (default) | bayesian
AUTOTUNE_LOG = "AUTOTUNE_LOG"
AUTOTUNE_WARMUP_SAMPLES = "AUTOTUNE_WARMUP_SAMPLES"
AUTOTUNE_STEPS_PER_SAMPLE = "AUTOTUNE_STEPS_PER_SAMPLE"
AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
AUTOTUNE_GAUSSIAN_PROCESS_NOISE = "AUTOTUNE_GAUSSIAN_PROCESS_NOISE"

_PREFIXES = ("HVD_", "HOROVOD_")

# Reference Horovod's fusion-buffer default (operations.cc:491-496), and half
# of it for the optimizer's gradient buckets, as in the JAX package.
DEFAULT_FUSION_THRESHOLD_BYTES = 128 * 1024 * 1024
DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024
# the reference's stall warning (stall_inspector.h:78)
DEFAULT_STALL_WARNING_SECONDS = 60.0


# Runtime knob overrides (the reference's ParameterManager mutates live
# knob values, operations.cc:490-523). They sit under the environment: an
# environment variable always wins. Consumers that cache derived state (the
# coordinator ResponseCache) compare epochs instead of re-reading knobs.
_overrides: dict[str, str] = {}
_override_epoch = 0


def override_epoch() -> int:
    """Monotonic counter of override mutations."""
    return _override_epoch


def set_override(name: str, value) -> None:
    """Install a runtime override of knob ``name``; re-applying the same
    value does not move the epoch."""
    global _override_epoch
    value = str(value)
    if _overrides.get(name) == value:
        return
    _overrides[name] = value
    _override_epoch += 1


def clear_override(name: str) -> None:
    global _override_epoch
    if _overrides.pop(name, None) is not None:
        _override_epoch += 1


def clear_overrides() -> None:
    global _override_epoch
    if _overrides:
        _override_epoch += 1
    _overrides.clear()


def is_env_fixed(name: str) -> bool:
    """True when the user pinned knob ``name`` in the environment: the
    autotuner treats it as untunable (reference ``operations.cc:490-523``)."""
    return any(os.environ.get(p + name) is not None for p in _PREFIXES)


def get(name: str, default: str | None = None) -> str | None:
    """The value of knob ``name`` under the first prefix that is set, else
    its runtime override, else ``default``."""
    for prefix in _PREFIXES:
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    val = _overrides.get(name)
    return default if val is None else val


def require(name: str) -> str:
    """Knob ``name`` as :func:`get` reads it, raising where it is absent:
    for the launcher's worker contract, where a missing variable means the
    process was not started by a launcher."""
    val = get(name)
    if val is None:
        raise RuntimeError(
            f"required environment variable HVD_{name} is not set (workers "
            "are started by python -m horovod_tpu_torch.runner.launch)")
    return val


def set_env(name: str, value, *, only_if_unset: bool = False) -> None:
    """Write knob ``name`` into the process environment as ``HVD_<name>``;
    ``only_if_unset`` keeps a value already set under either prefix."""
    if only_if_unset and any(os.environ.get(p + name) is not None
                             for p in _PREFIXES):
        return
    os.environ["HVD_" + name] = str(value)


def elastic_warm_enabled() -> bool:
    """``HVD_ELASTIC_WARM``: whether dispatch plans and coordinator cache
    entries are shelved at a re-form and restored at the next re-form to
    the same shape. ``auto`` (the default) is on in the workers of an
    elastic job (``HVD_ELASTIC=1``): a worker of the port re-forms in its
    own process, whose host-side state stays valid. Elsewhere nothing
    re-forms, and a process that starts one world after another (tests)
    keeps them apart."""
    val = (get(ELASTIC_WARM, "auto") or "auto").strip().lower()
    if val in ("1", "true", "yes", "on"):
        return True
    if val in ("0", "false", "no", "off"):
        return False
    return get_bool(ELASTIC)


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


def launcher_rank() -> int | None:
    """This process's rank as the launcher set it (``HVD_RANK``, else the
    ``RANK`` of ``torch.distributed``'s launch contract), before or without
    :func:`runtime.init`; None outside a launched world."""
    for val in (get("RANK"), os.environ.get("RANK")):
        if val is not None:
            try:
                return int(val)
            except ValueError:
                pass
    return None


# Failure-domain defaults (docs/robustness.md): a dead peer surfaces as a
# PeerFailureError in seconds, far inside the 600 s exchange deadline; the
# retry ladder (50 ms * 2^k capped at 2 s, 5 attempts) absorbs seconds of
# KV flap.
DEFAULT_HEALTH_INTERVAL_S = 2.0
DEFAULT_HEALTH_TIMEOUT_S = 30.0
DEFAULT_STRAGGLER_THRESHOLD_S = 1.0
DEFAULT_RETRY_MAX_ATTEMPTS = 5
DEFAULT_RETRY_BACKOFF_MS = 50.0
DEFAULT_RETRY_MAX_BACKOFF_MS = 2000.0
DEFAULT_RETRY_JITTER = 0.25
DEFAULT_CONFORMANCE_RING = 256
# Hierarchical control plane (docs/negotiation.md): one leader per group of
# 8; the coordinator ResponseCache is on by default where the hierarchy is.
DEFAULT_NEGOTIATION_GROUP_SIZE = 8
DEFAULT_RESPONSE_CACHE_CAPACITY = 1024


# The autoscale policy's defaults (the JAX package's): a window every 2 s,
# 3 breach windows before a scale-up, 5 idle windows before a scale-down
# (shrinking costs a re-form), 3 blame windows before an eviction, and a
# 15 s cooldown, so that one decision's own disruption never reads as the
# next window's signal.
DEFAULT_AUTOSCALE_INTERVAL_S = 2.0
DEFAULT_AUTOSCALE_BREACH_WINDOWS = 3
DEFAULT_AUTOSCALE_IDLE_WINDOWS = 5
DEFAULT_AUTOSCALE_EVICT_WINDOWS = 3
DEFAULT_AUTOSCALE_COOLDOWN_S = 15.0
DEFAULT_AUTOSCALE_GRACE_S = 30.0
DEFAULT_AUTOSCALE_IDLE_FACTOR = 0.5


def autoscale_enabled() -> bool:
    """``HVD_AUTOSCALE``: the driver-side policy chooses ``add``,
    ``remove`` and ``evict`` from the workers' sensors. Off by default."""
    return get_bool(AUTOSCALE, False)


def autoscale_slo_s() -> float:
    """The step-time SLO in seconds (the knob is in ms); 0 turns the
    breach and idle rules off, leaving eviction."""
    return get_float(AUTOSCALE_SLO_MS, 0.0) / 1e3


def autoscale_interval_s() -> float:
    return get_float(AUTOSCALE_INTERVAL, DEFAULT_AUTOSCALE_INTERVAL_S)


def health_interval_s() -> float:
    return get_float(HEALTH_INTERVAL, DEFAULT_HEALTH_INTERVAL_S)


def health_timeout_s() -> float:
    return get_float(HEALTH_TIMEOUT, DEFAULT_HEALTH_TIMEOUT_S)


def straggler_threshold_s() -> float:
    return get_float(STRAGGLER_THRESHOLD, DEFAULT_STRAGGLER_THRESHOLD_S)


def conformance_enabled() -> bool:
    """The lockstep conformance recorder (``conformance.py``); off by
    default."""
    return get_bool(CONFORMANCE, False)


def conformance_dir() -> str:
    """``HVD_CONFORMANCE_DIR``: where traces are dumped at shutdown; empty
    keeps them in memory until ``conformance_dump()``."""
    return (get(CONFORMANCE_DIR, "") or "").strip()


def conformance_ring() -> int:
    return max(0, get_int(CONFORMANCE_RING, DEFAULT_CONFORMANCE_RING))


def negotiation_group_size() -> int:
    return max(1, get_int(NEGOTIATION_GROUP_SIZE,
                          DEFAULT_NEGOTIATION_GROUP_SIZE))


def hier_negotiation_enabled(world_size: int) -> bool:
    """Whether a service of ``world_size`` members runs the two-level
    exchange: ``auto`` (default) past one leader group, ``1`` whenever the
    world has two members or more, ``0`` never."""
    val = (get(HIER_NEGOTIATION, "auto") or "auto").strip().lower()
    if val in ("1", "true", "yes", "on"):
        return world_size > 1
    if val in ("0", "false", "no", "off"):
        return False
    return world_size > negotiation_group_size()


def response_cache_capacity(world_size: int | None = None) -> int:
    """``HVD_RESPONSE_CACHE``: ``auto`` (default) is on at the default
    capacity where the hierarchical exchange runs for ``world_size`` (off
    for ``None``), ``0`` off, ``1`` on at the default capacity, a larger
    value on with that many entries."""
    raw = (get(RESPONSE_CACHE, "auto") or "auto").strip().lower()
    if raw in ("auto", ""):
        if world_size is not None and hier_negotiation_enabled(world_size):
            return DEFAULT_RESPONSE_CACHE_CAPACITY
        return 0
    try:
        v = int(raw)
    except ValueError:
        v = 0
    if v <= 0:
        return 0
    return DEFAULT_RESPONSE_CACHE_CAPACITY if v == 1 else v


# The fusion cycle and its pipelined executor (the JAX package's defaults,
# envs.py:282-346): the cycle is on while HVD_CYCLE_TIME > 0 (1 ms, the
# reference's default); two in-flight flushes double-buffer the executor;
# fused wire buffers past 4 MiB issue as 4 chunk collectives.
DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_MAX_INFLIGHT_FLUSHES = 2
DEFAULT_PIPELINE_THRESHOLD_BYTES = 4 * 1024 * 1024
DEFAULT_PIPELINE_CHUNKS = 4
DEFAULT_QOS_WINDOW = 4
DEFAULT_QOS_QUANTUM = 64 * 1024
DEFAULT_QOS_STARVE_LIMIT = 16
DEFAULT_QOS_WEIGHT = 1.0


def cycle_time_ms() -> float:
    """The fusion cycle's pace (``HVD_CYCLE_TIME``, ms; 0 turns the cycle
    off). The negotiation service reads the same knob with its own
    default (``engine_service.DEFAULT_KV_CYCLE_TIME_MS``)."""
    return get_float(CYCLE_TIME, DEFAULT_CYCLE_TIME_MS)


def cache_capacity() -> int:
    return get_int(CACHE_CAPACITY, DEFAULT_CACHE_CAPACITY)


def max_inflight_flushes() -> int:
    return get_int(MAX_INFLIGHT_FLUSHES, DEFAULT_MAX_INFLIGHT_FLUSHES)


def pipeline_enabled() -> bool:
    """The pipelined flush executor is engaged at >= 2 slots; 0/1 execute
    a flush on the thread that triggered it."""
    return max_inflight_flushes() >= 2


def pipeline_threshold_bytes() -> int:
    return get_int(PIPELINE_THRESHOLD, DEFAULT_PIPELINE_THRESHOLD_BYTES)


def pipeline_chunks() -> int:
    return get_int(PIPELINE_CHUNKS, DEFAULT_PIPELINE_CHUNKS)


def pipeline_chunking_enabled() -> bool:
    """Chunked dispatch of large wire buffers rides the pipelined
    executor: with it off, a flush issues one collective a buffer."""
    return (pipeline_enabled() and pipeline_threshold_bytes() > 0
            and pipeline_chunks() >= 2)


def qos_enabled() -> bool:
    """The multi-tenant QoS engine (``qos.py``); off by default."""
    return get_bool(QOS, False)


def qos_window() -> int:
    return get_int(QOS_WINDOW, DEFAULT_QOS_WINDOW)


def qos_quantum_bytes() -> int:
    return get_int(QOS_QUANTUM, DEFAULT_QOS_QUANTUM)


def qos_starve_limit() -> int:
    return get_int(QOS_STARVE_LIMIT, DEFAULT_QOS_STARVE_LIMIT)


def step_capture_enabled() -> bool:
    """Step capture-and-replay (``ops/step_capture.py``); off by default,
    and off while the QoS engine is on (capture assumes one repeating
    single-tenant flush stream), as in the JAX package."""
    return get_bool(STEP_CAPTURE, False) and not qos_enabled()


def gspmd_cache_enabled() -> bool:
    """``hvd.cached_step``'s plans (``ops/gspmd_cache.py``); on by
    default (the API is an opt-in, the knob a kill switch), and off with
    the whole dispatch plan cache (``HVD_CACHE_CAPACITY=0``)."""
    return get_bool(GSPMD_CACHE, True) and cache_capacity() > 0


def donation_effective(platform: str) -> bool:
    """Whether handing a step's own buffers back saves memory on this
    device type: on the card a cached step's outputs are its graph's
    tensors; the host keeps no graph."""
    return platform not in ("cpu",)


def gspmd_donate_enabled(platform: str) -> bool:
    """Whether a cached step returns its graph's own output tensors (which
    its next replay overwrites) rather than clones; ``auto`` follows
    :func:`donation_effective`."""
    val = (get(GSPMD_CACHE_DONATE, "auto") or "auto").strip().lower()
    if val in ("1", "true", "yes", "on"):
        return True
    if val in ("0", "false", "no", "off"):
        return False
    return donation_effective(platform)


# The checkpoint state plane (``checkpoint.py``): a snapshot every tenth
# commit; peer restore on by default, since it serves from the survivors'
# live committed state and the rank-0 broadcast stays its typed fallback.
DEFAULT_CKPT_INTERVAL = 10
DEFAULT_CKPT_SHARD_QUORUM = 1


def ckpt_dir() -> str:
    """``HVD_CKPT_DIR``: the root of the background sharded snapshots;
    empty (default) turns the state plane off."""
    return (get(CKPT_DIR, "") or "").strip()


def ckpt_interval() -> int:
    return max(1, get_int(CKPT_INTERVAL, DEFAULT_CKPT_INTERVAL))


def ckpt_peer_restore_enabled() -> bool:
    """Whether a state re-sync pulls shards from the survivors instead of
    rank 0's broadcast of the whole state."""
    return get_bool(CKPT_PEER_RESTORE, True)


def ckpt_shard_quorum() -> int:
    return max(1, get_int(CKPT_SHARD_QUORUM, DEFAULT_CKPT_SHARD_QUORUM))
