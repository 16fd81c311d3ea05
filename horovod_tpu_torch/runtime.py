"""Process-group lifecycle and rank queries.

The port of ``horovod_tpu/runtime.py``: one process per card, joined by
``torch.distributed`` (NCCL on CUDA, gloo when the caller asks for the CPU).
The world comes from the launcher's standard environment: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` (``python -m horovod_tpu_torch.runner.launch`` sets them,
as ``torchrun`` does). Where they are missing and a scheduler's task
variables name a world of several processes (``srun``, ``mpirun``, PMI,
``jsrun``), they are derived from those, and rank 0 starts the KV store of
the negotiation service. A process started with neither is a world of one,
whose rendezvous store listens on a port the OS picks. The card is
``HVD_CUDA_DEVICE`` where the launcher set it (its per-machine pool), else
``cuda:LOCAL_RANK``. Each :func:`init` starts a fresh process-set table
(``process_sets.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import socket
from typing import Any, Sequence

import torch
import torch.distributed as dist

from .utils import envs
from .utils import logging as hvd_logging


class NotInitializedError(RuntimeError):
    """A runtime query was made before :func:`init`."""


@dataclasses.dataclass(frozen=True)
class _RuntimeState:
    device: torch.device
    rank: int
    size: int
    local_rank: int
    local_size: int
    owns_group: bool  # init() created the process group, shutdown() ends it
    process_set_table: Any = None  # process_sets.ProcessSetTable
    homogeneous: bool = True  # every node runs the same number of ranks
    # rank tuple -> group, made by partition_groups; ended at shutdown()
    groups: dict = dataclasses.field(default_factory=dict)


_state: _RuntimeState | None = None
_generation = 0  # moves at every init(): plans of an older world are stale


def init(comm: Sequence[int] | None = None,
         process_sets: Sequence[Sequence[int]] | str | None = None, *,
         device: str | torch.device | None = None) -> None:
    """Join the world (reference ``hvd.init``). ``device`` defaults to the
    card: ``cuda:<LOCAL_RANK>``. Pass ``"cpu"`` for a gloo world on the host.
    ``process_sets`` is a list of rank lists to register as process sets
    now (every rank passes the same list), or ``"dynamic"`` to allow
    ``add_process_set`` later, as ``HVD_DYNAMIC_PROCESS_SETS=1`` does.
    ``comm``, the global set as a list of ranks, must name the whole world:
    a process is a rank here, and every module issues the global set's
    collectives on the default process group, so a world of fewer ranks is
    launched with that ``WORLD_SIZE`` (a subset is a process set).
    Calling it again while initialized is a no-op."""
    global _state, _generation
    if _state is not None:
        return
    if comm is not None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if sorted(int(r) for r in comm) != list(range(world)):
            raise ValueError(
                f"init(comm={list(comm)}): the global set is the whole "
                f"world of {world} ranks here; launch the ranks of comm as "
                "their own world, or use add_process_set for a subset")
    device = torch.device("cuda" if device is None else device)
    autodetected = _maybe_cluster_autodetect()
    env = os.environ
    rank = int(env.get("RANK", "0"))
    size = int(env.get("WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    local_size = int(env.get("LOCAL_WORLD_SIZE", str(size)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init(): no CUDA device is visible; pass device='cpu' for a "
                "gloo world on the host")
        card = envs.get_int(envs.CUDA_DEVICE, local_rank)
        if not 0 <= card < torch.cuda.device_count():
            raise RuntimeError(
                f"init(): card {card} (HVD_CUDA_DEVICE, else LOCAL_RANK) "
                f"is not among the {torch.cuda.device_count()} visible")
        device = torch.device("cuda", card)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"init(): unsupported device {device}")
    owns = False
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        seconds = envs.get_int(envs.PROCESS_GROUP_TIMEOUT, 0)
        timeout = ({"timeout": datetime.timedelta(seconds=seconds)}
                   if seconds > 0 else {})
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=size, **timeout)
        elif size == 1:
            # the store binds port 0 itself: no window for another process
            # to take a port picked in advance
            store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                  timeout=datetime.timedelta(seconds=60))
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1, **timeout)
        else:
            raise RuntimeError(
                f"init(): WORLD_SIZE={size} needs MASTER_ADDR and MASTER_PORT")
        owns = True
    size = dist.get_world_size()
    local_sizes = [local_size]
    if size > 1:  # one small exchange: each rank knows only its own node
        local_sizes = [None] * size
        dist.all_gather_object(local_sizes, local_size)
    from .process_sets import ProcessSetTable  # deferred: avoids a cycle
    table = ProcessSetTable(size)
    _generation += 1
    _state = _RuntimeState(device=device, rank=dist.get_rank(), size=size,
                           local_rank=local_rank, local_size=local_size,
                           owns_group=owns, process_set_table=table,
                           homogeneous=len(set(local_sizes)) == 1)
    table.dynamic_enabled = (process_sets == "dynamic" or envs.get_bool(
        envs.DYNAMIC_PROCESS_SETS))
    if process_sets and process_sets != "dynamic":
        for ranks in process_sets:
            table.add(list(ranks), force=True)
    if autodetected:
        _maybe_bootstrap_kv()
    from .ops import hierarchical  # deferred: it imports this module
    hierarchical.make_default_groups()
    # a re-form back to a shape this process has run at adopts that
    # shape's shelved dispatch plans (elastic/rendezvous.py)
    from .ops import dispatch_cache
    warm = dispatch_cache.restore_for_reform()
    if warm:
        hvd_logging.info("init: %d shelved dispatch plans warm for rank %d "
                         "of %d", warm, _state.rank, size)
    # HVD_TIMELINE and HVD_METRICS_PORT: a file or port that fails is
    # logged and does not stop training
    from . import metrics, timeline
    timeline.maybe_autostart(_state.rank, size)
    metrics.maybe_serve()
    hvd_logging.info("initialized: rank %d of %d on %s (%s)", _state.rank,
                     size, device, dist.get_backend())


def shutdown(*, failed: bool = False, reform: bool = False) -> None:
    """Leave the world; ends the process group if :func:`init` made it.

    The elastic re-form (``elastic/rendezvous.py``) passes ``reform``:
    the dispatch plans of this world's shape go on the shelf first, for a
    later world of the same shape. It passes ``failed`` after a peer died:
    queued collectives are failed instead of issued, and the process
    group is aborted instead of destroyed, so that no call waits on the
    dead peer. Every CUDA Graph (captured steps, ``hvd.cached_step``)
    holds work of this world's communicator and is dropped before the
    group ends."""
    global _state, _bootstrap_kv_server
    if _state is None:
        return
    from . import conformance, engine_service  # deferred: they import it
    from .ops import dispatch_cache, fusion_cycle
    if failed:
        aborted = fusion_cycle.abort("the world is re-forming after a "
                                     "peer failure")
        if aborted:
            hvd_logging.warning("shutdown: %d queued collective(s) of the "
                                "failed world aborted", aborted)
        fusion_cycle.stop()
    else:
        # queued collectives are issued, not dropped, while the world
        # stands
        try:
            fusion_cycle.drain()
        except Exception:
            hvd_logging.exception("fusion cycle drain at shutdown failed")
    if reform:
        dispatch_cache.shelve_for_reform()
    engine_service.reset_service()  # before the groups its joins may use
    dispatch_cache.invalidate("runtime shutdown")
    gc.collect()  # the dropped graphs release the communicator's work now
    # the trace goes out last: the teardown above records events too
    conformance.maybe_dump("shutdown")
    conformance.reset()
    if dist.is_initialized():
        if _state.process_set_table is not None:
            _state.process_set_table.clear(end_groups=not failed)
        if failed and _state.owns_group:
            # every group of the world, in one abort: nothing waits
            dist.distributed_c10d._abort_process_group()
        else:
            for group in _state.groups.values():
                if group not in (None, dist.GroupMember.NON_GROUP_MEMBER):
                    dist.destroy_process_group(group)
            if _state.owns_group:
                dist.destroy_process_group()
    if _bootstrap_kv_server is not None:
        _bootstrap_kv_server.stop()
        _bootstrap_kv_server = None
        # the seeded address is the server just stopped
        for name in (envs.KV_ADDR, envs.KV_PORT, envs.SECRET_KEY):
            os.environ.pop("HVD_" + name, None)
    _state = None


# (world-size variable, per-task rank variable, local rank, local size) of
# the schedulers a world may come from: the rank variable is set only
# inside an srun/mpirun/jsrun task, so a batch script that exports
# SLURM_NTASKS alone does not wait for a world that never comes
_CLUSTER_ENV_PAIRS = (("SLURM_NTASKS", "SLURM_PROCID"),
                      ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
                      ("PMI_SIZE", "PMI_RANK"),
                      ("JSM_NAMESPACE_SIZE", "JSM_NAMESPACE_RANK"))
_CLUSTER_LOCAL_VARS = {
    "SLURM_NTASKS": ("SLURM_LOCALID", "SLURM_NTASKS_PER_NODE"),
    "OMPI_COMM_WORLD_SIZE": ("OMPI_COMM_WORLD_LOCAL_RANK",
                             "OMPI_COMM_WORLD_LOCAL_SIZE"),
    "PMI_SIZE": ("MPI_LOCALRANKID", "MPI_LOCALNRANKS"),
    "JSM_NAMESPACE_SIZE": ("JSM_NAMESPACE_LOCAL_RANK",
                           "JSM_NAMESPACE_LOCAL_SIZE"),
}
DEFAULT_MASTER_PORT = 29500


def _cluster_world_hint() -> int:
    """The world size a scheduler's task variables advertise, 1 where none
    does (or where only the batch-level variable is set)."""
    for world_var, rank_var in _CLUSTER_ENV_PAIRS:
        val = os.environ.get(world_var)
        if val and os.environ.get(rank_var) is not None:
            try:
                return int(val)
            except ValueError:
                pass
    return 1


def _first_slurm_node(nodelist: str) -> str:
    """The first host of a SLURM node list: ``a,b`` or ``node[03-05,9]``."""
    head = nodelist.split(",", 1)[0]
    if "[" not in head:
        return head
    prefix, rest = head.split("[", 1)
    return prefix + rest.split("-", 1)[0].split("]", 1)[0]


def _cluster_master(world_var: str, local_size: int, size: int) -> str:
    if os.environ.get("MASTER_ADDR"):
        return os.environ["MASTER_ADDR"]
    if world_var == "JSM_NAMESPACE_SIZE":
        from .runner import lsf
        return lsf.lsf_host_specs()[0].hostname
    nodes = (os.environ.get("SLURM_STEP_NODELIST")
             or os.environ.get("SLURM_JOB_NODELIST"))
    if world_var == "SLURM_NTASKS" and nodes:
        return _first_slurm_node(nodes)
    if local_size == size:  # every task on this host
        return "127.0.0.1"
    raise RuntimeError(
        f"init(): {world_var} names a world of {size} processes over "
        "several hosts but no MASTER_ADDR says where rank 0 is")


def _maybe_cluster_autodetect() -> bool:
    """``srun python train.py`` / ``mpirun -np N python train.py``: where
    no ``RANK`` is set and a scheduler's task variables advertise a world
    of several processes, set ``torch.distributed``'s contract from them
    (``MASTER_PORT``: ``HVD_COORDINATOR_PORT``, else 29500). Returns
    whether it did."""
    if "RANK" in os.environ or _cluster_world_hint() <= 1:
        return False
    world_var, rank_var = next(
        (w, r) for w, r in _CLUSTER_ENV_PAIRS
        if os.environ.get(w) and os.environ.get(r) is not None)
    size = int(os.environ[world_var])
    rank = int(os.environ[rank_var])
    local_var, local_size_var = _CLUSTER_LOCAL_VARS[world_var]
    local_rank = int(os.environ.get(local_var, "0"))
    local_size = int(os.environ.get(local_size_var, "1").split("(")[0])
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(size),
        "LOCAL_RANK": str(local_rank), "LOCAL_WORLD_SIZE": str(local_size),
        "MASTER_ADDR": _cluster_master(world_var, local_size, size),
        "MASTER_PORT": os.environ.get("MASTER_PORT") or envs.get(
            envs.COORDINATOR_PORT, str(DEFAULT_MASTER_PORT))})
    hvd_logging.info("init: rank %d of %d from %s", rank, size, world_var)
    return True


_bootstrap_kv_server = None  # rank 0's KV server of a scheduler's world
_KV_BOOTSTRAP_KEY = "hvd/kv_bootstrap/{}"  # per generation: re-init safe


def _kv_advertise_address() -> str:
    """The address of this host that reaches rank 0's store (a UDP
    connect picks the route; no packet is sent)."""
    master = os.environ.get("MASTER_ADDR", "127.0.0.1")
    if master in ("127.0.0.1", "localhost"):
        return "127.0.0.1"
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((master, int(os.environ.get("MASTER_PORT", "1"))))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        from .runner.http_kv import local_addresses
        return local_addresses()[0]


def _maybe_bootstrap_kv() -> None:
    """The negotiation service's KV store for a world no launcher
    started: rank 0 starts a :class:`~.runner.http_kv.KVServer` and
    publishes ``addr:port:secret`` through the process group's store, and
    every rank sets ``HVD_KV_ADDR``/``HVD_KV_PORT``/``HVD_SECRET_KEY``
    from it. The key carries the init generation, so a re-init publishes
    afresh."""
    global _bootstrap_kv_server
    if envs.get(envs.KV_ADDR) or dist.get_world_size() <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    key = _KV_BOOTSTRAP_KEY.format(_generation)
    if dist.get_rank() == 0:
        from .runner.http_kv import KVServer, make_secret
        secret = make_secret()
        server = KVServer(secret=secret)
        port = server.start()
        _bootstrap_kv_server = server
        store.set(key, f"{_kv_advertise_address()}:{port}:{secret}")
    payload = store.get(key).decode()
    addr, port, secret = payload.split(":", 2)
    envs.set_env(envs.KV_ADDR, addr)
    envs.set_env(envs.KV_PORT, port)
    envs.set_env(envs.SECRET_KEY, secret)
    hvd_logging.info("negotiation KV store bootstrapped at %s:%s", addr,
                     port)


def generation() -> int:
    """How many times :func:`init` has joined a world in this process: the
    dispatch plan cache drops its plans when it moves."""
    return _generation


def is_initialized() -> bool:
    return _state is not None


def _get() -> _RuntimeState:
    if _state is None:
        raise NotInitializedError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _state


def partition_groups(parts) -> list:
    """One ``torch.distributed`` group for each rank list of ``parts``,
    in order, kept until :func:`shutdown`. ``dist.new_group`` is a call of
    the whole world, so every rank calls this with the same parts in the
    same order, members or not; a rank list met before reuses its group.
    A group this rank is not in is ``GroupMember.NON_GROUP_MEMBER``."""
    s = _get()
    out = []
    for ranks in parts:
        key = tuple(sorted(int(r) for r in ranks))
        if key not in s.groups:
            s.groups[key] = dist.new_group(list(key))
        out.append(s.groups[key])
    return out


def process_set_table():
    """This runtime's ``process_sets.ProcessSetTable``."""
    return _get().process_set_table


def device() -> torch.device:
    """The device this rank computes and communicates on."""
    return _get().device


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` if given, else the device of :func:`init`'s world, else
    the current card: entry points run on the card unless the caller asks
    for another device."""
    if device is not None:
        return torch.device(device)
    if _state is not None:
        return _state.device
    return torch.device("cuda", torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)


def rank() -> int:
    return _get().rank


def size() -> int:
    return _get().size


def local_rank() -> int:
    return _get().local_rank


def local_size() -> int:
    return _get().local_size


def cross_rank() -> int:
    """Index of this rank's node (homogeneous nodes of ``local_size``)."""
    s = _get()
    return s.rank // s.local_size


def cross_size() -> int:
    s = _get()
    return max(s.size // s.local_size, 1)


def is_homogeneous() -> bool:
    """True when every node runs the same number of ranks (reference
    ``is_homogeneous``: every process drives the same number of chips).
    Read from the ranks' ``LOCAL_WORLD_SIZE``, exchanged at :func:`init`."""
    return _get().homogeneous


def nccl_built() -> bool:
    return dist.is_nccl_available()


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def tpu_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def process_rank() -> int:
    """The index of this process: a process is a rank (the JAX package's
    ``process_rank`` counts hosts of chips)."""
    return _get().rank


def process_count() -> int:
    return _get().size


def local_ranks() -> list:
    """The global ranks this process drives: its own."""
    return [_get().rank]


def process_of_rank(global_rank: int) -> int:
    """The process that drives ``global_rank``: itself."""
    s = _get()
    if not 0 <= global_rank < s.size:
        raise ValueError(f"rank {global_rank} outside a world of {s.size}")
    return int(global_rank)


# capability queries (reference basics.py:273-371): what this build has.
# torch.distributed's gloo and NCCL are the collective backends; there is no
# MPI, CCL, DDL or XLA.

def xla_enabled() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    """Whether this world's collectives run on gloo (a CPU world)."""
    return dist.is_initialized() and dist.get_backend() == "gloo"


def mpi_built() -> bool:
    return dist.is_mpi_available()


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    """False: there is no MPI."""
    return False


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def rocm_built() -> bool:
    return torch.version.hip is not None
