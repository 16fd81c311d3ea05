"""Ray integration: the ranks of a job as Ray actors (port of
``horovod_tpu/ray/runner.py``).

Reference Horovod's ``RayExecutor`` over the launcher's own pieces: the
job's rendezvous (:class:`~horovod_tpu_torch.runner.launch.JobRendezvous`:
the signed KV store and the worker contract of ``worker_env``), with Ray in
place of ssh for placing the processes::

    from horovod_tpu_torch.ray import RayExecutor

    executor = RayExecutor(num_workers=4)
    executor.start()
    results = executor.run(train_fn, args=(config,))
    executor.shutdown()

Each actor is one rank: its environment holds the launcher's contract
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` of rank 0's
``TCPStore`` in rank 0's actor, the ``HVD_*`` set) and ``HVD_CUDA_DEVICE``,
so ``train_fn`` starts with the usual ``hvd.init()``. Where the cluster
offers GPUs, each actor asks Ray for one (the port's workers run on the
card by default) and drives the card Ray gave it, which Ray makes the
only one the actor's process sees; on a cluster that offers none, the
actor's card comes from the job's
:class:`~horovod_tpu_torch.runner.launch.CardPool`. Ray is imported by
:meth:`RayExecutor.start`, not by this module.
"""

from __future__ import annotations

from typing import Any, Callable

from ..runner import hosts as hosts_mod
from ..runner.launch import JobRendezvous


def _cluster_has_gpus(ray) -> bool:
    """Whether a live node of the cluster offers Ray GPUs: then each actor
    asks for one."""
    nodes = getattr(ray, "nodes", None)
    return nodes is not None and any(
        node.get("Alive") and (node.get("Resources") or {}).get("GPU", 0) >= 1
        for node in nodes())


def _assigned_card() -> int | None:
    """The card Ray gave this actor, as this process numbers it (Ray
    narrows ``CUDA_VISIBLE_DEVICES`` to the actor's GPUs); None where it
    gave none."""
    import os
    try:
        import ray
    except ImportError:
        return None
    get_gpu_ids = getattr(ray, "get_gpu_ids", None)
    ids = [str(i) for i in get_gpu_ids()] if get_gpu_ids is not None else []
    if not ids:
        return None
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")]
    return visible.index(ids[0]) if ids[0] in visible else int(ids[0])


def _with_assigned_card(env: dict) -> dict:
    """``env`` with ``HVD_CUDA_DEVICE`` the card Ray gave this actor, where
    it gave one."""
    card = _assigned_card()
    return env if card is None else {**env, "HVD_CUDA_DEVICE": str(card)}


class _HvdWorker:
    """One rank: the class Ray makes an actor of. Module-level, so that an
    actor in a process of its own imports it by name."""

    def __init__(self):
        self._env: dict[str, str] = {}

    def node_ip(self) -> str:
        try:
            import ray
            return ray.util.get_node_ip_address()
        except Exception:
            import socket
            return socket.gethostbyname(socket.gethostname())

    def find_free_port(self) -> int:
        from ..runner.launch import _free_port
        return _free_port()

    def set_env(self, env: dict) -> None:
        import os
        self._env = _with_assigned_card(env)
        os.environ.update(self._env)

    def execute(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))


def _make_worker_cls(ray):
    """The actor class (a hook: tests may substitute one)."""
    del ray
    return _HvdWorker


class _ActorHold:
    """The card pool's process handle of a static actor, holding its card
    until the executor shuts the actor down."""

    def __init__(self):
        self.card: int | None = None
        self.code: int | None = None

    def take(self, card: int) -> "_ActorHold":
        self.card = card
        return self

    def poll(self) -> int | None:
        return self.code


class RayExecutor:
    """``num_workers`` ranks as Ray actors (reference ``RayExecutor``).
    ``cpus_per_worker`` and ``resources_per_worker`` are each actor's
    resource request, with one GPU where the cluster offers GPUs."""

    def __init__(self, num_workers: int, *, cpus_per_worker: int = 1,
                 resources_per_worker: dict | None = None,
                 env_vars: dict | None = None):
        self.num_workers = int(num_workers)
        self.cpus_per_worker = cpus_per_worker
        self.resources_per_worker = resources_per_worker or {}
        self.env_vars = dict(env_vars or {})
        self.workers: list = []
        self._holds: list[_ActorHold] = []
        self._rdv: JobRendezvous | None = None
        self._ray = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Create the actors and seed each with its rank's contract and
        card."""
        import ray  # here: the module imports without Ray

        self._ray = ray
        if not ray.is_initialized():
            ray.init()
        worker_cls = ray.remote(_make_worker_cls(ray))
        gpus = _cluster_has_gpus(ray)
        opts = dict(num_cpus=self.cpus_per_worker)
        if gpus:
            opts["num_gpus"] = 1
        if self.resources_per_worker:
            opts["resources"] = self.resources_per_worker
        self.workers = [worker_cls.options(**opts).remote()
                        for _ in range(self.num_workers)]

        ips = ray.get([w.node_ip.remote() for w in self.workers])
        slots = self._build_slots(ips)
        self._rdv = JobRendezvous(slots)
        # rank 0's TCPStore lives in rank 0's actor
        self._rdv.coord_addr = ips[0]
        self._rdv.coord_port = ray.get(self.workers[0].find_free_port.remote())
        # an actor with a GPU of Ray's takes that card (set_env)
        self._holds = [] if gpus else [
            self._rdv.cards.spawn(slot.hostname, _ActorHold().take)
            for slot in slots]
        cards = [h.card for h in self._holds] or [None] * len(slots)
        ray.get([w.set_env.remote(self._rdv.worker_env(
            slot, self.env_vars, card=card))
            for w, slot, card in zip(self.workers, slots, cards)])

    def _build_slots(self, ips: list) -> list:
        """Ranks from the actors' nodes (``hosts.slots_from_ips``)."""
        return hosts_mod.slots_from_ips(ips)

    # -- execution ---------------------------------------------------------

    def run_remote(self, fn: Callable, args=(), kwargs=None) -> list:
        """Start ``fn`` on every worker; returns the Ray futures."""
        if not self.workers:
            raise RuntimeError("RayExecutor.start() has not been called")
        return [w.execute.remote(fn, args, kwargs) for w in self.workers]

    def run(self, fn: Callable, args=(), kwargs=None) -> list:
        """Run ``fn(*args, **kwargs)`` as rank ``i`` on worker ``i``; the
        results by rank (reference ``RayExecutor.run``)."""
        futures = self.run_remote(fn, args, kwargs)
        return self._ray.get(futures)

    def execute_single(self, fn: Callable, args=(), kwargs=None) -> Any:
        """Run ``fn`` on rank 0 only (reference ``execute_single``)."""
        if not self.workers:
            raise RuntimeError("RayExecutor.start() has not been called")
        return self._ray.get(
            self.workers[0].execute.remote(fn, args, kwargs))

    def shutdown(self) -> None:
        """Kill the actors, free their cards and stop the KV server."""
        if self._ray is not None:
            for w in self.workers:
                try:
                    self._ray.kill(w)
                except Exception:
                    pass  # the actor or the cluster is gone already
        for hold in self._holds:
            hold.code = 0
        self._holds = []
        self.workers = []
        if self._rdv is not None:
            self._rdv.stop()
            self._rdv = None
