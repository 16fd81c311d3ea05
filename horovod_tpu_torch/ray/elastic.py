"""Elastic jobs on Ray actors (port of ``horovod_tpu/ray/elastic.py``).

Reference Horovod's elastic Ray executor over the port's elastic core,
unchanged: the :class:`~horovod_tpu_torch.elastic.driver.ElasticDriver`'s
rounds, the signed KV rendezvous, the blacklist and the worker's
``hvd.elastic.run`` (a re-form in the worker's own process) behave as under
``python -m horovod_tpu_torch.runner.launch --min-np``; host discovery reads
Ray's live cluster state, and Ray places the worker processes::

    from horovod_tpu_torch.ray import ElasticRayExecutor

    ex = ElasticRayExecutor(min_workers=2, max_workers=8)
    ex.start()
    results = ex.run(train_fn)   # train_fn wraps its loop in hvd.elastic.run
    ex.shutdown()

Where the cluster offers GPUs, each worker's actor asks Ray for one and
drives it (as :class:`~horovod_tpu_torch.ray.runner.RayExecutor`'s do),
and discovery offers a node no more slots than it has GPUs. On a cluster
that offers none, a worker's card comes from the launcher's
:class:`~horovod_tpu_torch.runner.launch.CardPool`, keyed by its node; the
card is free again once the worker's actor has ended
(:meth:`_ActorProcess.poll` reports an exit code).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from ..runner import hosts as hosts_mod
from ..runner import launch as launch_mod
from ..utils import logging as hvd_logging
from .runner import _cluster_has_gpus, _with_assigned_card


class RayHostDiscovery:
    """Hosts from Ray's cluster state (reference ``RayHostDiscovery``):
    every live node offers ``floor(node_cpus / cpus_per_worker)`` slots,
    bounded by its custom resources where ``resources_per_worker`` asks
    for some, and by its GPUs where the cluster offers GPUs (an actor then
    asks for one). The elastic driver's ``HostManager`` reads it as it
    reads a discovery script."""

    def __init__(self, ray_module, cpus_per_worker: int = 1,
                 resources_per_worker: dict | None = None,
                 max_slots_per_host: int | None = None):
        self._ray = ray_module
        self.cpus_per_worker = max(int(cpus_per_worker), 1)
        self.resources_per_worker = dict(resources_per_worker or {})
        self.max_slots_per_host = max_slots_per_host

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        out: dict[str, int] = {}
        gpus = _cluster_has_gpus(self._ray)
        for node in self._ray.nodes():
            if not node.get("Alive"):
                continue
            host = node.get("NodeManagerAddress")
            res = node.get("Resources", {}) or {}
            slots = int(res.get("CPU", 0) // self.cpus_per_worker)
            if gpus:
                slots = min(slots, int(res.get("GPU", 0)))
            for name, need in self.resources_per_worker.items():
                if need > 0:
                    slots = min(slots, int(res.get(name, 0) // need))
            if self.max_slots_per_host is not None:
                slots = min(slots, self.max_slots_per_host)
            if host and slots > 0:
                out[host] = slots
        return out


class _ActorProcess:
    """A (Ray actor, in-flight call) pair as the process handle the
    elastic driver supervises (``poll``/``wait``/``terminate`` with exit
    codes, like ``safe_exec.ExecutedProcess``). ``sys.exit(code)`` in the
    worker function (the slot-lost exit) maps onto the code a worker
    process would return. An actor runs one worker: once its call has
    settled the actor is ended, so its card is free."""

    def __init__(self, ray_module, actor, ref):
        self._ray = ray_module
        self._actor = actor
        self._ref = ref
        self._code: int | None = None
        self._result: Any = None
        self._mu = threading.Lock()

    def _settle(self, timeout: float | None) -> int | None:
        if self._code is not None:
            return self._code
        done, _ = self._ray.wait([self._ref], timeout=timeout)
        if not done:
            return None
        with self._mu:
            if self._code is not None:
                return self._code
            try:
                status, payload = self._ray.get(self._ref)
                if status == "ok":
                    code, self._result = 0, payload
                else:  # ("exit", code): the worker exited itself
                    code = int(payload)
            except Exception as e:
                hvd_logging.debug("elastic ray worker raised: %s", e)
                code = 1
            self._kill()
            self._code = code
        return code

    def _kill(self) -> None:
        try:
            self._ray.kill(self._actor)
        except Exception:
            pass  # the actor or the cluster is gone already

    def poll(self) -> int | None:
        return self._settle(0)

    def wait(self, timeout: float | None = None) -> int:
        code = self._settle(timeout)
        if code is None:
            raise TimeoutError("ray worker still running")
        return code

    def result(self):
        return self._result

    def terminate(self) -> None:
        with self._mu:
            if self._code is None:
                self._code = 143
            self._kill()


class _ElasticWorker:
    """One elastic rank: seeds the launcher's contract, then runs the
    user's function (which drives ``hvd.elastic.run`` as a launched worker
    does)."""

    def execute(self, env: dict, fn, args, kwargs):
        import os
        os.environ.update(_with_assigned_card(env))
        try:
            return ("ok", fn(*args, **(kwargs or {})))
        except SystemExit as e:  # slot lost, or the driver stopped
            return ("exit", int(e.code or 0))


def _make_elastic_worker_cls(ray_module=None):
    """The worker class (a hook: tests substitute one)."""
    return _ElasticWorker


class ElasticRayExecutor:
    """An elastic job on Ray actors (reference ``ElasticRayExecutor``).
    The user's function wraps its training loop in ``hvd.elastic.run``,
    as under the elastic launcher."""

    def __init__(self, min_workers: int, max_workers: int | None = None,
                 *, cpus_per_worker: int = 1,
                 resources_per_worker: dict | None = None,
                 env_vars: dict | None = None,
                 elastic_timeout: float | None = None,
                 reset_limit: int | None = None,
                 override_discovery=None):
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers) if max_workers else None
        self.cpus_per_worker = cpus_per_worker
        self.resources_per_worker = dict(resources_per_worker or {})
        self.env_vars = dict(env_vars or {})
        self.elastic_timeout = elastic_timeout
        self.reset_limit = reset_limit
        self._override_discovery = override_discovery
        self._ray = None
        self._infra = None
        self._driver = None
        self._worker_cls = None
        self._gpus = False
        self._handles: dict = {}
        self._handles_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        import ray  # here: the module imports without Ray

        self._ray = ray
        if not ray.is_initialized():
            ray.init()

    def _spawn(self, slot: hosts_mod.SlotInfo, env: dict, fn, args,
               kwargs) -> _ActorProcess:
        ray = self._ray
        if self._worker_cls is None:
            # one remote class an executor, not one a spawn
            self._worker_cls = ray.remote(_make_elastic_worker_cls(ray))
        opts: dict = {"num_cpus": self.cpus_per_worker}
        if self._gpus:
            opts["num_gpus"] = 1
        resources = dict(self.resources_per_worker)
        # Ray's per-node resource pins the actor to the discovered host
        resources[f"node:{slot.hostname}"] = 0.001
        opts["resources"] = resources
        actor = self._worker_cls.options(**opts).remote()
        ref = actor.execute.remote(env, fn, args, kwargs)
        handle = _ActorProcess(ray, actor, ref)
        with self._handles_lock:
            self._handles[(slot.hostname, slot.local_rank)] = handle
        return handle

    def run(self, fn: Callable, args=(), kwargs: dict | None = None) -> list:
        """Run the elastic job; returns the results of the workers that
        finished the final round (reference ``ElasticRayExecutor.run``)."""
        if self._ray is None:
            raise RuntimeError("ElasticRayExecutor.start() has not been "
                               "called")
        with self._handles_lock:
            self._handles.clear()  # a prior run's workers must not leak
        from ..elastic.bootstrap import make_elastic_infra
        from ..elastic.launch import peer_failure_env

        discovery = self._override_discovery or RayHostDiscovery(
            self._ray, self.cpus_per_worker, self.resources_per_worker)
        infra = make_elastic_infra(
            discovery, self.min_workers, self.max_workers,
            timeout=self.elastic_timeout, reset_limit=self.reset_limit)
        self._infra = infra
        self._driver = infra.driver
        extra_base = peer_failure_env(self.max_workers, dict(self.env_vars))
        cards = launch_mod.CardPool()
        self._gpus = _cluster_has_gpus(self._ray)

        def create_worker_fn(slot: hosts_mod.SlotInfo, spec_round: int):
            spec = infra.round_spec(spec_round)
            all_local = all(launch_mod.is_local_host(s["hostname"])
                            for s in spec["slots"])
            extra = infra.worker_extra_env(spec_round, extra_base)

            def start(card):
                return self._spawn(slot, launch_mod.worker_env(
                    slot, coordinator_addr=spec["coord_addr"],
                    coordinator_port=spec["coord_port"],
                    kv_addr="127.0.0.1" if all_local else infra.kv_addr,
                    kv_port=infra.kv_port, secret=infra.secret,
                    extra=extra, card=card), fn, args, kwargs)

            if self._gpus:  # the actor takes the GPU Ray gives it
                return start(None)
            return cards.spawn(slot.hostname, start,
                               wait_s=launch_mod.departure_wait_s())

        try:
            infra.driver.start(self.min_workers, create_worker_fn)
            infra.driver.join()
            results = infra.driver.get_results()
            if results.error_message:
                raise RuntimeError(
                    f"elastic ray job failed: {results.error_message}")
            if not infra.driver.succeeded:
                raise RuntimeError("elastic ray job stopped without a "
                                   "successful worker")
            # only the workers holding a slot of the FINAL round give
            # results: a worker of an earlier, smaller round that exited 0
            # on a slot the last round did not reuse would add a stale one
            final_slots = {(s.hostname, s.local_rank)
                           for slots in infra.driver.host_assignments.values()
                           for s in slots}
            out = []
            with self._handles_lock:
                for key, handle in self._handles.items():
                    if key in final_slots and handle.poll() == 0:
                        out.append(handle.result())
            return out
        finally:
            infra.stop()
            self._infra = None

    def shutdown(self) -> None:
        with self._handles_lock:
            for handle in self._handles.values():
                handle.terminate()
            self._handles.clear()
        if self._infra is not None:
            self._infra.stop()
            self._infra = None
