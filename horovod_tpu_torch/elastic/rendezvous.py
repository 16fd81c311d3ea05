"""The worker's side of the elastic rendezvous: fetch the new round and
re-form the world in place (port of ``horovod_tpu/elastic/rendezvous.py``).

A reset is:

1. wait for the KV round counter to pass this worker's round;
2. find this worker's slot (the stable ``(hostname, local_rank at
   spawn)`` key) in the new round's slot table; where it is gone, say so
   on the health channel and exit with
   :data:`~horovod_tpu_torch.elastic.driver.SLOT_LOST_EXIT_CODE`;
3. tear the old world down in this process (``runtime.shutdown``): stop
   the fusion cycle (drained after a clean turn, its queued work failed
   after a peer's death), shelve this shape's dispatch plans, drop every
   plan with its CUDA Graph (captured steps, ``hvd.cached_step``: their
   NCCL work is the old communicator's), stop the negotiation services,
   and end the process group: destroyed after a clean turn, aborted after
   a failure so that no call waits on a dead peer;
4. seed the round's environment, with its fresh ``MASTER_ADDR``/
   ``MASTER_PORT``, and call ``runtime.init()`` again on the same device;
5. record readiness in the KV store for the driver's registry.

The card stays the worker's: ``HVD_CUDA_DEVICE`` was set when the
launcher spawned it.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

from ..utils import envs
from ..utils import logging as hvd_logging
from ..utils import retry as _retry
from .driver import (ROUND_KEY, ROUND_SPEC_KEY, SLOT_LOST_EXIT_CODE,
                     STOP_KEY, done_key, ready_key)


class WorkerRendezvous:
    """A worker's handle on the elastic round protocol."""

    def __init__(self, kv_client=None):
        if kv_client is None:
            from ..runner.http_kv import KVClient
            addr = envs.get(envs.KV_ADDR)
            # a static launch also sets HVD_KV_ADDR, but publishes no
            # rounds: entering the protocol there would wait, not fail
            if not addr or not envs.get_bool(envs.ELASTIC):
                raise RuntimeError(
                    "not an elastic worker: HVD_ELASTIC/HVD_KV_ADDR not set "
                    "(launch with python -m horovod_tpu_torch.runner.launch "
                    "--min-np/--max-np/--host-discovery-script)")
            kv_client = KVClient(addr, envs.get_int(envs.KV_PORT, 0),
                                 secret=envs.get(envs.SECRET_KEY))
        self.kv = kv_client
        self.hostname = envs.get(envs.HOSTNAME) or "localhost"
        # the worker's stable identity: its local slot at spawn
        self.slot = envs.get_int(envs.LOCAL_RANK, 0)
        self.round = envs.get_int(envs.ELASTIC_ROUND, 1)
        self.timeout = envs.get_int(envs.ELASTIC_TIMEOUT, 600)
        self._last_round_raw: bytes | None = None

    # -- protocol ----------------------------------------------------------

    def record_ready(self) -> None:
        self.kv.put(ready_key(self.round, self.hostname, self.slot), b"1")

    def record_done(self) -> None:
        """Mark this worker's training complete, before any teardown, so
        that the driver's success cannot race a noisy exit."""
        self.kv.put(done_key(self.hostname, self.slot), b"1")

    def reset(self, failed: bool = False) -> None:
        """Re-form into the next round. ``failed``: the world ended by a
        peer's failure, so its queued work and its process group are
        aborted, not drained and destroyed."""
        spec = self._wait_for_next_round()
        my_slot = self._find_my_slot(spec)
        if my_slot is None:
            hvd_logging.info(
                "slot %s[%d] not assigned in round %d; exiting",
                self.hostname, self.slot, spec["round"])
            # a departure on purpose: surviving watchdogs skip this rank's
            # ceased beats instead of reading a death
            from .. import engine_service
            engine_service.mark_leaving()
            sys.exit(SLOT_LOST_EXIT_CODE)
        self._reinitialize(spec, my_slot, failed)

    def _check_round(self) -> dict | None:
        """One poll of the protocol: exits on a driver stop; the next
        round's spec once published, else None."""
        if self.kv.get(STOP_KEY) is not None:
            hvd_logging.info("driver stopped the job during reset")
            sys.exit(0)
        raw = self.kv.get(ROUND_KEY)
        self._last_round_raw = raw
        if raw is not None:
            round_id = int(raw.decode())
            if round_id > self.round:
                spec_raw = self.kv.get(ROUND_SPEC_KEY.format(round_id))
                if spec_raw is not None:
                    return pickle.loads(spec_raw)
        return None

    def _wait_for_next_round(self) -> dict:
        last_report = time.monotonic()
        spec = self._check_round()
        if spec is not None:
            return spec
        for _ in _retry.poll_intervals("elastic.round-wait",
                                       interval_s=0.25,
                                       deadline_s=float(self.timeout)):
            spec = self._check_round()
            if spec is not None:
                return spec
            now = time.monotonic()
            if now - last_report > 5:
                raw = self._last_round_raw
                hvd_logging.info(
                    "waiting for elastic round > %d (kv reports %s)",
                    self.round, raw.decode() if raw else None)
                last_report = now
        raise TimeoutError(
            f"no new elastic round after {self.timeout}s "
            f"(stuck at round {self.round})")

    def _find_my_slot(self, spec: dict) -> dict | None:
        for slot in spec["slots"]:
            if (slot["hostname"] == self.hostname
                    and slot["local_rank"] == self.slot):
                return slot
        return None

    def _reinitialize(self, spec: dict, my_slot: dict, failed: bool) -> None:
        from .. import runtime
        from .notification import get_notification_manager

        hvd_logging.info(
            "re-forming into round %d: rank %d/%d via %s:%d%s",
            spec["round"], my_slot["rank"], spec["world_size"],
            spec["coord_addr"], spec["coord_port"],
            " after a failure" if failed else "")
        device = runtime.device() if runtime.is_initialized() else None
        runtime.shutdown(failed=failed, reform=True)
        self._seed_round_env(spec, my_slot)
        self.round = spec["round"]
        runtime.init(device=None if device is None else device.type)
        get_notification_manager().mark_round_joined(self.round)
        self.record_ready()

    @staticmethod
    def _seed_round_env(spec: dict, my_slot: dict) -> None:
        """The new round's worker contract, in the process environment."""
        env = {
            envs.RANK: my_slot["rank"],
            envs.SIZE: spec["world_size"],
            envs.LOCAL_RANK: my_slot["local_rank"],
            envs.LOCAL_SIZE: my_slot["local_size"],
            envs.CROSS_RANK: my_slot["cross_rank"],
            envs.CROSS_SIZE: my_slot["cross_size"],
            envs.PROCESS_ID: my_slot["rank"],
            envs.NUM_PROCESSES: spec["world_size"],
            envs.COORDINATOR_ADDR: spec["coord_addr"],
            envs.COORDINATOR_PORT: spec["coord_port"],
            # at_round fault filters read the round the worker runs in
            envs.ELASTIC_ROUND: spec["round"],
        }
        for name, value in env.items():
            envs.set_env(name, value)
        os.environ.update({
            "RANK": str(my_slot["rank"]),
            "WORLD_SIZE": str(spec["world_size"]),
            "LOCAL_RANK": str(my_slot["local_rank"]),
            "LOCAL_WORLD_SIZE": str(my_slot["local_size"]),
            "MASTER_ADDR": str(spec["coord_addr"]),
            "MASTER_PORT": str(spec["coord_port"])})


_worker_rendezvous: WorkerRendezvous | None = None


def get_worker_rendezvous() -> WorkerRendezvous:
    """The process's rendezvous handle (a process is a rank)."""
    global _worker_rendezvous
    if _worker_rendezvous is None:
        _worker_rendezvous = WorkerRendezvous()
    return _worker_rendezvous
