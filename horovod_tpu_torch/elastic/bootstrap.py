"""The driver side of an elastic job, stood up in one place (port of
``horovod_tpu/elastic/bootstrap.py``): a signed KV server whose PUT
observer turns the workers' records into driver calls (readiness,
completion, a watchdog's peer-failure report, a relayed membership
action), the :class:`~.driver.ElasticRendezvous`, the
:class:`~.driver.ElasticDriver`, and the round-spec lookup that worker
spawners need.
"""

from __future__ import annotations

import pickle

from .. import health
from ..runner.http_kv import KVServer, local_addresses, make_secret
from ..utils import envs
from .discovery import parse_churn
from .driver import (CHURN_KEY_PREFIX, ROUND_SPEC_KEY, ElasticDriver,
                     ElasticRendezvous, parse_done_key, parse_ready_key)


class ElasticInfra:
    """The running pieces of one elastic job, on the driver's side."""

    def __init__(self, kv: KVServer, kv_addr: str, kv_port: int,
                 secret: str, driver: ElasticDriver):
        self.kv = kv
        self.kv_addr = kv_addr
        self.kv_port = kv_port
        self.secret = secret
        self.driver = driver
        self.churn = None  # a ScriptedChurn the observer feeds, if any
        self._spec_cache: dict[int, dict] = {}

    def round_spec(self, spec_round: int) -> dict:
        """The spec the driver published for a round: ``MASTER_ADDR`` and
        ``MASTER_PORT`` of its process group, world size, slot table."""
        if spec_round not in self._spec_cache:
            self._spec_cache[spec_round] = pickle.loads(
                self.kv.get(ROUND_SPEC_KEY.format(spec_round)))
        return self._spec_cache[spec_round]

    def worker_extra_env(self, spec_round: int,
                         extra: dict | None = None) -> dict:
        """The elastic additions to the launcher's worker contract."""
        return {**(extra or {}), "HVD_ELASTIC": "1",
                "HVD_ELASTIC_ROUND": str(spec_round)}

    def stop(self) -> None:
        self.driver.stop()
        self.kv.stop()


def make_elastic_infra(discovery, min_np: int, max_np: int | None = None,
                       *, timeout: float | None = None,
                       reset_limit: int | None = None,
                       cooldown_range=None, verbose: int = 0,
                       remote_port_probe=None) -> ElasticInfra:
    """Start the KV server and the elastic driver, with the PUT observer
    that turns a worker's ready and done records into
    ``driver.record_ready`` and ``registry.record_success``, a watchdog's
    report into ``driver.record_peer_failure``, and a relayed membership
    action into the job's :class:`~.discovery.ScriptedChurn`."""
    secret = make_secret()
    infra_holder: list[ElasticInfra] = []

    def on_put(key: str, payload: bytes) -> None:
        if not infra_holder:
            return
        infra = infra_holder[0]
        parsed = parse_ready_key(key)
        if parsed is not None:
            infra.driver.record_ready(*parsed)
            return
        parsed = parse_done_key(key)
        if parsed is not None:
            infra.driver.registry.record_success(*parsed)
            return
        if key.startswith(CHURN_KEY_PREFIX):
            action = parse_churn(payload)
            if action is not None and infra.churn is not None:
                infra.churn.apply(*action)
            return
        failed = health.parse_peer_failure(key, payload)
        if failed is not None:
            infra.driver.record_peer_failure(*failed)

    kv = KVServer(secret=secret, on_put=on_put)
    kv_port = kv.start()
    kv_addr = local_addresses()[0]

    driver = ElasticDriver(
        ElasticRendezvous(kv), discovery, min_np, max_np,
        # an explicit timeout of 0 means fail fast, which the default must
        # not swallow
        timeout=(timeout if timeout is not None
                 else envs.get_int(envs.ELASTIC_TIMEOUT, 600)),
        reset_limit=reset_limit, cooldown_range=cooldown_range,
        verbose=verbose, remote_port_probe=remote_port_probe)
    infra = ElasticInfra(kv, kv_addr, kv_port, secret, driver)
    infra_holder.append(infra)
    return infra
