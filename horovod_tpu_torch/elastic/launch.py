"""The elastic branch of the launcher (port of
``horovod_tpu/elastic/launch.py``): ``--min-np``/``--max-np``/
``--host-discovery-script``/``--reset-limit``/``--blacklist-cooldown-range``.

Build the discovery source, stand up the KV server and the driver, and
hand worker spawning to the :class:`~.driver.ElasticDriver`. Each worker
gets the launcher's contract for its round and a card of its machine from
the job's :class:`~horovod_tpu_torch.runner.launch.CardPool`; a worker
that outlives a re-form keeps its card. Where ``HVD_FAULT_SPEC`` schedules
membership churn over ``-H`` hosts, the workers' actions reach the job's
:class:`~.discovery.ScriptedChurn` over the KV store; with
``HVD_AUTOSCALE=1`` the job's :class:`~.policy.AutoscalePolicy` changes the
same host set from the workers' sensors (``ElasticJob.policy``).
"""

from __future__ import annotations

import os
import sys

from ..runner import launch as launch_mod
from ..utils import logging as hvd_logging
from .bootstrap import make_elastic_infra
from . import policy as _policy
from .discovery import FixedHosts, HostDiscoveryScript, install_scripted_churn


def _build_discovery(args):
    if args.host_discovery_script:
        return HostDiscoveryScript(args.host_discovery_script,
                                   default_slots=args.slots_per_host or 1)
    # fixed hosts still gain from elastic mode: a failed host is
    # blacklisted and the job goes on while min_np slots remain
    specs = launch_mod._resolve_hosts(args)
    return FixedHosts({h.hostname: h.slots for h in specs})


def peer_failure_env(max_np: int | None, extra: dict) -> dict:
    """``extra`` with the NCCL settings of a job whose world can exceed
    one rank, where a peer can die mid-collective: the wait for a
    collective blocks until it completed or the process group's timeout
    (``HVD_PROCESS_GROUP_TIMEOUT``) failed it, so an optimizer never
    applies a gradient a dead peer left half reduced, and the failure
    leaves the process alive (torch's default would end it) for the
    survivors to abort the group and re-form."""
    if max_np is None or max_np > 1:
        for name, value in (("TORCH_NCCL_BLOCKING_WAIT", "1"),
                            ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")):
            if name not in os.environ:
                extra.setdefault(name, value)
    return extra


class ElasticJob:
    """A started elastic job: its driver-side pieces (``infra``, ``driver``,
    and ``policy``, the autoscale policy or None) and :meth:`wait`, which
    joins it and returns the launcher's exit code."""

    def __init__(self, infra, policy=None):
        self.infra = infra
        self.driver = infra.driver
        self.policy = policy

    def stop(self) -> None:
        if self.policy is not None:
            self.policy.stop()
        self.infra.stop()

    def wait(self) -> int:
        driver = self.driver
        try:
            driver.join()
            results = driver.get_results()
        finally:
            self.stop()
        if results.error_message:
            print(f"launch elastic: {results.error_message}", file=sys.stderr)
            return 1
        if driver.succeeded:
            # recovery absorbed the failures of earlier rounds: the job
            # completed
            hvd_logging.info("elastic job finished: %s",
                             results.worker_results)
            return 0
        failures = {name: code for name, (code, _ts)
                    in results.worker_results.items() if code != 0}
        if failures:
            print(f"launch elastic: worker failures: {failures}",
                  file=sys.stderr)
            return next(iter(failures.values()))
        return 0


def start_elastic(args, command: list[str]) -> ElasticJob:
    """Start the driver of an elastic job and its first round's workers."""
    from ..utils import envs
    min_np = args.min_np or args.np or 1
    max_np = args.max_np
    discovery = _build_discovery(args)
    infra = make_elastic_infra(
        discovery, min_np, max_np,
        # HVD_ELASTIC_TIMEOUT wins over the flag, so that the driver and
        # the workers agree on how long a host replacement may take
        timeout=envs.get_int(envs.ELASTIC_TIMEOUT, int(args.start_timeout)),
        reset_limit=args.reset_limit,
        cooldown_range=(tuple(args.blacklist_cooldown_range)
                        if args.blacklist_cooldown_range else None),
        verbose=1 if args.verbose else 0,
        remote_port_probe=lambda host: launch_mod.probe_remote_free_port(
            host, args.ssh_port, args.ssh_identity_file))
    churn = install_scripted_churn(discovery, warn=True)
    if churn is not None:
        churn.attach_driver(infra.driver)
        infra.churn = churn
    extra_base = peer_failure_env(max_np, launch_mod.extra_env(args))
    cards = launch_mod.CardPool()

    def create_worker_fn(slot_info, spec_round: int):
        spec = infra.round_spec(spec_round)
        all_local = all(launch_mod.is_local_host(s["hostname"])
                        for s in spec["slots"])
        extra = infra.worker_extra_env(spec_round, extra_base)
        wait_s = launch_mod.departure_wait_s(
            job.policy.grace_s if job.policy is not None else 0.0)
        return cards.spawn(slot_info.hostname, lambda card: (
            launch_mod.spawn_worker(slot_info, command, launch_mod.worker_env(
                slot_info, coordinator_addr=spec["coord_addr"],
                coordinator_port=spec["coord_port"],
                kv_addr="127.0.0.1" if all_local else infra.kv_addr,
                kv_port=infra.kv_port, secret=infra.secret, extra=extra,
                card=card), args)), wait_s=wait_s)

    job = ElasticJob(infra, _policy.maybe_start(
        infra.driver, discovery, infra.kv, min_np=min_np, max_np=max_np,
        env=extra_base))
    try:
        infra.driver.start(args.np or min_np, create_worker_fn)
    except BaseException:
        job.stop()
        raise
    return job


def run_elastic(args, command: list[str]) -> int:
    return start_elastic(args, command).wait()
