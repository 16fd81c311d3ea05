"""The launcher (port of ``horovod_tpu/runner``): the command line
``python -m horovod_tpu_torch.runner.launch``, the programmatic
:func:`run`, host parsing and rank assignment, and the KV store that the
negotiation service and the elastic driver talk through.

The launch module's names are imported at first use, so that running it
as ``python -m`` does not import it twice.
"""

from __future__ import annotations

import importlib
import sys

from . import hosts as hosts_mod
from . import safe_exec
from .hosts import (HostSpec, SlotInfo, get_host_assignments, parse_hostfile,
                    parse_hosts)
from .http_kv import KVClient, KVServer, local_addresses, make_secret

_LAUNCH_NAMES = ("is_local_host", "main", "parse_args", "run_commandline",
                 "run_static", "spawn_worker", "worker_env")


def __getattr__(name):
    if name in _LAUNCH_NAMES:
        return getattr(importlib.import_module(".launch", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def run(fn, args=(), kwargs=None, np: int = 1, *, hosts: str | None = None,
        hostfile: str | None = None, env: dict | None = None,
        ssh_port: int | None = None, ssh_identity_file: str | None = None,
        verbose: bool = False, start_timeout: float = 600.0) -> list:
    """Run ``fn(*args, **kwargs)`` on ``np`` worker processes and return
    their results in rank order (reference ``horovod.run``). ``fn`` goes
    to the workers through the launcher's KV store, pickled by
    ``cloudpickle``, which must be installed."""
    try:
        import cloudpickle
    except ImportError as e:
        raise RuntimeError(
            "horovod_tpu_torch.runner.run needs the cloudpickle package to "
            "send the function to its workers; install it, or launch a "
            "script with python -m horovod_tpu_torch.runner.launch") from e

    from .launch import JobRendezvous, _resolve_hosts, _supervise, parse_args

    kwargs = kwargs or {}
    ns = parse_args(["-np", str(np)] +
                    (["-H", hosts] if hosts else []) +
                    (["--hostfile", hostfile] if hostfile else []) +
                    (["--ssh-port", str(ssh_port)] if ssh_port else []) +
                    (["--ssh-identity-file", ssh_identity_file]
                     if ssh_identity_file else []) +
                    (["--verbose"] if verbose else []) +
                    ["--", "ignored"])
    specs = _resolve_hosts(ns)
    slots = get_host_assignments(specs, np)

    rdv = JobRendezvous(slots)
    rdv.kv.put("exec/fn", cloudpickle.dumps((fn, tuple(args), kwargs)))
    command = [sys.executable, "-m", "horovod_tpu_torch.runner.task_exec"]
    extra = {**(env or {}), "HVD_START_TIMEOUT": str(start_timeout)}

    procs = []
    try:
        for slot in slots:
            procs.append(rdv.spawn(slot, command, ns, extra))
        # the first non-zero exit tears the job down, so one dead rank
        # cannot hang the others
        code = _supervise(procs, slots, ns)
        # every payload first: after a teardown, earlier ranks may have no
        # result, and the failing rank's traceback is the error to show
        payloads = {slot.rank: rdv.kv.get(f"exec/result/{slot.rank}")
                    for slot in slots}
        decoded = {r: cloudpickle.loads(raw)
                   for r, raw in payloads.items() if raw is not None}
        for r in sorted(decoded):
            status, value = decoded[r]
            if status == "error":
                raise RuntimeError(f"rank {r} failed:\n{value}")
        missing = sorted(r for r, raw in payloads.items() if raw is None)
        if missing:
            raise RuntimeError(
                f"ranks {missing} produced no result (job exit code {code})")
        return [decoded[slot.rank][1] for slot in slots]
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        rdv.stop()


__all__ = [
    "HostSpec", "SlotInfo", "KVClient", "KVServer", "get_host_assignments",
    "hosts_mod", "is_local_host", "local_addresses", "main", "make_secret",
    "parse_args", "parse_hostfile", "parse_hosts", "run", "run_commandline",
    "run_static", "safe_exec", "spawn_worker", "worker_env",
]
