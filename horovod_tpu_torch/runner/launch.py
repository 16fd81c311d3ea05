"""The launcher: ``python -m horovod_tpu_torch.runner.launch`` (port of
``horovod_tpu/runner/launch.py``).

Parse the host and slot topology, seed each worker's environment (its rank
layout, the rendezvous of ``torch.distributed`` and the launcher's KV
store), spawn one worker process per slot, locally or over ssh, and
supervise the job::

    python -m horovod_tpu_torch.runner.launch -np 4 -- python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \\
        --host-discovery-script ./discover.sh -- python train.py

A worker reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (rank 0's
``TCPStore``, the JAX package's coordinator), the JAX package's ``HVD_*``
set, and ``HVD_CUDA_DEVICE``: the card it drives, handed out by a
per-machine pool (:class:`CardPool`), so two workers of one machine never
share a card, even where two host names alias the machine. The elastic
path (``--min-np``/``--max-np``/``--host-discovery-script``) is
``horovod_tpu_torch.elastic.launch``.
"""

from __future__ import annotations

import argparse
import itertools
import os
import random
import shlex
import socket
import subprocess
import sys
import threading
import time

from . import hosts as hosts_mod
from . import safe_exec
from .http_kv import KVServer, local_addresses, make_secret
from ..utils import envs
from ..version import __version__

PROG = "python -m horovod_tpu_torch.runner.launch"

SSH_OPTIONS = ["-o", "PasswordAuthentication=no",
               "-o", "StrictHostKeyChecking=no",
               "-o", "ConnectTimeout=10"]

# environment forwarded from the launcher to every remote worker
_FORWARD_PREFIXES = ("HVD_", "HOROVOD_", "TORCH_", "NCCL_", "CUDA_", "GLOO_",
                     "OMP_", "PYTHON", "PATH", "LD_", "VIRTUAL_ENV", "HOME",
                     "USER")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="Launch a horovod_tpu_torch distributed job.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-v", "--version", action="version",
                        version=f"{PROG} {__version__}")
    parser.add_argument("-np", "--num-proc", dest="np", type=int, default=None,
                        help="total number of worker processes")
    parser.add_argument("-H", "--hosts", default=None,
                        help='host list, e.g. "h1:2,h2:2" (slots default 1)')
    parser.add_argument("--hostfile", default=None,
                        help='hostfile with "hostname slots=N" lines')
    parser.add_argument("--slots-per-host", type=int, default=None,
                        help="override slot count for every host")
    parser.add_argument("--min-np", type=int, default=None,
                        help="elastic: minimum world size")
    parser.add_argument("--max-np", type=int, default=None,
                        help="elastic: maximum world size")
    parser.add_argument("--host-discovery-script", default=None,
                        help="elastic: executable printing one host:slots "
                             "per line")
    parser.add_argument("--reset-limit", type=int, default=None,
                        help="elastic: stop after this many resets")
    parser.add_argument("--blacklist-cooldown-range", nargs=2, type=float,
                        default=None, metavar=("LO", "HI"),
                        help="elastic: blacklisted-host cooldown bounds (s)")
    parser.add_argument("--ssh-port", type=int, default=None)
    parser.add_argument("--ssh-identity-file", default=None)
    parser.add_argument("--start-timeout", type=float, default=600.0,
                        help="seconds to wait for the job to start")
    parser.add_argument("--output-filename", default=None,
                        help="redirect per-rank output to "
                             "<dir>/rank.<N>/stdout|stderr")
    parser.add_argument("--coordinator-port", type=int, default=0,
                        help="port of rank 0's TCPStore (MASTER_PORT; "
                             "0 = a free one)")
    parser.add_argument("--config-file", default=None,
                        help="YAML config file (CLI flags win)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--disable-cache", action="store_true",
                        help="set HVD_CACHE_CAPACITY=0 in workers")
    parser.add_argument("--timeline-filename", default=None)
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="expose each worker's Prometheus /metrics on "
                             "this base port + its rank (HVD_METRICS_PORT)")
    parser.add_argument("--autotune", action="store_true")
    parser.add_argument("--env", action="append", default=[],
                        metavar="NAME=VALUE", help="extra env for workers")
    parser.add_argument("--launcher", choices=("auto", "local", "lsf"),
                        default="auto",
                        help="host source: 'auto' derives hosts from a "
                             "detected LSF allocation when no -H/--hostfile "
                             "is given, 'local' ignores scheduler env, "
                             "'lsf' requires an LSF allocation")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command")
    args = parser.parse_args(argv)

    if args.config_file:
        from . import config_parser
        cfg = config_parser.load_config(args.config_file)
        explicit = _explicit_dests(
            argv if argv is not None else sys.argv[1:], parser)
        config_parser.apply_config_to_args(cfg, args, explicit)
        args._config_env = config_parser.config_to_env(cfg)
    else:
        args._config_env = {}
    return args


def _explicit_dests(argv, parser) -> set:
    """Dest names of launcher options actually present on the command line.

    Scanning stops at ``--`` or at the first token that starts the training
    command, so flag lookalikes inside the command (the user's own
    ``--verbose``) are not taken for launcher options."""
    explicit = set()
    opt_actions = {}
    for action in parser._actions:
        for opt in action.option_strings:
            opt_actions[opt] = action
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--":
            break
        if tok.startswith("-"):
            opt = tok.split("=", 1)[0]
            action = opt_actions.get(opt)
            if action is None and opt.startswith("--"):
                # argparse accepts unambiguous long-option abbreviations
                matches = {a for o, a in opt_actions.items()
                           if o.startswith(opt)}
                if len(matches) == 1:
                    action = next(iter(matches))
            if action is None:
                break  # unknown flag: the training command has started
            explicit.add(action.dest)
            if "=" in tok or isinstance(action, (
                    argparse._StoreTrueAction, argparse._StoreFalseAction,
                    argparse._CountAction, argparse._HelpAction,
                    argparse._VersionAction)):
                consumed = 0
            elif isinstance(action.nargs, int):
                consumed = action.nargs  # --blacklist-cooldown-range LO HI
            else:
                consumed = 1
            i += 1 + consumed
            continue
        break  # first positional token: the training command has started
    return explicit


def _resolve_hosts(args) -> list[hosts_mod.HostSpec]:
    from . import lsf

    if args.hosts and args.hostfile:
        raise ValueError("--hosts and --hostfile are mutually exclusive")
    launcher = getattr(args, "launcher", "auto")
    if launcher == "lsf" and not lsf.using_lsf():
        raise RuntimeError("--launcher lsf: no LSF allocation detected "
                           "(LSB_JOBID not set)")
    specs = None
    if args.hosts:
        specs = hosts_mod.parse_hosts(args.hosts)
    elif args.hostfile:
        specs = hosts_mod.parse_hostfile(args.hostfile)
    elif launcher != "local" and lsf.using_lsf():
        try:
            specs = lsf.lsf_host_specs()
        except RuntimeError:
            if launcher == "lsf":
                raise  # asked for explicitly: fail loudly
            # auto: LSB_JOBID set but no usable host env; fall through
    if specs is None:
        specs = [hosts_mod.HostSpec("localhost", args.np or 1)]
    if args.slots_per_host:
        specs = [hosts_mod.HostSpec(h.hostname, args.slots_per_host)
                 for h in specs]
    return specs


_is_local_cache: dict[str, bool] = {}


def is_local_host(hostname: str) -> bool:
    if hostname in ("localhost", "127.0.0.1", socket.gethostname()):
        return True
    cached = _is_local_cache.get(hostname)
    if cached is not None:
        return cached
    try:
        result = socket.gethostbyname(hostname) in local_addresses()
    except OSError:
        return False  # a transient resolver failure: not memoized
    _is_local_cache[hostname] = result
    return result


# Ports below Linux's default ephemeral range (32768-60999): a port the
# kernel hands out for port 0 may go to another process's outgoing
# connection (the KV clients open many) before rank 0 listens on it.
_LISTEN_PORTS = (20000, 32768)


def _free_port() -> int:
    """A port nothing listens on now, for a server started a moment later
    (rank 0's ``TCPStore``): drawn below the ephemeral range, where no
    outgoing connection takes it meanwhile; a kernel-picked one where
    none of those is free."""
    rng = random.Random()
    for _ in range(64):
        port = rng.randrange(*_LISTEN_PORTS)
        with socket.socket() as s:
            try:
                s.bind(("", port))
            except OSError:
                continue
        return port
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _local_card_count() -> int | None:
    """The cards this machine shows its workers (which inherit this
    process's ``CUDA_VISIBLE_DEVICES``); None where it shows none, as on a
    host that runs gloo workers."""
    try:
        import torch
    except ImportError:
        return None
    count = torch.cuda.device_count()
    return count or None


def departure_wait_s(policy_grace_s: float = 0.0) -> float:
    """How long an elastic job's worker spawn waits for a card of its
    machine (:meth:`CardPool.spawn`): the longest grace a departing worker
    gets (``HVD_ELASTIC_GRACE``, or the autoscale policy's), then its
    termination."""
    return (max(envs.get_float(envs.ELASTIC_GRACE, 0.0), policy_grace_s)
            + safe_exec.GRACEFUL_TERMINATION_TIME_S)


class CardPool:
    """The cards of each machine, one to each live worker. A worker gets
    the lowest card of its machine that no live worker of this launcher
    holds; the card is free again once that worker's process has exited,
    so a worker re-spawned into a re-formed world takes a free card. Host
    names that alias one machine (``localhost``, ``127.0.0.1``, the host's
    own name) share one pool. The local machine has as many cards as it
    shows; another machine has no bound here."""

    def __init__(self):
        self._mu = threading.Lock()
        self._held: dict[str, dict[int, object]] = {}
        self._local_cards: int | None = None  # counted at first use

    @staticmethod
    def machine(hostname: str) -> str:
        return "localhost" if is_local_host(hostname) else hostname

    def _limit(self, machine: str) -> int | None:
        if machine != "localhost":
            return None
        if self._local_cards is None:
            self._local_cards = _local_card_count() or 0
        return self._local_cards or None

    def _reserve(self, machine: str) -> int | None:
        """A free card of ``machine``, now held; None where all are."""
        with self._mu:
            held = self._held.setdefault(machine, {})
            for card, proc in list(held.items()):
                if proc is not None and proc.poll() is not None:
                    del held[card]
            card = next(c for c in itertools.count() if c not in held)
            limit = self._limit(machine)
            if limit is not None and card >= limit:
                return None
            held[card] = None  # reserved while the worker starts
            return card

    def spawn(self, hostname: str, start, wait_s: float = 0.0):
        """``start(card) -> process`` with a free card of ``hostname``'s
        machine; the card stays held while the process lives. Where every
        card of the machine is held (an elastic replacement spawned while
        the worker it replaces drains in its grace window), wait up to
        ``wait_s`` seconds for one to free (:func:`departure_wait_s`)."""
        machine = self.machine(hostname)
        deadline = time.monotonic() + wait_s
        while (card := self._reserve(machine)) is None:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"no free card on {machine} after {wait_s:g} s: "
                    f"all {self._limit(machine)} are held by live workers")
            time.sleep(0.05)
        held = self._held[machine]
        try:
            proc = start(card)
        except BaseException:
            with self._mu:
                held.pop(card, None)
            raise
        with self._mu:
            held[card] = proc
        return proc


def _forwarded_env() -> dict[str, str]:
    env = {k: v for k, v in os.environ.items()
           if k.startswith(_FORWARD_PREFIXES)}
    # workers import this package from its checkout even where it is not
    # installed and the worker script lives elsewhere
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = os.environ.get("PYTHONPATH", "").split(os.pathsep)
    if pkg_root not in parts:
        parts.insert(0, pkg_root)
    env["PYTHONPATH"] = os.pathsep.join(p for p in parts if p)
    return env


def worker_env(slot: hosts_mod.SlotInfo, *, coordinator_addr: str,
               coordinator_port: int, kv_addr: str, kv_port: int,
               secret: str, extra: dict | None = None,
               card: int | None = None) -> dict[str, str]:
    """One worker's environment: the JAX package's ``HVD_*`` contract and
    ``torch.distributed``'s (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``: the
    coordinator is rank 0's ``TCPStore``), and ``HVD_CUDA_DEVICE`` where a
    card is given."""
    env = _forwarded_env()
    env.update({
        "HVD_RANK": str(slot.rank),
        "HVD_SIZE": str(slot.size),
        "HVD_LOCAL_RANK": str(slot.local_rank),
        "HVD_LOCAL_SIZE": str(slot.local_size),
        "HVD_CROSS_RANK": str(slot.cross_rank),
        "HVD_CROSS_SIZE": str(slot.cross_size),
        "HVD_PROCESS_ID": str(slot.rank),
        "HVD_NUM_PROCESSES": str(slot.size),
        "HVD_COORDINATOR_ADDR": coordinator_addr,
        "HVD_COORDINATOR_PORT": str(coordinator_port),
        "HVD_KV_ADDR": kv_addr,
        "HVD_KV_PORT": str(kv_port),
        "HVD_SECRET_KEY": secret,
        "HVD_HOSTNAME": slot.hostname,
        "RANK": str(slot.rank),
        "WORLD_SIZE": str(slot.size),
        "LOCAL_RANK": str(slot.local_rank),
        "LOCAL_WORLD_SIZE": str(slot.local_size),
        "MASTER_ADDR": coordinator_addr,
        "MASTER_PORT": str(coordinator_port),
    })
    if card is not None:
        env["HVD_CUDA_DEVICE"] = str(card)
    if extra:
        env.update(extra)
    return env


# Variables whose values never appear in an ssh argv (every local user
# can read it with ps): delivered over the ssh channel's stdin instead.
_SECRET_ENV_VARS = ("HVD_SECRET_KEY",)


def _ssh_base_cmd(ssh_port: int | None, identity_file: str | None) -> list[str]:
    return (["ssh"] + SSH_OPTIONS
            + (["-p", str(ssh_port)] if ssh_port else [])
            + (["-i", identity_file] if identity_file else []))


def _ssh_command(hostname: str, command: list[str], env: dict[str, str],
                 ssh_port: int | None, identity_file: str | None) -> list[str]:
    public_env = {k: v for k, v in env.items() if k not in _SECRET_ENV_VARS}
    exports = " ".join(f"export {k}={shlex.quote(v)};"
                       for k, v in public_env.items())
    secret_reads = " ".join(f"IFS= read -r {k}; export {k};"
                            for k in _SECRET_ENV_VARS if k in env)
    remote = (f"cd {shlex.quote(os.getcwd())} 2>/dev/null; {secret_reads} "
              f"{exports} " + " ".join(shlex.quote(c) for c in command))
    return _ssh_base_cmd(ssh_port, identity_file) + [hostname, remote]


def spawn_worker(slot: hosts_mod.SlotInfo, command: list[str],
                 env: dict[str, str], args) -> safe_exec.ExecutedProcess:
    stdout = stderr = None
    owned = []
    if args.output_filename:
        d = os.path.join(args.output_filename, f"rank.{slot.rank}")
        os.makedirs(d, exist_ok=True)
        stdout = open(os.path.join(d, "stdout"), "w")
        stderr = open(os.path.join(d, "stderr"), "w")
        owned = [stdout, stderr]
    if is_local_host(slot.hostname):
        full_env = dict(os.environ)
        full_env.update(env)
        return safe_exec.execute(command, env=full_env, index=slot.rank,
                                 stdout=stdout, stderr=stderr,
                                 owned_files=owned)
    cmd = _ssh_command(slot.hostname, command, env,
                       args.ssh_port, args.ssh_identity_file)
    secret_lines = b"".join(env[k].encode() + b"\n"
                            for k in _SECRET_ENV_VARS if k in env)
    return safe_exec.execute(cmd, env=dict(os.environ), index=slot.rank,
                             stdout=stdout, stderr=stderr, shell=False,
                             stdin_data=secret_lines or None,
                             owned_files=owned)


def probe_remote_free_port(hostname: str, ssh_port=None,
                           identity_file=None, timeout: float = 20) -> int:
    """A free port of ``hostname``, from its own kernel over ssh: for rank
    0's ``TCPStore`` on a remote host. Raises on an ssh failure or output
    it cannot parse."""
    probe = ("python3 -c 'import socket; s=socket.socket(); "
             "s.bind((\"\", 0)); print(s.getsockname()[1])'")
    cmd = _ssh_base_cmd(ssh_port, identity_file) + [hostname, probe]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=timeout, env=dict(os.environ))
    if out.returncode != 0:
        raise RuntimeError(
            f"port probe on {hostname} failed: {out.stderr.strip()[:500]}")
    return int(out.stdout.strip().splitlines()[-1])


def check_hosts_ssh(hostnames: list[str], ssh_port=None,
                    identity_file=None) -> None:
    """Fail fast when a remote host is unreachable over ssh."""
    remote = [h for h in hostnames if not is_local_host(h)]
    failures = []

    def check(h):
        cmd = _ssh_base_cmd(ssh_port, identity_file) + [h, "true"]
        if safe_exec.run(cmd, env=dict(os.environ), prefix_output=False) != 0:
            failures.append(h)

    threads = [threading.Thread(target=check, args=(h,)) for h in set(remote)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise RuntimeError(
            f"ssh connection failed for hosts: {sorted(failures)}")


class JobRendezvous:
    """The shared rendezvous of one job: the launcher's KV server, the
    address of rank 0's ``TCPStore`` every worker dials, and the card
    pool."""

    def __init__(self, slots: list[hosts_mod.SlotInfo],
                 coordinator_port: int = 0):
        self.secret = make_secret()
        self.kv = KVServer(secret=self.secret)
        self.kv_port = self.kv.start()
        all_local = all(is_local_host(s.hostname) for s in slots)
        self.kv_addr = "127.0.0.1" if all_local else local_addresses()[0]
        # the TCPStore lives in rank 0's process on rank 0's host
        coord_host = slots[0].hostname
        self.coord_addr = "127.0.0.1" if all_local else (
            self.kv_addr if is_local_host(coord_host) else coord_host)
        self.coord_port = coordinator_port or _free_port()
        self.cards = CardPool()

    def worker_env(self, slot, extra=None, card=None) -> dict[str, str]:
        return worker_env(
            slot, coordinator_addr=self.coord_addr,
            coordinator_port=self.coord_port, kv_addr=self.kv_addr,
            kv_port=self.kv_port, secret=self.secret, extra=extra, card=card)

    def spawn(self, slot, command, args, extra=None):
        """Spawn ``slot``'s worker with a card of its machine."""
        return self.cards.spawn(slot.hostname, lambda card: spawn_worker(
            slot, command, self.worker_env(slot, extra, card), args))

    def stop(self) -> None:
        self.kv.stop()


def extra_env(args) -> dict[str, str]:
    """The worker knobs the launcher's flags and config file set."""
    extra = dict(args._config_env)
    for assignment in args.env:
        k, _, v = assignment.partition("=")
        extra[k] = v
    if getattr(args, "disable_cache", False):
        extra["HVD_CACHE_CAPACITY"] = "0"
    if getattr(args, "timeline_filename", None):
        extra["HVD_TIMELINE"] = args.timeline_filename
    if getattr(args, "metrics_port", None):
        extra["HVD_METRICS_PORT"] = str(args.metrics_port)
    if getattr(args, "autotune", False):
        extra["HVD_AUTOTUNE"] = "1"
    return extra


def run_static(args, command: list[str]) -> int:
    """Spawn every rank and wait; the first failure tears the job down."""
    specs = _resolve_hosts(args)
    np = args.np or hosts_mod.total_slots(specs)
    slots = hosts_mod.get_host_assignments(specs, np)
    check_hosts_ssh([s.hostname for s in slots],
                    args.ssh_port, args.ssh_identity_file)

    rdv = JobRendezvous(slots, args.coordinator_port)
    extra = extra_env(args)
    procs = []
    try:
        for slot in slots:
            procs.append(rdv.spawn(slot, command, args, extra))
        return _supervise(procs, slots, args)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        rdv.stop()


def _supervise(procs, slots, args) -> int:
    """Wait for every worker; kill the job at the first failure."""
    exit_codes: dict[int, int] = {}
    lock = threading.Lock()
    failed = threading.Event()

    def waiter(i, p):
        code = p.wait()
        with lock:
            exit_codes[i] = code
        if code != 0:
            failed.set()

    threads = [threading.Thread(target=waiter, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    while True:
        with lock:
            if len(exit_codes) == len(procs):
                break
        if failed.wait(timeout=0.2):
            break
    if failed.is_set():
        with lock:
            bad = {slots[i].rank: c for i, c in exit_codes.items() if c != 0}
        for p in procs:
            if p.poll() is None:
                p.terminate()
        print(f"launch: worker failure, exit codes by rank: {bad}",
              file=sys.stderr)
        return next(iter(bad.values()), 1)
    for t in threads:
        t.join()
    return 0


def run_commandline(argv=None) -> int:
    args = parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("launch: no command given", file=sys.stderr)
        return 2
    if args.verbose:
        envs.set_env(envs.LOG_LEVEL, "debug", only_if_unset=True)
    if args.host_discovery_script or args.min_np or args.max_np:
        from ..elastic.launch import run_elastic
        return run_elastic(args, command)
    return run_static(args, command)


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
