"""LSF / jsrun allocation detection for the launcher (port of
``horovod_tpu/runner/lsf.py``).

When the launcher runs inside an LSF allocation without ``-H`` or
``--hostfile``, the host list comes from the allocation's own environment:

* ``LSB_DJOB_RANKFILE``: a file with one hostname per allocated slot
  (repeats are slots of one host), written by LSF for every distributed
  job;
* ``LSB_MCPU_HOSTS``: ``"host1 n1 host2 n2 ..."`` pairs, the fallback;
* ``LSB_HOSTS``: ``"host1 host1 host2 ..."``, one name per slot, the last
  resort.

A ``jsrun``-launched worker's rank (``JSM_NAMESPACE_RANK``/``_SIZE``) is
read in ``runtime._cluster_world``.
"""

from __future__ import annotations

import collections
import os

from . import hosts as hosts_mod
from ..utils import logging as hvd_logging


def using_lsf() -> bool:
    """True when the current process runs inside an LSF job
    (``LSB_JOBID`` is set)."""
    return "LSB_JOBID" in os.environ


def _drop_launch_nodes(names: list[str]) -> list[str]:
    """Summit-style LSF allocations list the launch (batch) node ahead of
    the compute nodes in LSB_DJOB_RANKFILE / LSB_MCPU_HOSTS, and jsrun
    never places a rank there: drop names by the documented convention
    (``batch*``/``login*``), only when compute hosts remain, so one-host
    jobs keep working. ``-H``/``--hostfile`` override it."""
    kept = [n for n in names
            if not n.lower().startswith(("batch", "login"))]
    if kept and len(kept) < len(names):
        # a cluster naming real compute hosts batch*/login* would be
        # silently shrunk here — say exactly what was filtered so a
        # mis-filtered allocation is visible (escape hatch: -H/--hostfile)
        dropped = sorted({n for n in names if n not in set(kept)})
        hvd_logging.info(
            "LSF allocation: dropping launch node(s) %s (batch*/login* "
            "prefix); %d compute host(s) remain. Pass -H/--hostfile if "
            "these are real compute hosts.", ", ".join(dropped),
            len(set(kept)))
    return kept if kept else names


def _specs_from_slot_hostnames(names: list[str]) -> list[hosts_mod.HostSpec]:
    """One hostname per slot, repeats meaning multiple slots; order of
    first appearance is preserved so rank 0 lands on the first host."""
    names = _drop_launch_nodes(names)
    counts = collections.Counter(names)
    seen: list[str] = []
    for n in names:
        if n not in seen:
            seen.append(n)
    return [hosts_mod.HostSpec(h, counts[h]) for h in seen]


def lsf_host_specs() -> list[hosts_mod.HostSpec]:
    """Host/slot specs for the current LSF allocation.

    Raises ``RuntimeError`` when no usable LSF host information is
    present (caller decides whether that is fatal: it is under
    ``--launcher lsf``, not under ``--launcher auto``).
    """
    rankfile = os.environ.get("LSB_DJOB_RANKFILE")
    if rankfile and os.path.exists(rankfile):
        with open(rankfile) as f:
            names = [line.strip() for line in f if line.strip()]
        if names:
            return _specs_from_slot_hostnames(names)
    mcpu = os.environ.get("LSB_MCPU_HOSTS")
    if mcpu:
        toks = mcpu.split()
        if len(toks) % 2 == 0 and toks:
            try:
                specs = [hosts_mod.HostSpec(toks[i], int(toks[i + 1]))
                         for i in range(0, len(toks), 2)]
                kept = set(_drop_launch_nodes([s.hostname for s in specs]))
                return [s for s in specs if s.hostname in kept]
            except ValueError:
                pass
    hosts = os.environ.get("LSB_HOSTS")
    if hosts and hosts.split():
        return _specs_from_slot_hostnames(hosts.split())
    raise RuntimeError(
        "LSF job detected (LSB_JOBID set) but none of LSB_DJOB_RANKFILE / "
        "LSB_MCPU_HOSTS / LSB_HOSTS yields a host list; pass -H/--hostfile "
        "explicitly")
