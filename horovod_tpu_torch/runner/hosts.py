"""Host and slot parsing, and rank assignment (port of
``horovod_tpu/runner/hosts.py``).

``-H h1:4,h2:4`` host lists, hostfiles, and the host-major contiguous rank
layout that ``local_rank`` and ``cross_rank`` derive from. In the port a
slot is one worker process, and each worker drives one card.
"""

from __future__ import annotations

import dataclasses
import re


class HostParseError(ValueError):
    pass


@dataclasses.dataclass
class HostSpec:
    hostname: str
    slots: int

    def __post_init__(self):
        if self.slots < 1:
            raise HostParseError(
                f"host {self.hostname!r} has invalid slot count {self.slots}")


@dataclasses.dataclass
class SlotInfo:
    """One rank's placement: global rank, position within its host (local)
    and across hosts (cross)."""
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int

    def to_response_string(self) -> str:
        return (f"{self.hostname},{self.rank},{self.size},{self.local_rank},"
                f"{self.local_size},{self.cross_rank},{self.cross_size}")


_HOST_RE = re.compile(r"^(?P<host>\[[^\]]+\]|[^:\s]+)(:(?P<slots>\d+))?$")


def parse_hosts(hosts_string: str) -> list[HostSpec]:
    """Parse ``"h1:4,h2:4"`` (slots default to 1)."""
    specs = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        m = _HOST_RE.match(part)
        if not m:
            raise HostParseError(f"invalid host specification: {part!r}")
        specs.append(HostSpec(m.group("host"),
                              int(m.group("slots") or 1)))
    if not specs:
        raise HostParseError(f"no hosts found in {hosts_string!r}")
    return specs


def parse_hostfile(path: str) -> list[HostSpec]:
    """Parse a hostfile of ``hostname slots=N`` lines; ``#`` starts a
    comment."""
    specs = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = line.split()
            hostname = fields[0]
            slots = 1
            for field in fields[1:]:
                if field.startswith("slots="):
                    slots = int(field[len("slots="):])
                else:
                    raise HostParseError(
                        f"{path}:{lineno}: unrecognized field {field!r}")
            specs.append(HostSpec(hostname, slots))
    if not specs:
        raise HostParseError(f"hostfile {path} is empty")
    return specs


def total_slots(hosts: list[HostSpec]) -> int:
    return sum(h.slots for h in hosts)


def elastic_host_assignments(hosts: list[HostSpec], min_np: int,
                             max_np: int | None) -> list[SlotInfo]:
    """Elastic assignment: every available slot up to ``max_np``; raises
    when fewer than ``min_np`` slots exist."""
    capacity = total_slots(hosts)
    if capacity < min_np:
        raise ValueError(
            f"only {capacity} slots available across {len(hosts)} hosts, "
            f"fewer than the required minimum {min_np}")
    np = capacity if max_np is None else min(capacity, max_np)
    return get_host_assignments(hosts, np)


def get_host_assignments(hosts: list[HostSpec], np: int) -> list[SlotInfo]:
    """Assign ``np`` ranks to hosts, host-major and contiguous: rank r
    lands on the first host with a free slot; local_rank counts within the
    host; cross_rank indexes the host among hosts that own a slot at the
    same local_rank."""
    if np < 1:
        raise ValueError(f"np must be positive, got {np}")
    capacity = total_slots(hosts)
    if np > capacity:
        raise ValueError(
            f"requested np={np} exceeds total available slots {capacity} "
            f"across {len(hosts)} hosts")

    # slots actually used per host, host-major fill
    used: list[int] = []
    remaining = np
    for h in hosts:
        take = min(h.slots, remaining)
        used.append(take)
        remaining -= take
    hosts_used = [(h, u) for h, u in zip(hosts, used) if u > 0]

    assignments: list[SlotInfo] = []
    rank = 0
    for host_idx, (h, u) in enumerate(hosts_used):
        for local_rank in range(u):
            cross_rank = sum(1 for _, u2 in hosts_used[:host_idx]
                             if u2 > local_rank)
            cross_size = sum(1 for _, u2 in hosts_used if u2 > local_rank)
            assignments.append(SlotInfo(
                hostname=h.hostname, rank=rank, size=np,
                local_rank=local_rank, local_size=u,
                cross_rank=cross_rank, cross_size=cross_size))
            rank += 1
    return assignments


def slots_from_ips(ips: list) -> list[SlotInfo]:
    """Rank assignment from an already-placed worker list (one IP per
    rank, rank = list position): local ranks/sizes derive from colocation,
    cross ranks from host order of first appearance: for a scheduler that
    placed the workers itself."""
    n = len(ips)
    host_order: list = []
    local_counts: dict = {}
    for ip in ips:
        if ip not in local_counts:
            local_counts[ip] = 0
            host_order.append(ip)
        local_counts[ip] += 1
    seen: dict = {ip: 0 for ip in local_counts}
    slots = []
    for rank, ip in enumerate(ips):
        slots.append(SlotInfo(
            hostname=ip, rank=rank, size=n,
            local_rank=seen[ip], local_size=local_counts[ip],
            cross_rank=host_order.index(ip), cross_size=len(host_order)))
        seen[ip] += 1
    return slots
