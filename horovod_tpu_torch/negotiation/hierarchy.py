"""Two-level negotiation exchange: member -> leader -> cross-leader ->
fan-down (port of ``horovod_tpu/negotiation/hierarchy.py``).

The flat ``engine_service.KVTransport`` has every rank put its frame and
gather all ``world`` frames, so the KV server assembles ``world`` keys for
each of ``world`` gathers a round. Here one round is:

1. every rank PUTs its frame under its group's scope;
2. each group's leader gathers its group's frames (one long-poll), packs
   them with each one's receipt time on the server's clock into one blob,
   and PUTs it to the cross-leader scope;
3. the leaders gather the ``world / G`` group blobs, merge them into the
   whole rank-ordered table and PUT it as their group's fan-down key;
4. the members long-poll their group's one fan-down key.

A member makes O(1) KV operations a round and a gather assembles O(G) or
O(world / G) keys instead of O(world); the bytes are the same (every rank
still ingests every frame). Three long-polls run in series where the flat
round has one, so the hierarchy pays only past many ranks.

The frame (``<u32 len>`` request bytes, cache bits) and the packed entries
(``<I`` count, then ``<IdI`` rank, receipt, length and the frame each) are
the JAX package's, byte for byte, and the transport has the flat one's
surface (``kv``, ``world_size``, ``rank``, ``prefix``, ``last_round_s``,
``last_lags``, ``exchange``), plus its ``group_layout`` for the health
watchdog. The leader's and members' branches live here, under the
collectives: no collective is conditioned on the role.
"""

from __future__ import annotations

import struct
import time

from ..utils import envs
from ..utils import faults as _faults
from .layout import GroupLayout


def _pack_entries(entries: list[tuple[int, float, bytes]]) -> bytes:
    """``[(rank, server receipt s, frame)]`` -> one blob."""
    out = [struct.pack("<I", len(entries))]
    for rank, receipt, frame in entries:
        out.append(struct.pack("<IdI", rank, receipt, len(frame)))
        out.append(frame)
    return b"".join(out)


def _unpack_entries(blob: bytes) -> list[tuple[int, float, bytes]]:
    (n,) = struct.unpack_from("<I", blob, 0)
    pos = 4
    entries = []
    for _ in range(n):
        rank, receipt, ln = struct.unpack_from("<IdI", blob, pos)
        pos += 16
        entries.append((rank, receipt, blob[pos:pos + ln]))
        pos += ln
    return entries


class HierarchicalTransport:
    """The flat ``KVTransport``'s replacement running the two-level round
    over the same KV server."""

    def __init__(self, kv_client, world_size: int, rank: int,
                 prefix: str = "engine", group_size: int | None = None):
        self.kv = kv_client
        self.world_size = world_size
        self.rank = rank
        self.prefix = prefix
        self.group_layout = GroupLayout(
            world_size, group_size if group_size is not None
            else envs.negotiation_group_size())
        self._gid = self.group_layout.group_of(rank)
        self._leads = self.group_layout.is_leader(rank)
        self.last_round_s = 0.0  # the last round, publish to gathered
        self.last_lags: dict[int, float] = {}  # member -> submit lag (s)

    def exchange(self, cycle: int, req_bytes: bytes, bits: bytes,
                 timeout: float) -> tuple[list[bytes], list[bytes]]:
        """One two-level round; returns the flat transport's rank-ordered
        ``(datas, bitvs)``."""
        _faults.inject("svc.exchange")
        t0 = time.monotonic()
        frame = struct.pack("<I", len(req_bytes)) + req_bytes + bits
        base = f"{self.prefix}/h/{cycle}"
        gid = self._gid
        self.kv.put(f"{base}/g{gid}/{self.rank}", frame)
        if self._leads:
            members = self.group_layout.members_of(gid)
            got, times = self.kv.gather(f"{base}/g{gid}", len(members),
                                        timeout=timeout, with_times=True)
            entries = []
            for k, v in got.items():
                try:
                    r = int(k.rsplit("/", 1)[1])
                except ValueError:
                    continue
                entries.append((r, times.get(k, 0.0), v))
            entries.sort()
            self.kv.put(f"{base}/x/{gid}", _pack_entries(entries))
            xs = self.kv.gather(f"{base}/x", self.group_layout.n_groups,
                                timeout=timeout)
            merged: list[tuple[int, float, bytes]] = []
            for blob in xs.values():
                merged.extend(_unpack_entries(blob))
            merged.sort()
            self.kv.put(f"{base}/r{gid}/all", _pack_entries(merged))
        else:
            got = self.kv.gather(f"{base}/r{gid}", 1, timeout=timeout)
            merged = _unpack_entries(next(iter(got.values())))
        self.last_round_s = time.monotonic() - t0
        datas: list = [b""] * self.world_size
        bitvs: list = [b""] * self.world_size
        receipt: dict[int, float] = {}
        for r, t, fr in merged:
            if not 0 <= r < self.world_size:
                continue
            (ln,) = struct.unpack_from("<I", fr, 0)
            datas[r] = fr[4:4 + ln]
            bitvs[r] = fr[4 + ln:]
            receipt[r] = t
        first = min(receipt.values()) if receipt else 0.0
        self.last_lags = {r: t - first for r, t in sorted(receipt.items())}
        # every member read cycle c before any writes cycle c + 2, so the
        # keys of cycle c - 1 are no longer read: each rank drops its own,
        # a leader its two aggregates too
        if cycle > 0:
            prev = f"{self.prefix}/h/{cycle - 1}"
            stale = [f"{prev}/g{gid}/{self.rank}"]
            if self._leads:
                stale += [f"{prev}/x/{gid}", f"{prev}/r{gid}/all"]
            for key in stale:
                try:
                    self.kv.delete(key)
                except Exception:  # best effort: the keys are round-scoped
                    pass
        return datas, bitvs
