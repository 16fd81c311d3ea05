"""Checkpoints of training state, and the elastic **state plane**: sharded
background snapshots and peer restore (port of ``horovod_tpu/checkpoint.py``).

Two halves, as in the JAX package:

* :class:`Checkpointer`: step-indexed checkpoints with retention, usable
  alone or under elastic training (commit to memory every step, checkpoint
  to disk every epoch; after a restart, ``restore`` and
  ``hvd.broadcast_parameters`` resume). The JAX package writes orbax
  checkpoints; the port writes one ``torch.save`` file of CPU copies a step,
  ``<directory>/<step>/state.pt``, renamed into place whole, and restores
  each tensor onto the device and dtype of the ``target``'s leaf. In a
  world of more than one rank, rank 0 writes (the data-parallel state is
  the same on every rank) and every rank reads.

* :class:`StatePlane`: with ``HVD_CKPT_DIR`` set, a background thread a
  rank writes this rank's share of every ``HVD_CKPT_INTERVAL``-th committed
  state (``leaf_range(rank, world)`` of the flattened tree), each shard a
  temp-file-and-rename write with a crc32 sidecar; rank 0 seals the step
  with a manifest and only then moves ``latest``, so a reader never sees a
  torn tree. The restore half (``elastic.TorchState.sync``) re-syncs a world
  by pulling shards from the survivors over the launcher's KV store, each
  verified by its digest, with rank 0's broadcast of the whole state as the
  typed, metered degraded path.

The plane's format is the JAX package's, byte for byte: a shard is a
pickled list of the leaves in the flattened order (numpy arrays and Python
scalars), its sidecar and the manifest are JSON, and the names are
``step-<n>/shard-<lo>-<hi>.bin|.json``, ``manifest-<n>.json`` and
``latest``; a step sealed by either package restores in the other. numpy has
no bfloat16, so a bfloat16 leaf is stored as its bits, a uint16 array
viewed as the one-field structured dtype :data:`BF16_DTYPE` (field
``bfloat16``): one array leaf, tagged by its dtype (:func:`to_host`,
:func:`from_host`). The JAX
package's in-world loopback transfer of shards is not ported: a rank is a
process, and the KV store is the path. Fault sites: ``ckpt.write`` (a
snapshot's write), ``ckpt.manifest`` (its seal) and ``ckpt.shard_pull``
(serving a shard).

    import horovod_tpu_torch as hvd
    mgr = hvd.checkpoint.Checkpointer("/ckpts/run1", max_to_keep=3)
    mgr.save(step, {"model": model.state_dict(),
                    "optimizer": opt.state_dict()})
    ...
    state = mgr.restore(target={"model": model.state_dict(),
                                "optimizer": opt.state_dict()})
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from . import conformance as _conformance
from . import metrics as _metrics
from .utils import envs
from .utils import faults as _faults
from .utils import invariants as _inv
from .utils import logging as hvd_logging
from .utils.tree import flatten, unflatten

# a bfloat16 leaf's host form: its bits, tagged by the dtype's field name
BF16_DTYPE = np.dtype([("bfloat16", np.uint16)])


def to_host(x):
    """A leaf as the plane and the elastic state keep it: a tensor becomes
    a numpy array on the host (a bfloat16 one its bits as
    :data:`BF16_DTYPE`); anything else is kept as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    t = x.detach().to("cpu", copy=True)  # never a view of a live tensor
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_DTYPE)
    return t.numpy()


def from_host(x, like=None):
    """The tensor of a host leaf (on ``like``'s device and dtype when
    given), or ``x`` itself when it is not one."""
    if not isinstance(x, np.ndarray):
        return x
    if x.dtype == BF16_DTYPE:
        t = torch.from_numpy(x.view(np.int16).copy(order="C")) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy(order="C"))  # 0-d stays 0-d
    if like is not None:
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def host_tree(tree):
    """``tree`` with each tensor replaced by its host leaf."""
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [to_host(x) for x in leaves], tree)


def tensor_tree(tree):
    """``tree`` with each host leaf replaced by its tensor (on the CPU)."""
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [from_host(x) for x in leaves], tree)


def _leaf_meta(x) -> tuple | None:
    """(shape, dtype) of an array leaf, None for a Python object."""
    if isinstance(x, np.ndarray) and x.dtype == BF16_DTYPE:
        return tuple(x.shape), "bfloat16"
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(x.shape), str(x.dtype)
    return None


# ===========================================================================
# Checkpointer: step directories of torch.save files
# ===========================================================================

_STATE_FILE = "state.pt"


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the world."""
    from . import runtime
    return not runtime.is_initialized() or runtime.rank() == 0


class Checkpointer:
    """Step-indexed checkpoint directory with retention (the JAX package's
    orbax ``CheckpointManager``, over ``torch.save``)."""

    def __init__(self, directory: str, *, max_to_keep: int | None = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    # -- save / restore ----------------------------------------------------

    def save(self, step: int, tree: Any, *, wait: bool = False) -> None:
        """Save a tree of tensors (and Python values) at ``step``: CPU
        copies in one file, written into a temporary directory renamed to
        ``<step>``. Every rank may call it; rank 0 writes, so another rank
        reads it after a barrier. The write is done when the call returns
        (``wait`` is the reference's, and has nothing to wait for)."""
        del wait
        if not _writes():
            return
        step = int(step)
        leaves, treedef = flatten(tree)
        cpu = unflatten(treedef, [x.detach().cpu()
                                  if isinstance(x, torch.Tensor) else x
                                  for x in leaves], tree)
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(cpu, os.path.join(tmp, _STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._retain()

    def _retain(self) -> None:
        if self.max_to_keep is None:
            return
        for s in self.all_steps()[:-self.max_to_keep or None]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def restore(self, *, step: int | None = None, target: Any = None) -> Any:
        """The tree saved at ``step`` (default: the latest). With a
        ``target`` of the same structure, each tensor comes back on the
        device and in the dtype of ``target``'s leaf; without, on the
        CPU."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}")
        # the file is this job's own: it may hold any picklable value
        tree = torch.load(os.path.join(self.directory, str(int(step)),
                                       _STATE_FILE), weights_only=False)
        if target is None:
            return tree
        leaves, treedef = flatten(tree)
        t_leaves, _ = flatten(target)
        if len(t_leaves) != len(leaves):
            raise ValueError(f"target has {len(t_leaves)} leaves, the "
                             f"checkpoint {len(leaves)}")
        return unflatten(treedef, [
            x.to(device=t.device, dtype=t.dtype)
            if isinstance(x, torch.Tensor) and isinstance(t, torch.Tensor)
            else x for x, t in zip(leaves, t_leaves)], target)

    # -- bookkeeping -------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self.directory, name, _STATE_FILE)):
                out.append(int(name))
        return sorted(out)

    def wait_until_finished(self) -> None:
        """Writes finish inside :meth:`save`."""

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def save(directory: str, step: int, tree: Any) -> None:
    """One-shot save (the epoch-end idiom)."""
    with Checkpointer(directory, max_to_keep=None) as mgr:
        mgr.save(step, tree, wait=True)


def restore(directory: str, *, step: int | None = None,
            target: Any = None) -> Any:
    """One-shot restore of ``step`` (default: the latest)."""
    with Checkpointer(directory) as mgr:
        return mgr.restore(step=step, target=target)


def restore_or_none(directory: str, *, target: Any = None) -> Any | None:
    """The latest checkpoint, or None when ``directory`` holds none (the
    resume-if-present idiom). A state-plane snapshot is preferred where
    there is one: the newest step whose manifest and every shard digest
    verify, so a process killed mid-snapshot resumes from the previous
    complete step, never a torn tree."""
    plane = sharded_restore_or_none(directory, target=target)
    if plane is not None:
        return plane
    try:
        with Checkpointer(directory) as mgr:
            if mgr.latest_step() is None:
                return None
            return mgr.restore(target=target)
    except FileNotFoundError:
        return None
    except Exception as e:
        hvd_logging.warning("checkpoint restore from %s failed: %s",
                            directory, e)
        return None


# ===========================================================================
# The state plane: sharded background snapshots and peer restore
# ===========================================================================

MANIFEST_SCHEMA = 1

# KV key prefix of the peer shard hand-offs; the keys are scoped by round
PEER_KEY_PREFIX = "ckpt/peer/"

# the writer thread's wait slice: short enough that stop() is prompt
_WAIT_SLICE_S = 0.2

# how long rank 0's writer waits for the other ranks' shards before it
# abandons a step's manifest; ``latest`` then stays at the previous step
_MANIFEST_WAIT_S = 60.0

# Test seam: maps a served shard's payload (fn(tag, payload) -> payload)
# after its digest is computed, to make a digest-mismatched shard.
_corrupt_shard_hook = None


def leaf_range(i: int, n: int, total: int) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` of ``total`` flattened leaves owned by
    participant ``i`` of ``n``; the first ``total % n`` take one more. The
    one partition function of the snapshot writers and of a restore."""
    base, extra = divmod(total, n)
    lo = i * base + min(i, extra)
    return lo, lo + base + (1 if i < extra else 0)


def shard_digest(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def structure_digest(leaves, treedef) -> int:
    """Shape fingerprint of a flattened state tree: its structure and each
    leaf's (shape, dtype), or the type of a Python leaf. Free of values:
    survivors and a fresh joiner built from the same code agree on it."""
    parts = [repr(treedef)]
    for leaf in leaves:
        meta = _leaf_meta(leaf)
        parts.append(meta if meta is not None
                     else ("pyobj", type(leaf).__name__))
    return zlib.crc32(repr(parts).encode()) & 0xFFFFFFFF


def tree_nbytes(leaves) -> int:
    """The payload of a flattened tree: array bytes, 64 a Python leaf (the
    broadcast path's restore meter)."""
    total = 0
    for leaf in leaves:
        total += int(getattr(leaf, "nbytes", 64))
    return total


def _shard_stem(lo: int, hi: int) -> str:
    return f"shard-{lo}-{hi}"


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"manifest-{step}.json")


def latest_path(directory: str) -> str:
    return os.path.join(directory, "latest")


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step-{step}")


def _atomic_write(path: str, data: bytes, tag: str) -> None:
    """Temp file and rename: a reader sees the whole file or none."""
    tmp = f"{path}.tmp-{tag}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class StatePlane:
    """One rank's background snapshot writer, made at the first commit that
    triggers one (the ``State.commit`` seam) and dropped at every reset
    (``State.on_reset``): rank and world size belong to one round.

    The hand-off is copy-free: the committed tree's leaves are host arrays
    that ``State.save()`` replaces (never mutates) at the next commit.
    Latest wins: a snapshot still pending when the next one triggers is
    replaced; the durable history is :class:`Checkpointer`'s."""

    def __init__(self, directory: str, *, rank: int, world: int,
                 interval: int):
        self.directory = directory
        self.rank = rank
        self.world = world
        self.interval = max(1, interval)
        self.last_manifest_step = -1  # rank 0 only
        self._cv = _inv.make_condition("checkpoint.plane.cv")
        self._pending = None  # (step, shard leaves, lo, hi, n_leaves)
        self._busy = False  # the writer is writing a snapshot
        self._stopped = False
        self._thread = None

    # -- trigger (the training thread, at the commit) ----------------------

    def note_commit(self, state) -> None:
        """The ``State.commit()`` seam: on every ``interval``-th commit,
        flatten the committed tree, take this rank's leaf range and hand
        it to the writer. Every rank triggers at the same commit with the
        same partition; the write happens off this thread."""
        step = state._commits
        if step % self.interval != 0:
            return
        leaves, _treedef = flatten(state._saved_state)
        lo, hi = leaf_range(self.rank, self.world, len(leaves))
        _conformance.record("checkpoint.py::StatePlane.note_commit",
                            "snapshot", (step, self.world, len(leaves)))
        with self._cv:
            if self._stopped:
                return
            self._pending = (step, leaves[lo:hi], lo, hi, len(leaves))
            if self._thread is None:
                self._thread = _inv.spawn_thread(
                    self._loop, name=f"hvd-ckpt-snapshot-r{self.rank}")
            self._cv.notify_all()

    def stop(self, *, join: bool = True) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        t, self._thread = self._thread, None
        if t is not None and join:
            _inv.join_thread(t, timeout=5)

    def flush(self, timeout: float = 60.0) -> bool:
        """Wait until no snapshot is pending or being written; True when
        the writer went idle within ``timeout``."""
        deadline = _inv.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._busy:
                if _inv.monotonic() > deadline:
                    return False
                self._cv.wait(_WAIT_SLICE_S / 4)
        return True

    # -- the writer thread -------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stopped:
                    self._cv.wait(_WAIT_SLICE_S)
                if self._pending is None:
                    return  # stopped with nothing queued
                job, self._pending = self._pending, None
                self._busy = True
            try:
                self._write_snapshot(*job)
            except Exception as e:
                # a failed snapshot costs freshness, never the job: the
                # previous manifest stays latest and complete
                hvd_logging.warning(
                    "ckpt: snapshot for step %d failed on rank %d: %s",
                    job[0], self.rank, e)
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write_snapshot(self, step: int, leaves, lo: int, hi: int,
                        n_leaves: int) -> None:
        t0 = _inv.monotonic()
        # fault site: a rank killed mid-snapshot; renamed shards stay, the
        # sidecar and the manifest never land, latest never moves
        _faults.inject("ckpt.write", rank=self.rank)
        payload = pickle.dumps(leaves, protocol=pickle.HIGHEST_PROTOCOL)
        digest = shard_digest(payload)
        sdir = step_dir(self.directory, step)
        os.makedirs(sdir, exist_ok=True)
        stem = os.path.join(sdir, _shard_stem(lo, hi))
        _atomic_write(stem + ".bin", payload, f"r{self.rank}")
        # the sidecar is the shard's commit record, written after the
        # payload's rename: the manifest writer polls sidecars only
        meta = {"lo": lo, "hi": hi, "digest": digest,
                "nbytes": len(payload), "rank": self.rank}
        _atomic_write(stem + ".json", json.dumps(meta).encode(),
                      f"r{self.rank}")
        _metrics.CKPT_SHARDS_WRITTEN.inc()
        if self.rank == 0:
            self._write_manifest(step, n_leaves)
        _metrics.CKPT_SNAPSHOT_SECONDS.observe(_inv.monotonic() - t0)

    def _write_manifest(self, step: int, n_leaves: int) -> None:
        """Seal ``step``: wait for every rank's sidecar, then write the
        manifest and move ``latest``, both atomic and in that order."""
        expected = [leaf_range(r, self.world, n_leaves)
                    for r in range(self.world)]
        expected = [(lo, hi) for lo, hi in expected if hi > lo]
        sdir = step_dir(self.directory, step)
        deadline = _inv.monotonic() + _MANIFEST_WAIT_S
        while True:
            shards = []
            for lo, hi in expected:
                try:
                    with open(os.path.join(
                            sdir, _shard_stem(lo, hi) + ".json"), "rb") as f:
                        shards.append(json.loads(f.read().decode()))
                except (OSError, ValueError):
                    shards = None
                    break
            if shards is not None:
                break
            with self._cv:
                newer = self._pending is not None or self._stopped
            if newer or _inv.monotonic() > deadline:
                hvd_logging.warning(
                    "ckpt: abandoning manifest for step %d (peer shards "
                    "missing; latest stays at %d)", step,
                    self.last_manifest_step)
                return
            _inv.sleep(_WAIT_SLICE_S / 4)
        _faults.inject("ckpt.manifest", rank=self.rank)
        manifest = {"schema": MANIFEST_SCHEMA, "step": step,
                    "world": self.world, "n_leaves": n_leaves,
                    "shards": shards}
        _atomic_write(manifest_path(self.directory, step),
                      json.dumps(manifest).encode(), "m")
        _atomic_write(latest_path(self.directory), str(step).encode(), "l")
        self.last_manifest_step = step


# the process's plane, or False ("state plane off") so that a commit's
# fast path is one probe
_process_plane: "StatePlane | bool | None" = None


def _make_plane() -> "StatePlane | bool":
    d = envs.ckpt_dir()
    if not d:
        return False
    from . import runtime
    if runtime.is_initialized():
        rank, world = runtime.rank(), runtime.size()
    else:
        rank = envs.launcher_rank() or 0
        world = int(os.environ.get("WORLD_SIZE", "1"))
    return StatePlane(d, rank=rank, world=world,
                      interval=envs.ckpt_interval())


def note_commit(state) -> None:
    """The ``State.commit()`` seam: nothing but a probe of a cached miss
    when ``HVD_CKPT_DIR`` is unset."""
    global _process_plane
    plane = _process_plane
    if plane is None:
        plane = _process_plane = _make_plane()
    if plane is not False:
        plane.note_commit(state)


def current_plane() -> "StatePlane | None":
    """This process's live plane, if one was made."""
    plane = _process_plane
    return plane if isinstance(plane, StatePlane) else None


def reset_plane() -> None:
    """Stop and drop this process's plane (a reset, teardown, tests); the
    next commit reads the knobs again under the new rank and world."""
    global _process_plane
    plane, _process_plane = _process_plane, None
    if isinstance(plane, StatePlane):
        plane.stop()


# -- on-disk restore (a whole job's restart) --------------------------------

def sharded_restore_or_none(directory: str, *, target: Any = None,
                            step: int | None = None) -> Any | None:
    """Reassemble a state-plane snapshot from ``directory``: the newest
    step (or ``step``) whose manifest exists and whose every shard passes
    its digest, older manifests in turn when the newest is incomplete or
    corrupt. Returns the list of leaves, or with ``target`` the tree of
    its structure, each array leaf a tensor on the device and in the dtype
    of ``target``'s tensor leaf (a host leaf where ``target``'s is one); or
    None."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    steps = []
    for name in names:
        if name.startswith("manifest-") and name.endswith(".json"):
            try:
                steps.append(int(name[len("manifest-"):-len(".json")]))
            except ValueError:
                continue
    for s in sorted(steps, reverse=True):
        if step is not None and s != step:
            continue
        tree = _load_manifest_step(directory, s, target)
        if tree is not None:
            return tree
    return None


def _load_manifest_step(directory: str, step: int, target) -> Any | None:
    try:
        with open(manifest_path(directory, step), "rb") as f:
            manifest = json.loads(f.read().decode())
        leaves: list = [None] * int(manifest["n_leaves"])
        filled = [False] * len(leaves)
        for meta in manifest["shards"]:
            lo, hi = int(meta["lo"]), int(meta["hi"])
            with open(os.path.join(step_dir(directory, step),
                                   _shard_stem(lo, hi) + ".bin"),
                      "rb") as f:
                payload = f.read()
            if shard_digest(payload) != int(meta["digest"]):
                raise ValueError(
                    f"shard [{lo},{hi}) digest mismatch at step {step}")
            part = pickle.loads(payload)
            if len(part) != hi - lo:
                raise ValueError(
                    f"shard [{lo},{hi}) holds {len(part)} leaves")
            leaves[lo:hi] = part
            filled[lo:hi] = [True] * (hi - lo)
        if not all(filled):
            raise ValueError(f"step {step} manifest leaves incomplete")
        if target is None:
            return leaves
        t_leaves, treedef = flatten(target)
        if len(t_leaves) != len(leaves):
            raise ValueError(
                f"target has {len(t_leaves)} leaves, snapshot "
                f"{len(leaves)}")
        return unflatten(treedef, [
            from_host(x, t) if isinstance(t, torch.Tensor) else x
            for x, t in zip(leaves, t_leaves)], target)
    except Exception as e:
        hvd_logging.warning(
            "ckpt: snapshot step %d under %s unusable (%s); trying older "
            "manifests", step, directory, e)
        return None


# -- the peer-restore protocol (a state re-sync) ----------------------------

def peer_restore_active() -> bool:
    """Whether a state re-sync runs the peer-restore protocol rather than
    rank 0's broadcast (``HVD_CKPT_PEER_RESTORE``, default on). It serves
    from the survivors' live committed state: it needs no snapshot
    directory."""
    return envs.ckpt_peer_restore_enabled()


class RestorePlan:
    """Every rank's identical view of one restore, derived from the
    allgathered fingerprints: who holds the committed step (survivors),
    who needs it (needy), and why the world must take the rank-0
    broadcast (``degraded_reason``) when it must."""

    __slots__ = ("step", "world", "n_leaves", "survivors", "needy",
                 "fresh", "degraded_reason")

    def __init__(self, step, world, n_leaves, survivors, needy, fresh,
                 degraded_reason):
        self.step = step
        self.world = world
        self.n_leaves = n_leaves
        self.survivors = tuple(survivors)
        self.needy = tuple(needy)
        self.fresh = fresh
        self.degraded_reason = degraded_reason

    def transfers(self, attempt: int, failed=()) -> list:
        """The shard-pull schedule of ``attempt``: sorted ``(needy, owner,
        k, lo, hi)`` rows. Attempt 0 fans every needy rank over every
        survivor's range; attempt 1 pulls only the failed ``(needy, k)``
        pairs again, from the next survivor in the ring. Both sides walk
        the list in order, so the rendezvous graph is acyclic."""
        k_range = range(len(self.survivors))
        items = ([(d, k) for d in self.needy for k in k_range]
                 if attempt == 0 else sorted(failed))
        out = []
        for d, k in sorted(items):
            owner = self.survivors[(k + attempt) % len(self.survivors)]
            lo, hi = leaf_range(k, len(self.survivors), self.n_leaves)
            if hi > lo:
                out.append((d, owner, k, lo, hi))
        return out


def fingerprint_blob(rank: int, commits: int, leaves, treedef) -> dict:
    plane = current_plane()
    return {
        "rank": rank,
        "commits": int(commits),
        "n_leaves": len(leaves),
        "struct": structure_digest(leaves, treedef),
        "manifest": plane.last_manifest_step if plane else -1,
    }


def make_restore_plan(blobs: list, *, world: int,
                      quorum: int | None = None) -> RestorePlan:
    """The restore plan of every rank's fingerprint: pure and
    deterministic, so each rank computes the same from the same
    allgathered input."""
    if quorum is None:
        quorum = envs.ckpt_shard_quorum()
    groups: dict[tuple, list[int]] = {}
    for b in blobs:
        key = (int(b["commits"]), int(b["n_leaves"]), int(b["struct"]))
        groups.setdefault(key, []).append(int(b["rank"]))
    max_commits = max(k[0] for k in groups)
    if max_commits <= 0:
        # nobody has committed: the initial sync, whose broadcast from
        # rank 0 is the reference's behaviour, not a degraded path
        return RestorePlan(0, world, 0, (), (), True, None)
    best = [k for k in groups if k[0] == max_commits]
    if len(best) > 1:
        # equally committed survivors disagree on the state's structure
        return RestorePlan(max_commits, world, 0, (), (), False, "quorum")
    key = best[0]
    survivors = sorted(groups[key])
    needy = sorted(r for k, ranks in groups.items() if k != key
                   for r in ranks)
    if len(survivors) < quorum:
        return RestorePlan(key[0], world, key[1], survivors, needy,
                           False, "quorum")
    for k, ranks in groups.items():
        if k != key and (k[1], k[2]) != (key[1], key[2]):
            # a needy rank's tree cannot take the survivors' leaves
            return RestorePlan(key[0], world, key[1], survivors, needy,
                               False, "structure")
    return RestorePlan(key[0], world, key[1], survivors, needy,
                       False, None)


def _transfer_timeout_s() -> float:
    """A shard pull's deadline: past the health watchdog's budget (one
    beat interval and the no-beat timeout), so that a dead owner shows as
    the watchdog's typed failure first; at least 20 s."""
    from . import health
    return max(2.0 * health.watchdog_budget_s(), 20.0)


def _kv_client():
    addr = envs.get(envs.KV_ADDR)
    if not addr:
        return None
    from .runner.http_kv import KVClient
    return KVClient(addr, envs.get_int(envs.KV_PORT, 0),
                    secret=envs.get(envs.SECRET_KEY))


def peer_key(round_id: int, step: int, needy: int, owner: int,
             lo: int, hi: int, attempt: int) -> str:
    return (f"{PEER_KEY_PREFIX}{round_id}/{step}/"
            f"{needy}-{owner}-{lo}-{hi}-{attempt}")


def _serve_shard(tag, envelope, kv, round_id) -> None:
    if kv is None:
        raise RuntimeError("no peer transport: no KV store "
                           "(HVD_KV_ADDR is unset)")
    kv.put(peer_key(round_id, *tag), pickle.dumps(envelope))


def _pull_shard(tag, kv, round_id) -> tuple:
    """Returns ``(envelope, transport)``."""
    if kv is None:
        raise RuntimeError("no peer transport: no KV store "
                           "(HVD_KV_ADDR is unset)")
    key = peer_key(round_id, *tag)
    envelope = pickle.loads(kv.wait(key, timeout=_transfer_timeout_s()))
    try:
        kv.delete(key)
    except Exception:  # best effort: a round's keys are stale anyway
        pass
    return envelope, "kv"


def run_peer_transfers(plan: RestorePlan, me: int, leaves, *,
                       allgather, round_id: int = -1, kv=None):
    """Run both sides of the shard-pull schedule for this rank.

    Returns ``(new_leaves, reason)``: on success the needy ranks get the
    whole leaf list (the survivors None) and ``reason`` is None; on an
    agreed failure every rank gets ``(None, reason)`` and takes the
    broadcast. Every decision (who failed, what is pulled again, success)
    comes out of ``allgather`` rounds, so that every rank branches the
    same way. ``kv`` defaults to a client of the launcher's store."""
    if not plan.needy:
        return None, None
    if kv is None:
        try:
            kv = _kv_client()
        except Exception as e:
            hvd_logging.warning("ckpt: KV store unavailable: %s", e)
    pulled: dict[int, list] = {}  # k -> leaves
    failed: list = []
    for attempt in (0, 1):
        transfers = plan.transfers(attempt, failed)
        my_failures = []
        for d, owner, k, lo, hi in transfers:
            tag = (plan.step, d, owner, lo, hi, attempt)
            if me == owner:
                try:
                    # fault site: a survivor that fails to serve; the
                    # puller reads a typed refusal and fails over
                    _faults.inject("ckpt.shard_pull", rank=me)
                    payload = pickle.dumps(
                        leaves[lo:hi], protocol=pickle.HIGHEST_PROTOCOL)
                    digest = shard_digest(payload)
                    if _corrupt_shard_hook is not None:
                        payload = _corrupt_shard_hook(tag, payload)
                    envelope = ("ok", digest, payload)
                except _faults.FaultInjected as e:
                    envelope = ("err", str(e))
                try:
                    _serve_shard(tag, envelope, kv, round_id)
                except _RECOVERABLE_TRANSFER_ERRORS as e:
                    hvd_logging.warning(
                        "ckpt: serving shard %s failed: %s", tag, e)
            elif me == d:
                try:
                    envelope, transport = _pull_shard(tag, kv, round_id)
                    part = _verify_shard(envelope, leaves, lo, hi)
                    pulled[k] = part
                    _metrics.CKPT_PEER_SHARDS_PULLED.inc(
                        labels={"transport": transport})
                    _metrics.CKPT_RESTORE_BYTES.inc(
                        len(envelope[2]), labels={
                            "source": "rank0" if owner == 0 else "peer"})
                except _RECOVERABLE_TRANSFER_ERRORS as e:
                    hvd_logging.warning(
                        "ckpt: pull of shard %s failed (%s); will fail "
                        "over", tag, e)
                    my_failures.append((d, k))
        statuses = allgather(("ckpt-status", attempt,
                              sorted(my_failures)))
        failed = sorted({(int(d), int(k)) for s in statuses
                         for d, k in s[2]})
        if not failed:
            break
    if failed:
        return None, "pull-failed"
    if me not in plan.needy:
        return None, None
    new_leaves: list = [None] * plan.n_leaves
    for k, part in pulled.items():
        lo, hi = leaf_range(k, len(plan.survivors), plan.n_leaves)
        new_leaves[lo:hi] = part
    if any(leaf is None for leaf in new_leaves):
        return None, "pull-failed"  # a plan or partition fault
    return new_leaves, None


class _ShardRejected(ValueError):
    """A pulled shard failed verification (digest or shape); the next
    survivor can serve it."""


# Narrow on purpose: a PeerFailureError or HostsUpdatedInterrupt is a
# RuntimeError that must propagate (the elastic loop's re-form triggers);
# only the typed failures of one shard, which another survivor absorbs.
_RECOVERABLE_TRANSFER_ERRORS = (TimeoutError, OSError, _ShardRejected,
                                pickle.UnpicklingError, ValueError)


def _verify_shard(envelope, template_leaves, lo: int, hi: int) -> list:
    """Digest and structure verification of a pulled shard: the digest
    guards the bytes, and each leaf must match this rank's own template
    slice in shape and dtype."""
    if not isinstance(envelope, tuple) or not envelope:
        raise _ShardRejected(f"malformed envelope {type(envelope)}")
    if envelope[0] != "ok":
        raise _ShardRejected(f"owner refused: {envelope[1:]}")
    _okc, digest, payload = envelope
    if shard_digest(payload) != digest:
        raise _ShardRejected("digest mismatch")
    part = pickle.loads(payload)
    if len(part) != hi - lo:
        raise _ShardRejected(
            f"expected {hi - lo} leaves, got {len(part)}")
    for got, want in zip(part, template_leaves[lo:hi]):
        want_meta = _leaf_meta(want)
        if want_meta is not None and _leaf_meta(got) != want_meta:
            raise _ShardRejected(
                f"leaf shape/dtype mismatch: {_leaf_meta(got)} vs "
                f"{want_meta}")
    return part
