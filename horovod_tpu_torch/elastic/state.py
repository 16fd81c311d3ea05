"""Elastic worker state: save, restore, sync and commit (port of
``horovod_tpu/elastic/state.py``).

The reference's ``State``, ``ObjectState`` and ``run_fn``
(``horovod/common/elastic.py``), and :class:`TorchState` in place of the
JAX package's ``JaxState``, with the model, optimizer and sampler handlers
of reference Horovod's ``torch/elastic/state.py``:

- ``commit()`` saves the state to host memory and checks for host-change
  notifications, raising :class:`HostsUpdatedInterrupt` on every rank at
  the same step (the decision is rank 0's, broadcast).
- ``run_fn`` wraps the training function in the recovery loop:
  ``HorovodInternalError`` restores the last commit and syncs;
  ``HostsUpdatedInterrupt`` syncs unless hosts were only removed.

Every commit also feeds the autoscale policy's observer
(:func:`~horovod_tpu_torch.elastic.policy.note_commit`: one cached check
while ``HVD_AUTOSCALE`` is off).
"""

from __future__ import annotations

import enum
import functools
import queue
import time

import torch

from .. import checkpoint as _ckpt
from .. import metrics as _metrics
from ..exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..utils import faults as _faults
from ..utils.tree import flatten, unflatten
from . import policy as _policy


class HostUpdateResult(enum.IntFlag):
    """What changed in the host set (reference ``worker.py:38-42``)."""
    no_update = 0
    removed = 1
    added = 2
    mixed = removed | added


class State:
    """Base class of worker state tracked across resets.

    Args:
      bcast_object: broadcasts a picklable object from rank 0.
      get_rank: returns this worker's current rank.
    """

    def __init__(self, bcast_object, get_rank):
        self._bcast_object = bcast_object
        self._rank = get_rank
        self._host_messages: queue.Queue = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks = []
        self._commits = 0
        # the kind of the recovery in progress: "peer-failure" or
        # "hosts-updated" (run_fn sets it before the reset)
        self.last_recovery: str | None = None

    def register_reset_callbacks(self, callbacks):
        """Register callbacks run after every reset, e.g. to rescale the
        learning rate to the new world size."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        # rank and world size belong to one round: the state plane's writer
        # is stopped and made again at the next commit
        _ckpt.reset_plane()
        self._host_messages = queue.Queue()
        self.reset()
        for callback in self._reset_callbacks:
            callback()

    def on_hosts_updated(self, timestamp, update_res):
        self._host_messages.put((timestamp, update_res))

    def commit(self):
        """Save the state and raise :class:`HostsUpdatedInterrupt` if the
        host set changed. Committing copies device tensors to host memory,
        so committing less often trades speed against the steps a failure
        loses, as in the reference."""
        self._commits += 1
        # the chaos seam: `worker:crash:rank=R:at_step=N` exits rank R at
        # its N-th commit, and the membership actions start churn here
        _faults.inject("worker", rank=self._rank(), step=self._commits)
        _policy.note_commit()
        self.save()
        # the state plane's seam: with HVD_CKPT_DIR set, every
        # HVD_CKPT_INTERVAL-th committed tree goes to the background
        # writer here, after save() replaced the host copy
        _ckpt.note_commit(self)
        self.check_host_updates()

    def check_host_updates(self):
        """Raise :class:`HostsUpdatedInterrupt` when a host-change
        notification arrived; the same on every rank by rank 0's
        broadcast."""
        last_updated_timestamp = prev_timestamp = self._last_updated_timestamp
        all_update = HostUpdateResult.no_update
        while not self._host_messages.empty():
            timestamp, update = self._host_messages.get()
            if timestamp > last_updated_timestamp:
                last_updated_timestamp = timestamp
                all_update |= update

        prev_timestamp, self._last_updated_timestamp, all_update = \
            self._bcast_object(
                (prev_timestamp, last_updated_timestamp, all_update))

        if self._last_updated_timestamp > prev_timestamp:
            # removals only: the survivors hold the same state, so the sync
            # after the reset may be skipped; additions always sync
            raise HostsUpdatedInterrupt(
                skip_sync=(all_update == HostUpdateResult.removed))

    def save(self):
        """Save the state to host memory."""
        raise NotImplementedError()

    def restore(self):
        """Restore the last committed state, dropping what came after."""
        raise NotImplementedError()

    def sync(self):
        """Synchronize the state across workers (rank 0's)."""
        raise NotImplementedError()

    def reset(self):
        """Hook run at a reset, before the sync."""


class ObjectState(State):
    """State of plain picklable objects, kept as attributes (reference
    ``ObjectState``)."""

    def __init__(self, bcast_object, get_rank, **kwargs):
        self._saved_state = kwargs
        self._set_attrs()
        super().__init__(bcast_object=bcast_object, get_rank=get_rank)

    def save(self):
        self._saved_state = {attr: getattr(self, attr)
                             for attr in self._saved_state}

    def restore(self):
        self._set_attrs()

    def sync(self):
        if self._saved_state:
            self._saved_state = self._bcast_object(self._saved_state)
            self._set_attrs()

    def _set_attrs(self):
        for attr, value in self._saved_state.items():
            setattr(self, attr, value)


# ---------------------------------------------------------------------------
# TorchState: modules, optimizers and samplers
# ---------------------------------------------------------------------------

def _copy_in_place(live: dict, saved: dict) -> None:
    """Write the host leaves of ``saved`` into the tensors of ``live`` of
    the same keys, in place."""
    with torch.no_grad():
        for k, v in saved.items():
            t = live.get(k)
            if isinstance(t, torch.Tensor):
                t.copy_(_ckpt.from_host(v, t))


class _ModuleHandler:
    """A module's ``state_dict()``: host copies at commit, copied back into
    the parameters and buffers in place at restore, so they keep their
    addresses (a cached step's CUDA Graph reads them)."""

    def __init__(self, module: torch.nn.Module):
        self.value = module

    def host(self):
        return _ckpt.host_tree(dict(self.value.state_dict()))

    def load(self, saved) -> None:
        _copy_in_place(self.value.state_dict(), saved)


class _OptimizerHandler:
    """A torch optimizer's ``state_dict()`` (a ``DistributedOptimizer``'s
    wrapped one): host copies at commit; at restore each state tensor is
    written in place and the hyperparameters set, so the state keeps its
    addresses. An optimizer without state yet takes ``load_state_dict``."""

    def __init__(self, optimizer):
        self.value = optimizer

    @property
    def _opt(self):
        return getattr(self.value, "optimizer", self.value)

    def host(self):
        return _ckpt.host_tree(self._opt.state_dict())

    def load(self, saved) -> None:
        if hasattr(self.value, "abandon_pass"):  # a DistributedOptimizer
            self.value.abandon_pass()
        opt = self._opt
        params = [p for g in opt.param_groups for p in g["params"]]
        state = saved.get("state", {})
        if any(p not in opt.state for i, p in enumerate(params)
               if i in state):
            opt.load_state_dict(_ckpt.tensor_tree(saved))
            return
        for i, p in enumerate(params):
            if i in state:
                _copy_in_place(opt.state[p], state[i])
        for group, g_saved in zip(opt.param_groups,
                                  saved.get("param_groups", ())):
            group.update({k: v for k, v in g_saved.items()
                          if k != "params"})


class _SamplerHandler:
    """An ``ElasticSampler``: its ``state_dict()`` at commit, and
    ``load_state_dict`` at restore (which repartitions the rest of the
    epoch over the current world)."""

    def __init__(self, sampler):
        self.value = sampler

    def host(self):
        return dict(self.value.state_dict())

    def load(self, saved) -> None:
        self.value.load_state_dict(dict(saved))


def _handler_for(value):
    from ..optim import DistributedOptimizer
    from .sampler import ElasticSampler
    if isinstance(value, torch.nn.Module):
        return _ModuleHandler(value)
    if isinstance(value, (torch.optim.Optimizer, DistributedOptimizer)):
        return _OptimizerHandler(value)
    if isinstance(value, ElasticSampler):
        return _SamplerHandler(value)
    return None


class TorchState(ObjectState):
    """Elastic state of torch modules, optimizers and samplers, and of
    plain objects (the JAX package's ``JaxState``; reference Horovod's
    ``TorchState``).

    ``model``, ``optimizer``, ``sampler`` and any other keyword whose value
    is an ``nn.Module``, a torch optimizer (or ``DistributedOptimizer``) or
    an ``ElasticSampler`` get a handler: a commit copies their state to
    host numpy arrays, and a restore copies it back into the live tensors
    in place. Other keywords are plain attributes, as in
    :class:`ObjectState`. ``sync`` re-syncs a (re-)formed world: through
    the peer-restore protocol of ``checkpoint.py`` when
    ``HVD_CKPT_PEER_RESTORE`` is on and the world has more than one rank,
    else (and on any degradation, typed and metered) by rank 0's
    broadcast of its committed state.

    Usage::

        state = hvd.elastic.TorchState(model=model, optimizer=opt,
                                       sampler=sampler, epoch=0, batch=0)
        ...
        state.commit()
    """

    def __init__(self, model=None, optimizer=None, sampler=None, **kwargs):
        from .. import runtime
        from ..ops.collectives import broadcast_object
        self._handlers = {}
        plain = {}
        objects = dict(kwargs, model=model, optimizer=optimizer,
                       sampler=sampler)
        for name, value in objects.items():
            handler = None if value is None else _handler_for(value)
            if handler is not None:
                self._handlers[name] = handler
            elif value is not None or name in kwargs:
                plain[name] = value
        for name, handler in self._handlers.items():
            plain[name] = handler.value
        super().__init__(
            bcast_object=lambda obj: broadcast_object(obj, root_rank=0),
            get_rank=runtime.rank, **plain)
        self.save()

    def save(self):
        self._saved_state = {
            attr: (self._handlers[attr].host() if attr in self._handlers
                   else getattr(self, attr))
            for attr in self._saved_state}

    def _set_attrs(self):
        handlers = getattr(self, "_handlers", {})
        for attr, value in self._saved_state.items():
            if attr in handlers:
                if not isinstance(value, dict):  # the live object itself
                    setattr(self, attr, value)
                    continue
                handlers[attr].load(value)
                setattr(self, attr, handlers[attr].value)
            else:
                setattr(self, attr, value)

    def sync(self):
        """Re-sync the state across a (re-)formed world.

        With ``HVD_CKPT_PEER_RESTORE`` on (the default) in a world of more
        than one rank, every rank allgathers a fingerprint of its
        committed state, derives the same :class:`~..checkpoint.
        RestorePlan`, and the ranks that need the state pull their shards
        from the survivors: rank 0 serves only its share. Any degradation
        (too few consistent survivors, a structure that disagrees, pulls
        that failed over and failed again) takes rank 0's broadcast of the
        whole state, typed and metered, never silently."""
        if not self._saved_state:
            return
        from .. import conformance as _conformance
        from .. import runtime
        from ..ops.collectives import allgather_object
        t0 = time.monotonic()
        restored = False
        plan = None
        world = runtime.size() if runtime.is_initialized() else 1
        if world > 1 and _ckpt.peer_restore_active():
            me = runtime.rank()
            leaves, treedef = flatten(self._saved_state)
            blob = _ckpt.fingerprint_blob(me, self._commits, leaves,
                                          treedef)
            blobs = allgather_object(blob)
            plan = _ckpt.make_restore_plan(blobs, world=world)
            # lockstep by construction: every rank derives the plan from
            # the same allgathered fingerprints
            _conformance.record(
                "elastic/state.py::TorchState.sync", "manifest_agree",
                (plan.step, plan.survivors, plan.needy, plan.n_leaves,
                 plan.degraded_reason))
            if not plan.fresh:
                restored = self._peer_restore(plan, me, leaves, treedef)
        if not restored:
            # the reference's path: rank 0 broadcasts the whole state,
            # metered on each receiving rank
            if world > 1 and runtime.rank() != 0:
                _metrics.CKPT_RESTORE_BYTES.inc(
                    _ckpt.tree_nbytes(flatten(self._saved_state)[0]),
                    labels={"source": "rank0"})
            super().sync()
            # keep the commit counts aligned after a broadcast restore:
            # the snapshot trigger keys on them
            if plan is not None and not plan.fresh:
                self._commits = max(self._commits, plan.step)
        if world > 1:
            _metrics.CKPT_RESTORE_SECONDS.observe(time.monotonic() - t0)

    def _peer_restore(self, plan, me, leaves, treedef) -> bool:
        """This rank's side of the restore plan. True: the state is synced
        (from peer shards, or already agreed); False: the caller takes the
        broadcast."""
        from .. import conformance as _conformance
        from ..ops.collectives import allgather_object

        def _degraded(reason):
            _conformance.record(
                "elastic/state.py::TorchState._peer_restore",
                "restore_source", (plan.step, "degraded", reason))
            _metrics.CKPT_DEGRADED_RESTORES.inc(labels={"reason": reason})
            return False

        if plan.degraded_reason is not None:
            return _degraded(plan.degraded_reason)
        if not plan.needy:
            # every rank holds the committed step: skipping the broadcast
            # is the restore
            _conformance.record(
                "elastic/state.py::TorchState._peer_restore",
                "restore_source", (plan.step, "peer", 0))
            self._set_attrs()
            return True
        new_leaves, reason = _ckpt.run_peer_transfers(
            plan, me, leaves, allgather=allgather_object)
        if reason is not None:
            return _degraded(reason)
        _conformance.record(
            "elastic/state.py::TorchState._peer_restore",
            "restore_source", (plan.step, "peer", len(plan.needy)))
        if me in plan.needy:
            self._saved_state = unflatten(treedef, new_leaves,
                                          self._saved_state)
            self._commits = plan.step
        self._set_attrs()
        return True


def run_fn(func, reset):
    """Wrap ``func(state, ...)`` in the elastic recovery loop (reference
    ``run_fn``). Each recovery is measured: the re-form histogram spans
    the catch to the re-synced state, events are counted by kind, and a
    failure's restore counts its rolled-back step."""
    from .notification import get_notification_manager

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        notification_manager = get_notification_manager()
        notification_manager.init()
        notification_manager.register_listener(state)
        skip_sync = False
        t0 = None  # the start of the recovery in flight (None: training)
        try:
            while True:
                try:
                    # the sync after a reset runs inside this try: a second
                    # failure during it starts another recovery round
                    if not skip_sync:
                        state.sync()
                    if t0 is not None:
                        _metrics.ELASTIC_REFORM_SECONDS.observe(
                            time.monotonic() - t0)
                        t0 = None
                    return func(state, *args, **kwargs)
                except HorovodInternalError:
                    first = t0 is None
                    if first:
                        t0 = time.monotonic()
                    kind = "peer-failure"
                    state.restore()
                    skip_sync = False
                    # the step in flight rolls back to the last commit; a
                    # failure during the re-sync had none in flight
                    if first:
                        _metrics.ELASTIC_STEPS_LOST.inc()
                except HostsUpdatedInterrupt as e:
                    if t0 is None:
                        t0 = time.monotonic()
                    kind = "hosts-updated"
                    skip_sync = e.skip_sync
                    if skip_sync:
                        # removals only: the survivors' committed state is
                        # the same; the live state is set from it again
                        state.restore()

                _metrics.ELASTIC_EVENTS.inc(labels={"kind": kind})
                # what ended the world: a reset after a peer failure
                # aborts it instead of draining it
                state.last_recovery = kind
                reset()
                state.on_reset()
        finally:
            notification_manager.remove_listener(state)

    return wrapper
