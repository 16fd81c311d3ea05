"""Elastic training (port of ``horovod_tpu/elastic``).

The worker's side: state that commits, restores and re-syncs across
resets (:class:`State`, :class:`ObjectState`, :class:`TorchState`), the
recovery loop (:func:`run_fn`, and :func:`run`, which re-forms the world
through the driver's rounds), the elastic sampler and the host-change
notification. The driver's side: :class:`ElasticDriver` with its
rendezvous, host discovery and worker registry, started by the launcher's
``--min-np``/``--max-np``/``--host-discovery-script`` branch::

    hvd.init()
    state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)
    state.register_reset_callbacks([rescale_lr])

    @hvd.elastic.run
    def train(state):
        for state.epoch in range(state.epoch, epochs):
            ...
            state.commit()

    train(state)

    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \
        --host-discovery-script ./discover.sh -- python train.py

With ``HVD_AUTOSCALE=1`` the launcher also starts the closed-loop
:class:`AutoscalePolicy` (``policy.py``), which scales the world from the
step times and straggler blames the workers' commits report.
"""

from __future__ import annotations

from ..exceptions import (HorovodInternalError, HostsUpdatedInterrupt,
                          wrap_internal_errors)
from .discovery import (FixedHosts, HostDiscovery, HostDiscoveryScript,
                        HostManager)
from .driver import ElasticDriver, ElasticRendezvous, Results
from .notification import (NOTIFY_KEY, WorkerNotificationManager,
                           notification_manager)
from .policy import AutoscalePolicy, PolicyEvalError
from .registration import WorkerStateRegistry
from .sampler import ElasticSampler
from .state import HostUpdateResult, ObjectState, State, TorchState, run_fn


def run(func):
    """Decorator running ``func(state, ...)`` under elastic recovery
    (reference ``hvd.elastic.run``): on :class:`HostsUpdatedInterrupt` the
    worker re-forms its world into the driver's new round and syncs the
    state; on :class:`HorovodInternalError` it restores the last commit
    first, and the re-form aborts the failed world. Outside an elastic
    launch it runs ``func`` under the same recovery loop without the
    rounds."""
    from .rendezvous import get_worker_rendezvous

    def entry(state, *args, **kwargs):
        try:
            rdv = get_worker_rendezvous()
        except RuntimeError:
            rdv = None  # not an elastic launch: no rounds to follow

        def reset():
            if rdv is not None:
                rdv.reset(failed=state.last_recovery == "peer-failure")

        if rdv is not None:
            from ..utils import faults as _faults
            from .discovery import KVChurnRelay
            if _faults.has_membership_rules():
                _faults.set_membership_handler(
                    KVChurnRelay(rdv.kv, rdv.hostname))
            # a worker spawned for round R ignores the notification that
            # announced R: it is a member already
            from .notification import get_notification_manager
            manager = get_notification_manager()
            manager.register_listener(state)
            manager.mark_round_joined(rdv.round)
            rdv.record_ready()
        result = run_fn(wrap_internal_errors(func), reset)(
            state, *args, **kwargs)
        if rdv is not None:
            rdv.record_done()
        return result

    return entry


__all__ = [
    "AutoscalePolicy", "ElasticDriver", "ElasticRendezvous",
    "ElasticSampler", "FixedHosts", "HorovodInternalError", "HostDiscovery",
    "HostDiscoveryScript", "HostManager", "HostUpdateResult",
    "HostsUpdatedInterrupt", "NOTIFY_KEY", "ObjectState", "PolicyEvalError",
    "Results", "State", "TorchState", "WorkerNotificationManager",
    "WorkerStateRegistry", "notification_manager", "run", "run_fn",
    "wrap_internal_errors",
]
