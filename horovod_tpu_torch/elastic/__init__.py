"""Elastic training, the worker's side (port of ``horovod_tpu/elastic``).

The state a worker commits, restores and re-syncs across resets
(:class:`State`, :class:`ObjectState`, :class:`TorchState`), the recovery
loop (:func:`run_fn`), the elastic sampler, and the host-change
notification the driver sends over the KV store. The driver, the
rendezvous, host discovery, the autoscale policy and ``elastic.run`` (which
needs the rendezvous) are not ported yet.

    state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)
    state.register_reset_callbacks([rescale_lr])

    def train(state):
        for state.epoch in range(state.epoch, epochs):
            ...
            state.commit()

    hvd.elastic.run_fn(train, reset)(state)
"""

from __future__ import annotations

from ..exceptions import (HorovodInternalError, HostsUpdatedInterrupt,
                          wrap_internal_errors)
from .notification import (NOTIFY_KEY, WorkerNotificationManager,
                           notification_manager)
from .sampler import ElasticSampler
from .state import HostUpdateResult, ObjectState, State, TorchState, run_fn

__all__ = [
    "ElasticSampler", "HorovodInternalError", "HostUpdateResult",
    "HostsUpdatedInterrupt", "NOTIFY_KEY", "ObjectState", "State",
    "TorchState", "WorkerNotificationManager", "notification_manager",
    "run_fn", "wrap_internal_errors",
]
