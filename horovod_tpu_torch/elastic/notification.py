"""Worker-side host-change notification (port of
``horovod_tpu/elastic/notification.py``).

The reference's ``WorkerNotificationManager`` (``horovod/runner/elastic/
worker.py``) runs a server in every worker that the driver pushes to; here,
as in the JAX package, workers poll the launcher's KV store for the
``elastic/notify`` key (:data:`NOTIFY_KEY`, which the elastic driver
writes), and ``State.check_host_updates`` makes the decision the same on
every rank by rank 0's broadcast.
"""

from __future__ import annotations

import pickle
import threading

from ..utils import envs
from ..utils import logging as hvd_logging
from .driver import NOTIFY_KEY  # the driver writes (round, HostUpdateResult)
from .state import HostUpdateResult

POLL_INTERVAL_S = 0.5


class WorkerNotificationManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._listeners = set()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._client = None
        self._last_timestamp = 0

    def init(self, kv_client=None):
        """Start the poll thread (once). Without a KV store (a job without
        the elastic launcher) it does nothing, as the reference returns
        early without a rendezvous address."""
        with self._lock:
            if self._thread is not None:
                return
            if kv_client is None:
                addr = envs.get(envs.KV_ADDR)
                if not addr:
                    return
                from ..runner.http_kv import KVClient
                kv_client = KVClient(addr, envs.get_int(envs.KV_PORT, 0),
                                     secret=envs.get(envs.SECRET_KEY))
            self._client = kv_client
            self._stop.clear()
            from ..utils import invariants as _inv
            self._thread = _inv.spawn_thread(
                self._poll_loop, name="hvd-elastic-notify")

    def register_listener(self, listener):
        with self._lock:
            self._listeners.add(listener)

    def mark_round_joined(self, round_id: int) -> None:
        """Suppress the notifications of rounds this worker has joined: the
        notification that announced round R is stale once the worker is in
        R, and would interrupt it for a round R+1 that never comes."""
        with self._lock:
            if round_id > self._last_timestamp:
                self._last_timestamp = round_id
            for listener in self._listeners:
                if round_id > getattr(listener, "_last_updated_timestamp", 0):
                    listener._last_updated_timestamp = round_id

    def remove_listener(self, listener):
        with self._lock:
            self._listeners.discard(listener)

    def shutdown(self):
        with self._lock:
            self._stop.set()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2 * POLL_INTERVAL_S)

    def _poll_loop(self):
        while not self._stop.wait(POLL_INTERVAL_S):
            try:
                raw = self._client.get(NOTIFY_KEY)
            except Exception as e:  # the launcher is gone: keep quiet
                hvd_logging.debug("elastic notify poll failed: %s", e)
                continue
            if raw is None:
                continue
            try:
                timestamp, update_res = pickle.loads(raw)
            except Exception:
                continue
            if timestamp <= self._last_timestamp:
                continue
            self._last_timestamp = timestamp
            with self._lock:
                listeners = list(self._listeners)
            for listener in listeners:
                listener.on_hosts_updated(timestamp,
                                          HostUpdateResult(update_res))


notification_manager = WorkerNotificationManager()


def get_notification_manager() -> WorkerNotificationManager:
    """The process's notification manager (a process is a rank)."""
    return notification_manager
