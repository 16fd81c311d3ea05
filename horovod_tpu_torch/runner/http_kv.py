"""Threaded HTTP key-value store (port of ``horovod_tpu/runner/http_kv.py``).

The launcher starts a :class:`KVServer` and hands its address to the
workers (``HVD_KV_ADDR``, ``HVD_KV_PORT``, ``HVD_SECRET_KEY``); the
negotiation service (``engine_service.py``) exchanges each cycle's requests
through a :class:`KVClient`. Every request is HMAC-signed with the job's
secret over its method, key path and payload, so a captured message cannot
be replayed against another key or verb. The client retries transport
failures and transient HTTP statuses (``utils/retry.py``); a bad signature
(403) or a missing key (404) is an answer, not a failure.

``GET /__gather__/<scope>?count=N&timeout=S`` is the long-poll that one
negotiation round costs each member: it blocks until N keys exist under
the scope and returns them framed, with each key's receipt time on the
server's clock.

``GET /metrics`` answers with this process's metrics registry in
Prometheus text (``metrics.py``), unsigned, as the reference serves it: a
scraper cannot sign, and the payload is counters, never a stored value.
Each client request counts in ``hvd_kv_ops_total{op=...}`` and passes the
fault-injection point ``kv.<op>`` (``put``, ``get``, ``delete``,
``gather``), whose injected faults retry as transport failures do.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import http.server
import json
import os
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import parse_qs, urlparse

from .. import metrics as _metrics
from ..utils import faults as _faults
from ..utils import logging as hvd_logging
from ..utils import retry as _retry

SECRET_ENV = "HVD_SECRET_KEY"
_SIG_HEADER = "X-HVD-Signature"
# HTTP statuses worth retrying: server-side wait expiry, throttling,
# transient 5xx
_TRANSIENT_HTTP = (408, 425, 429, 500, 502, 503, 504)
DEFAULT_TIMEOUT_S = 30.0  # per request (reference HVD_GLOO_TIMEOUT_SECONDS)


def _transient_kv_error(exc: BaseException) -> bool:
    """Connection failures, transient HTTP statuses and injected faults
    are retried; semantic answers (404, a refused signature) are not."""
    if isinstance(exc, _faults.FaultInjected):
        return True
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in _TRANSIENT_HTTP
    return isinstance(exc, (urllib.error.URLError, ConnectionError,
                            TimeoutError, socket.timeout,
                            http.client.HTTPException))


def make_secret() -> str:
    return os.urandom(16).hex()


def _sign(secret: str, method: str, path: str, payload: bytes) -> str:
    msg = method.encode() + b"\0" + path.encode() + b"\0" + payload
    return hmac.new(secret.encode(), msg, hashlib.sha256).hexdigest()


class KVHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # no stderr line per request
        pass

    def _key(self):
        return self.path.lstrip("/")

    def _verify(self, method: str, payload: bytes) -> bool:
        secret = self.server.secret
        if secret is None:
            return True
        sig = self.headers.get(_SIG_HEADER, "")
        return hmac.compare_digest(
            sig, _sign(secret, method, self.path, payload))

    def _reply(self, status: int, body: bytes = b"") -> None:
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_GET(self):
        if self.path.rstrip("/") == "/metrics":
            _metrics.write_prometheus(self)
            return
        if not self._verify("GET", b""):
            self._reply(403)
            return
        store = self.server.store
        key = self._key()
        if key.startswith("__gather__/"):
            self._gather(store, key)
            return
        with self.server.lock:
            if key.endswith("/") or key == "":  # scope listing
                scope = key.rstrip("/")
                prefix = scope + "/" if scope else ""
                body = json.dumps(sorted(
                    k for k in store if k.startswith(prefix))).encode()
            elif key in store:
                body = store[key]
            else:
                body = None
        self._reply(404) if body is None else self._reply(200, body)

    def _gather(self, store, key):
        """Block until ``count`` keys exist under the scope (at most
        ``timeout`` s, else 408: the client asks again), then return them
        sorted: u32 count, per entry u32 klen + key + u32 vlen + value,
        then one f64 server receipt time per entry in the same order."""
        parsed = urlparse(key)
        scope = parsed.path[len("__gather__/"):].rstrip("/")
        q = parse_qs(parsed.query)
        count = int(q.get("count", ["1"])[0])
        timeout = min(float(q.get("timeout", ["30"])[0]), 60.0)
        prefix = scope + "/" if scope else ""
        cond, times = self.server.lock, self.server.times
        with cond:  # woken by every PUT, no poll loop
            if not cond.wait_for(
                    lambda: sum(k.startswith(prefix) for k in store) >= count,
                    timeout=timeout):
                body = None
            else:
                keys = sorted(k for k in store if k.startswith(prefix))
                parts = [struct.pack("<I", len(keys))]
                for k in keys:
                    kb, v = k.encode(), store[k]
                    parts.append(struct.pack("<I", len(kb)) + kb
                                 + struct.pack("<I", len(v)) + v)
                parts.extend(struct.pack("<d", times.get(k, 0.0))
                             for k in keys)
                body = b"".join(parts)
        self._reply(408) if body is None else self._reply(200, body)

    def do_PUT(self):
        payload = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if not self._verify("PUT", payload):
            self._reply(403)
            return
        key = self._key()
        with self.server.lock:
            self.server.store[key] = payload
            self.server.times[key] = time.monotonic()
            self.server.lock.notify_all()  # wake the parked gathers
        observer = self.server.on_put
        if observer is not None:
            try:
                observer(key, payload)
            except Exception:
                # the store keeps working, but a driver that never learns
                # of a worker's record looks like a hang: say so
                hvd_logging.exception("KV PUT observer failed for key %r",
                                      key)
        self._reply(200)

    def do_DELETE(self):
        if not self._verify("DELETE", b""):
            self._reply(403)
            return
        _delete(self.server, self._key())
        self._reply(200)


def _delete(server, key: str) -> None:
    """Drop ``key`` and every key under it as a scope."""
    with server.lock:
        for k in [k for k in server.store
                  if k == key or k.startswith(key.rstrip("/") + "/")]:
            del server.store[k]
            server.times.pop(k, None)


class _ThreadedHTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class KVServer:
    """In-memory scoped KV store served over HTTP (reference
    ``RendezvousServer``). :meth:`start` binds a port (0: the OS picks
    one); share ``port`` and ``secret`` with the workers. ``on_put(key,
    payload)``, where given, sees every PUT a worker makes (the elastic
    driver's readiness, completion and failure records)."""

    def __init__(self, secret: str | None = None, host: str = "0.0.0.0",
                 on_put=None):
        self.secret = secret
        self.host = host
        self.on_put = on_put
        self._httpd: _ThreadedHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self, port: int = 0) -> int:
        httpd = _ThreadedHTTPServer((self.host, port), KVHandler)
        httpd.store, httpd.times = {}, {}
        httpd.lock = threading.Condition()
        httpd.secret = self.secret
        httpd.on_put = self.on_put
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, daemon=True, name="hvd-kv-server")
        self._thread.start()
        return self.port

    @property
    def port(self) -> int:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_address[1]

    def put(self, key: str, value: bytes) -> None:
        with self._httpd.lock:
            self._httpd.store[key] = value
            self._httpd.times[key] = time.monotonic()
            self._httpd.lock.notify_all()

    def get(self, key: str) -> bytes | None:
        with self._httpd.lock:
            return self._httpd.store.get(key)

    def keys(self, scope: str = "") -> list[str]:
        prefix = scope.rstrip("/") + "/" if scope else ""
        with self._httpd.lock:
            return sorted(k for k in self._httpd.store
                          if k.startswith(prefix))

    def delete(self, key: str) -> None:
        _delete(self._httpd, key)

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class KVClient:
    """HTTP client of :class:`KVServer` (reference ``http_client.py``);
    every verb retries transient failures (``utils/retry.py``)."""

    def __init__(self, addr: str, port: int, secret: str | None = None,
                 timeout: float = DEFAULT_TIMEOUT_S):
        self._base = f"http://{addr}:{port}"
        self._secret = secret
        self._timeout = timeout

    def _read(self, method: str, path: str, payload: bytes = b"",
              timeout: float | None = None) -> bytes:
        op = "gather" if path.startswith("/__gather__/") else method.lower()
        _faults.inject(f"kv.{op}")
        # one sample a server round trip (a retry is another): over
        # hvd_negotiation_rounds_total, the KV operations a round
        _metrics.KV_OPS.inc(labels={"op": op})
        req = urllib.request.Request(
            f"{self._base}{path}", data=payload if method == "PUT" else None,
            method=method)
        if self._secret is not None:
            req.add_header(_SIG_HEADER,
                           _sign(self._secret, method, path, payload))
        # the request and the body read in one attempt: a connection
        # dying mid-read retries the whole exchange
        with urllib.request.urlopen(
                req, timeout=self._timeout if timeout is None
                else timeout) as resp:
            return resp.read()

    def _call(self, what: str, fn):
        return _retry.call(fn, what=what, retry_on=_transient_kv_error)

    def put(self, key: str, value: bytes) -> None:
        self._call("kv.put", lambda: self._read("PUT", f"/{key}", value))

    def get(self, key: str) -> bytes | None:
        try:
            return self._call("kv.get", lambda: self._read("GET", f"/{key}"))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def keys(self, scope: str = "") -> list[str]:
        return json.loads(self._call(
            "kv.keys", lambda: self._read("GET", f"/{scope.rstrip('/')}/")))

    def delete(self, key: str) -> None:
        self._call("kv.delete", lambda: self._read("DELETE", f"/{key}"))

    def wait(self, key: str, timeout: float = 60.0,
             poll_interval: float = 0.1) -> bytes:
        """Block until ``key`` appears, polling with a jittered backoff."""
        val = self.get(key)
        if val is not None:
            return val
        for _ in _retry.poll_intervals("kv.wait", interval_s=poll_interval,
                                       deadline_s=timeout):
            val = self.get(key)
            if val is not None:
                return val
        raise TimeoutError(f"KV key {key!r} not set within {timeout}s")

    def gather(self, scope: str, count: int, timeout: float = 60.0,
               with_times: bool = False):
        """The ``count`` keys under ``scope``, in one server-side long-poll:
        ``{key: value}``, and with ``with_times`` also ``{key: server
        receipt seconds}``."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"KV gather {scope!r} did not reach {count} keys "
                    f"within {timeout}s")
            wait = max(min(remaining, 25.0), 0.05)
            path = (f"/__gather__/{scope.rstrip('/')}"
                    f"?count={count}&timeout={wait}")
            try:
                # 408 is the long-poll's own "not yet": ask again at once
                data = _retry.call(
                    lambda: self._read("GET", path, timeout=wait + 10.0),
                    what="kv.gather", deadline_s=remaining,
                    retry_on=lambda e: _transient_kv_error(e) and not (
                        isinstance(e, urllib.error.HTTPError)
                        and e.code == 408))
            except urllib.error.HTTPError as e:
                if e.code == 408:
                    continue
                raise
            out, keys = {}, []
            (n,) = struct.unpack_from("<I", data, 0)
            pos = 4
            for _ in range(n):
                (klen,) = struct.unpack_from("<I", data, pos)
                k = data[pos + 4:pos + 4 + klen].decode()
                pos += 4 + klen
                (vlen,) = struct.unpack_from("<I", data, pos)
                out[k] = data[pos + 4:pos + 4 + vlen]
                pos += 4 + vlen
                keys.append(k)
            if not with_times:
                return out
            times = {k: struct.unpack_from("<d", data, pos + 8 * i)[0]
                     for i, k in enumerate(keys)}
            return out, times


def local_addresses() -> list[str]:
    """This host's IPv4 addresses, routable ones first and ``127.0.0.1``
    last: from the interfaces where ``psutil`` is installed, else the
    address the host's own name resolves to. Nothing is sent anywhere."""
    addrs: list[str] = []
    try:
        import psutil
        for nics in psutil.net_if_addrs().values():
            for a in nics:
                if a.family == socket.AF_INET and \
                        not a.address.startswith("127."):
                    addrs.append(a.address)
    except ImportError:
        pass
    try:
        own = socket.gethostbyname(socket.gethostname())
        if not own.startswith("127.") and own not in addrs:
            addrs.append(own)
    except OSError:
        pass
    addrs.append("127.0.0.1")
    return addrs
