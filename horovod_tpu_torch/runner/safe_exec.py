"""Process-tree-safe command execution (port of
``horovod_tpu/runner/safe_exec.py``): run a worker command in its own
session, stream its output with a per-rank prefix, and make sure the whole
process tree dies with the launcher.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

GRACEFUL_TERMINATION_TIME_S = 5


def _kill_tree(pid: int, sig: int) -> None:
    """Signal a process and all its descendants."""
    try:
        import psutil
        try:
            root = psutil.Process(pid)
            # children() re-reads /proc; the root can exit between the
            # Process() lookup and here, raising NoSuchProcess from either
            # call — treat both as "tree already gone".
            procs = [root] + root.children(recursive=True)
        except psutil.NoSuchProcess:
            return
        for p in procs:
            try:
                p.send_signal(sig)
            except psutil.NoSuchProcess:
                pass
    except ImportError:  # pragma: no cover
        try:
            os.killpg(os.getpgid(pid), sig)
        except (ProcessLookupError, PermissionError):
            pass


def terminate_tree(pid: int) -> None:
    """SIGTERM the tree, escalate to SIGKILL after a grace period."""
    _kill_tree(pid, signal.SIGTERM)
    deadline = time.monotonic() + GRACEFUL_TERMINATION_TIME_S
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        # kill-escalation probe, not an RPC retry: there is no server to
        # back off from and the grace window is short and local
        time.sleep(0.1)
    _kill_tree(pid, signal.SIGKILL)


def _pump(stream, sink, prefix: str, index: int | None,
          prefix_output: bool) -> None:
    try:
        for raw in iter(stream.readline, b""):
            line = raw.decode(errors="replace")
            if prefix_output and index is not None:
                sink.write(f"[{index}]<{prefix}>:{line}")
            else:
                sink.write(line)
            sink.flush()
    except ValueError:
        pass  # sink force-closed during teardown; drop the tail
    finally:
        stream.close()


class ExecutedProcess:
    """Handle to a spawned worker command."""

    def __init__(self, proc: subprocess.Popen, pumps: list[threading.Thread],
                 owned_files: list | None = None):
        self.proc = proc
        self._pumps = pumps
        self._owned_files = owned_files or []

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _close_owned(self, blocking: bool = True) -> None:
        # Once the process is dead the pipes hit EOF and the pumps finish on
        # their own; the timeout is just a backstop. Only close the sink
        # files once every pump that writes to them has exited, so a slow
        # drain can't race a closed file.
        deadline = time.monotonic() + (30.0 if blocking else 0.0)
        for t in self._pumps:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._pumps):
            return  # keep files open; retry on the next wait()/poll()
        for f in self._owned_files:
            try:
                f.close()
            except OSError:
                pass
        self._owned_files = []

    def wait(self, timeout: float | None = None) -> int:
        code = self.proc.wait(timeout)
        self._close_owned()
        return code

    def poll(self) -> int | None:
        # poll() is conventionally non-blocking and is looped over in
        # teardown paths (driver round transitions hold locks there) — never
        # wait on the pump threads here; wait()/terminate() do the blocking
        # join.
        code = self.proc.poll()
        if code is not None:
            self._close_owned(blocking=False)
        return code

    def terminate(self) -> None:
        terminate_tree(self.proc.pid)
        self._close_owned()


def execute(command: str | list[str], env: dict | None = None,
            index: int | None = None, prefix_output: bool = True,
            stdout=None, stderr=None, shell: bool | None = None,
            stdin_data: bytes | None = None,
            owned_files: list | None = None) -> ExecutedProcess:
    """Spawn ``command`` in a new session with piped, prefix-tagged
    output. ``stdin_data`` is written to the child's stdin, which is then
    closed: it hands secrets to remote workers without putting them in
    argv."""
    if shell is None:
        shell = isinstance(command, str)
    proc = subprocess.Popen(
        command, shell=shell, env=env,
        stdin=subprocess.PIPE if stdin_data is not None else subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    if stdin_data is not None:
        try:
            proc.stdin.write(stdin_data)
            proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass  # child died before reading; its exit code tells the story
    pumps = [
        threading.Thread(
            target=_pump,
            args=(proc.stdout, stdout or sys.stdout, "stdout", index, prefix_output),
            daemon=True),
        threading.Thread(
            target=_pump,
            args=(proc.stderr, stderr or sys.stderr, "stderr", index, prefix_output),
            daemon=True),
    ]
    for t in pumps:
        t.start()
    return ExecutedProcess(proc, pumps, owned_files)


def run(command: str | list[str], env: dict | None = None,
        index: int | None = None, **kw) -> int:
    """Execute and wait; on KeyboardInterrupt tear down the tree."""
    p = execute(command, env=env, index=index, **kw)
    try:
        return p.wait()
    except KeyboardInterrupt:
        p.terminate()
        raise
