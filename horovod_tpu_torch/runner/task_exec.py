"""The worker's side of :func:`horovod_tpu_torch.runner.run` (port of
``horovod_tpu/runner/task_exec.py``): fetch the pickled function from the
launcher's KV store, run it, and put this rank's result back.

Run as ``python -m horovod_tpu_torch.runner.task_exec`` by the launcher.
"""

from __future__ import annotations

import sys
import traceback

from ..utils import envs
from .http_kv import KVClient


def main() -> int:
    import cloudpickle

    rank = int(envs.require(envs.RANK))
    client = KVClient(envs.require(envs.KV_ADDR),
                      int(envs.require(envs.KV_PORT)),
                      secret=envs.get(envs.SECRET_KEY))
    startup_timeout = envs.get_float(envs.START_TIMEOUT, 600.0)
    fn, args, kwargs = cloudpickle.loads(
        client.wait("exec/fn", timeout=startup_timeout))
    try:
        result = fn(*args, **kwargs)
        payload = cloudpickle.dumps(("ok", result))
    except BaseException:
        payload = cloudpickle.dumps(("error", traceback.format_exc()))
        client.put(f"exec/result/{rank}", payload)
        return 1
    client.put(f"exec/result/{rank}", payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
