"""Spark integration: the ranks of a job as barrier-mode Spark tasks (port
of ``horovod_tpu/spark/__init__.py``).

Reference Horovod's ``horovod.spark.run()``, over Spark's own primitives:

* **Placement** by barrier scheduling (``RDD.barrier().mapPartitions``):
  all ``num_proc`` tasks start together or not at all.
* **Address exchange** by one ``BarrierTaskContext.allGather`` round:
  every task shares its IP, and rank 0 a free port for its ``TCPStore``.
* **Rendezvous** over the launcher's signed KV server on the Spark driver
  and the launcher's worker contract (``runner.launch.worker_env``), as
  under ``python -m horovod_tpu_torch.runner.launch`` and Ray::

    import horovod_tpu_torch.spark

    results = horovod_tpu_torch.spark.run(train_fn, args=(cfg,),
                                          num_proc=4)

A task drives the GPU that Spark's resource scheduling gave it, where it
gave one (``HVD_CUDA_DEVICE``), else the card of its slot's ``local_rank``
on its machine: Spark has no launcher-side card pool. The
estimator's role (train from data, checkpoints in a Store, resume) is
:mod:`horovod_tpu_torch.spark.estimator`: :func:`fit`,
:func:`fit_dataframe`, :func:`save_dataset`. pyspark is imported by
:func:`run`, not by this module.
"""

from __future__ import annotations

import functools
import json
import os
import queue
import threading
import time
from typing import Any, Callable

from ..runner import hosts as hosts_mod
from ..runner.http_kv import KVServer, local_addresses, make_secret
from ..runner.launch import _free_port, worker_env
from ..utils import envs

DEFAULT_START_TIMEOUT_S = 600.0
_REGISTER_SCOPE = "spark/registered"


def _task_card(ctx, local_rank: int) -> int:
    """A task's card: the first GPU address Spark's resource scheduling
    gave the task (``spark.task.resource.gpu.amount``; Spark leaves
    ``CUDA_VISIBLE_DEVICES`` alone, so an address is the machine's own
    ordinal), else its slot's ``local_rank``."""
    resources = getattr(ctx, "resources", None)
    gpu = (resources() or {}).get("gpu") if resources is not None else None
    if gpu is not None and gpu.addresses:
        return int(gpu.addresses[0])
    return local_rank


def _task_body(fn, args, kwargs, secret, kv_addr, kv_port, extra_env):
    """One barrier task: exchange placement, seed the launcher's contract,
    run the user's function as this rank."""
    from pyspark import BarrierTaskContext

    from ..runner.http_kv import KVClient

    ctx = BarrierTaskContext.get()
    rank = ctx.partitionId()

    import socket
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((kv_addr, int(kv_port)))
            my_ip = s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        my_ip = socket.gethostbyname(socket.gethostname())

    # one allGather round: every task's IP and rank 0's TCPStore port
    coord_port = _free_port() if rank == 0 else 0
    entries = [json.loads(e) for e in ctx.allGather(
        json.dumps({"rank": rank, "ip": my_ip, "coord_port": coord_port}))]
    entries.sort(key=lambda e: e["rank"])
    ips = [e["ip"] for e in entries]
    slots = hosts_mod.slots_from_ips(ips)

    env = worker_env(slots[rank], coordinator_addr=ips[0],
                     coordinator_port=entries[0]["coord_port"],
                     kv_addr=kv_addr, kv_port=kv_port, secret=secret,
                     extra=extra_env,
                     card=_task_card(ctx, slots[rank].local_rank))
    os.environ.update(env)
    # once every rank reported in, the driver stops counting against
    # start_timeout: it bounds the start, never the training
    KVClient(kv_addr, int(kv_port), secret=secret).put(
        f"{_REGISTER_SCOPE}/{rank}", b"1")
    return [(rank, fn(*args, **(kwargs or {})))]


def run(fn: Callable, args=(), kwargs: dict | None = None,
        num_proc: int | None = None, start_timeout: float | None = None,
        env: dict | None = None, verbose: int = 1) -> list:
    """Run ``fn(*args, **kwargs)`` as ``num_proc`` ranks on Spark's
    executors; the results in rank order (reference ``horovod.spark.run``).

    ``num_proc`` defaults to ``spark.default.parallelism``;
    ``start_timeout`` (or ``HVD_SPARK_START_TIMEOUT``) bounds how long the
    barrier tasks may take to start, and ``env`` adds variables to every
    rank's environment.
    """
    import pyspark

    sc = pyspark.SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError(
            "horovod_tpu_torch.spark.run() needs an active SparkContext: "
            "start a SparkSession first")
    if num_proc is None:
        num_proc = sc.defaultParallelism
    num_proc = int(num_proc)
    if start_timeout is None:
        start_timeout = envs.get_float(envs.SPARK_START_TIMEOUT,
                                       DEFAULT_START_TIMEOUT_S)

    secret = make_secret()
    kv = KVServer(secret=secret)
    kv_port = kv.start()
    kv_addr = local_addresses()[0]
    extra_env = dict(env or {})

    task = _make_task(fn, tuple(args), kwargs, secret, kv_addr, kv_port,
                      extra_env)
    result_q: queue.Queue = queue.Queue(1)
    group = f"horovod_tpu_torch.spark.run.{os.getpid()}.{id(task):x}"

    def _drive():
        try:
            sc.setJobGroup(group, "horovod_tpu_torch.spark.run",
                           interruptOnCancel=True)
            rdd = sc.parallelize(range(num_proc), num_proc)
            result_q.put(("ok", rdd.barrier().mapPartitions(task).collect()))
        except BaseException as e:  # raised on the caller's thread
            result_q.put(("error", e))

    thread = threading.Thread(target=_drive, daemon=True,
                              name="hvd-spark-driver")
    thread.start()
    try:
        # the start, bounded by start_timeout: every task registers over
        # the KV store; then the training, unbounded
        deadline = time.monotonic() + start_timeout
        status = payload = None
        while len(kv.keys(_REGISTER_SCOPE)) < num_proc:
            try:
                status, payload = result_q.get(timeout=0.2)
                break  # collect() ended (or failed) before registration
            except queue.Empty:
                pass
            if time.monotonic() > deadline:
                try:
                    sc.cancelJobGroup(group)
                except Exception:
                    pass  # the TimeoutError below is the signal
                raise TimeoutError(
                    f"horovod_tpu_torch.spark.run timed out after "
                    f"{start_timeout}s waiting for {num_proc} barrier tasks "
                    "to start; check that the cluster has enough "
                    "simultaneous slots (barrier mode schedules "
                    "all-or-nothing) or raise "
                    "start_timeout/HVD_SPARK_START_TIMEOUT")
        if status is None:
            status, payload = result_q.get()
        if status == "error":
            raise payload
        pairs = sorted(payload, key=lambda rv: rv[0])
        if [r for r, _ in pairs] != list(range(num_proc)):
            raise RuntimeError(
                f"spark run returned ranks {[r for r, _ in pairs]}, "
                f"expected 0..{num_proc - 1}")
        return [v for _, v in pairs]
    finally:
        # a cancelled job's tasks may still sit in collect(): give them a
        # moment to unwind before the KV server goes
        thread.join(timeout=10.0)
        kv.stop()


def _run_task(fn, args, kwargs, secret, kv_addr, kv_port, extra_env,
              _iterator) -> Any:
    return _task_body(fn, args, kwargs, secret, kv_addr, kv_port, extra_env)


def _make_task(fn, args, kwargs, secret, kv_addr, kv_port, extra_env):
    """The ``mapPartitions`` function: a partial of a module-level
    function, so that a task process unpickles it by name."""
    return functools.partial(_run_task, fn, args, kwargs, secret, kv_addr,
                             kv_port, extra_env)


from .estimator import fit, fit_dataframe, save_dataset  # noqa: E402
