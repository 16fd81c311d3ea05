"""Training-loop helpers: learning-rate schedules and metric averaging
(port of ``horovod_tpu/callbacks.py``).

Each of the reference's Keras callbacks maps to a plain function:

* ``LearningRateScheduleCallback``  -> :func:`lr_schedule`
* ``LearningRateWarmupCallback``    -> :func:`warmup_schedule`
* ``MetricAverageCallback``         -> :func:`metric_average` /
  :func:`average_metrics`
* ``BroadcastGlobalVariablesCallback`` -> ``hvd.broadcast_parameters``.

A schedule is ``fn(step) -> lr``, ``step`` counting the optimizer's updates
from 0. To drive a ``torch.optim`` optimizer with it, give
``torch.optim.lr_scheduler.LambdaLR`` the *wrapped* optimizer and a factor
of the optimizer's own ``lr``::

    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=initial_lr))
    sched = LambdaLR(opt.optimizer, lambda s: schedule(s) / initial_lr)
    ...; opt.step(); sched.step()

``LambdaLR(opt, ...)`` raises ``TypeError``: ``DistributedOptimizer`` is no
``torch.optim.Optimizer``.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch

from . import runtime
from .ops import collectives
from .ops.reduce_ops import ReduceOp


def lr_schedule(initial_lr: float, multiplier, *, steps_per_epoch: int,
                start_epoch: int = 0, end_epoch: int | None = None,
                staircase: bool = True) -> Callable[[int], float]:
    """Epoch-indexed learning-rate schedule (reference
    ``LearningRateScheduleCallbackImpl``).

    ``multiplier`` is ``fn(epoch) -> factor`` or a constant (then it decays
    exponentially: ``multiplier ** (epoch - start_epoch)``, matching the
    reference). ``staircase`` applies the multiplier per epoch; otherwise
    per step with a fractional epoch. Outside [start_epoch, end_epoch) the
    lr stays ``initial_lr``.
    """
    if not callable(multiplier):
        factor = float(multiplier)

        def multiplier(epoch):  # noqa: F811 - reference semantics
            return factor ** (epoch - start_epoch)

    def schedule(step):
        epoch = step / steps_per_epoch
        if staircase:
            epoch = math.floor(epoch)
        in_range = epoch >= start_epoch and (end_epoch is None
                                             or epoch < end_epoch)
        return initial_lr * multiplier(epoch) if in_range else initial_lr

    return schedule


def warmup_schedule(initial_lr: float, *, steps_per_epoch: int,
                    warmup_epochs: float = 5,
                    size: int | None = None) -> Callable[[int], float]:
    """Gradual learning-rate warmup (reference
    ``LearningRateWarmupCallbackImpl``, after Goyal et al. 2017): ramps
    linearly from ``initial_lr / size`` to ``initial_lr`` over
    ``warmup_epochs``. ``initial_lr`` is the already size-scaled target
    rate (``lr=base_lr * hvd.size()``); ``size`` defaults to the world's.
    """
    n = runtime.size() if size is None else size

    def multiplier(epoch):
        # the reference's fractional-epoch adjustment: the ramp ends
        # exactly on the epoch boundary
        epoch = epoch + 1.0 / steps_per_epoch
        return 1.0 / n * (epoch * (n - 1) / warmup_epochs + 1)

    return lr_schedule(initial_lr, multiplier,
                       steps_per_epoch=steps_per_epoch, start_epoch=0,
                       end_epoch=warmup_epochs, staircase=False)


def metric_average(value, name: str | None = None, *,
                   process_set=None) -> float:
    """Average a scalar metric over the ranks of ``process_set`` (default:
    all; the reference's per-metric ``hvd.allreduce`` inside
    ``MetricAverageCallbackImpl``), as float32 on this rank's device."""
    t = torch.tensor(float(value), dtype=torch.float32,
                     device=runtime.device())
    return float(collectives.allreduce(t, op=ReduceOp.AVERAGE, name=name,
                                       process_set=process_set))


def average_metrics(logs: Mapping, *, process_set=None) -> dict:
    """Average every value of a metrics dict across the ranks of
    ``process_set``, in sorted key order so that every rank issues the same
    collectives (reference ``_average_metrics_in_place``)."""
    return {k: metric_average(v, name=f"metric.{k}",
                              process_set=process_set)
            for k, v in sorted(logs.items())}
