"""Reduction-op enums and scaling semantics (port of
``horovod_tpu/ops/reduce_ops.py``)."""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Horovod-style module constants.
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def handle_average(op: ReduceOp, size: int,
                   postscale_factor: float) -> tuple[ReduceOp, float]:
    """Lower AVERAGE to SUM + postscale (reference operations.cc:1408-1416)."""
    if op == ReduceOp.AVERAGE:
        return ReduceOp.SUM, postscale_factor / size
    return op, postscale_factor
