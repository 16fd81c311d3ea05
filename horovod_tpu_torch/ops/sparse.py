"""Sparse (indexed-rows) gradient reduction (port of
``horovod_tpu/ops/sparse.py``).

An embedding's gradient touches only the rows of the tokens seen. Instead
of allreducing the whole ``(num_rows, dim)`` table, the rows are picked out
(:func:`rows_from_dense`: the ``max_rows`` rows of highest L1 activity, an
exact pick when at most ``max_rows`` rows are nonzero), their values and
indices allgathered over the process set (:func:`sparse_allreduce`, the
reference Horovod's IndexedSlices path), and scattered back with duplicates
summed (:func:`rows_to_dense`). The wire carries ``size * max_rows * dim``
values, not the table. ``HVD_SPARSE_AS_DENSE=1`` sends the dense gradient
through a plain allreduce instead (:func:`sparse_allreduce_to_dense`).
"""

from __future__ import annotations

import typing

import torch

from ..process_sets import _resolve
from ..utils import envs
from . import collectives
from .reduce_ops import ReduceOp


class SparseRows(typing.NamedTuple):
    """A bounded indexed-rows gradient: ``values[i]`` is the gradient of
    row ``indices[i]`` of a ``(num_rows, dim)`` parameter. Duplicate
    indices sum."""

    values: torch.Tensor   # (k, dim)
    indices: torch.Tensor  # (k,) int32
    num_rows: int


def rows_from_dense(grad: torch.Tensor, max_rows: int) -> SparseRows:
    """The ``max_rows`` rows of a 2-D gradient with the largest L1 norm,
    ties to the lower index (as ``lax.top_k`` breaks them), with int32
    indices."""
    if grad.dim() != 2:
        raise ValueError(f"rows_from_dense expects a 2-D gradient, got "
                         f"shape {tuple(grad.shape)}")
    num_rows = grad.shape[0]
    k = min(int(max_rows), num_rows)
    activity = grad.abs().sum(dim=1)
    idx = torch.sort(activity, descending=True, stable=True)[1][:k]
    return SparseRows(values=grad[idx], indices=idx.to(torch.int32),
                      num_rows=num_rows)


def rows_to_dense(rows: SparseRows) -> torch.Tensor:
    """Scatter-add ``rows`` into a dense ``(num_rows, dim)`` tensor;
    duplicate indices sum."""
    dense = rows.values.new_zeros((rows.num_rows,) + rows.values.shape[1:])
    return dense.index_add_(0, rows.indices.long(), rows.values)


def sparse_allreduce_async(rows: SparseRows, *,
                           op: ReduceOp = ReduceOp.AVERAGE,
                           process_set=None, name: str | None = None
                           ) -> collectives.Handle:
    """Start :func:`sparse_allreduce`; the handle's result is the gathered
    ``SparseRows``. The shapes are exchanged before this returns."""
    del name
    if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(
            f"sparse_allreduce supports AVERAGE/SUM, got {op.name} "
            "(matches the reference, which only averages/sums IndexedSlices)")
    pset = _resolve(process_set)
    values = rows.values
    if op == ReduceOp.AVERAGE:
        if not (values.is_floating_point() or values.is_complex()):
            raise TypeError("AVERAGE needs floating-point values; use SUM")
        values = values / pset.size()
    h_values = collectives.allgather_async(values, process_set=pset)
    h_indices = collectives.allgather_async(rows.indices, process_set=pset)
    return h_values.then(lambda v: SparseRows(
        v, h_indices.synchronize(), rows.num_rows))


def sparse_allreduce(rows: SparseRows, *, op: ReduceOp = ReduceOp.AVERAGE,
                     process_set=None, name: str | None = None
                     ) -> SparseRows:
    """Reduce an indexed-rows gradient over ``process_set`` by allgathering
    its values and indices (reference ``sparse_allreduce``). AVERAGE
    divides the values by the set's size first, so the gathered rows sum
    to the dense average; only SUM and AVERAGE are defined."""
    return sparse_allreduce_async(rows, op=op, process_set=process_set,
                                  name=name).synchronize()


def sparse_allreduce_to_dense(grad: torch.Tensor, max_rows: int, *,
                              op: ReduceOp = ReduceOp.AVERAGE,
                              process_set=None, name: str | None = None
                              ) -> torch.Tensor:
    """Dense in, dense out: pick ``max_rows`` rows, reduce them with
    :func:`sparse_allreduce` and scatter them back, in ``grad``'s dtype.
    With ``HVD_SPARSE_AS_DENSE`` set, a plain allreduce of ``grad``."""
    if envs.get_bool(envs.SPARSE_AS_DENSE):
        return collectives.allreduce(grad, op=op, process_set=process_set,
                                     name=name)
    reduced = sparse_allreduce(rows_from_dense(grad, max_rows), op=op,
                               process_set=process_set, name=name)
    return rows_to_dense(reduced).to(grad.dtype)
