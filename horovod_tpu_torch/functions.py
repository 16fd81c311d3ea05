"""State synchronization helpers (port of ``horovod_tpu/functions.py``).

As in the reference Horovod's torch API, these update the given tensors in
place, so ``broadcast_parameters(model.state_dict(), 0)`` overwrites the
model's parameters and buffers with rank 0's. ``process_set`` limits the
broadcast to a set's members; ``root_rank`` is a global rank of the set.
"""

from __future__ import annotations

import torch

from .ops import collectives


def _broadcast_in_place(tensors: list, root_rank: int,
                        process_set=None) -> None:
    synced = collectives.grouped_broadcast(tensors, root_rank,
                                           process_set=process_set)
    with torch.no_grad():
        for t, s in zip(tensors, synced):
            t.copy_(s)


def broadcast_parameters(params: dict, root_rank: int = 0, *,
                         process_set=None):
    """Broadcast a module's ``state_dict()`` or a dict of tensors from
    ``root_rank``, in place, in the order of the sorted keys. Returns
    ``params``."""
    tensors = [params[k] for k in sorted(params)
               if isinstance(params[k], torch.Tensor)]
    _broadcast_in_place(tensors, root_rank, process_set)
    return params


def broadcast_optimizer_state(optimizer, root_rank: int = 0, *,
                              process_set=None):
    """Broadcast a ``torch.optim.Optimizer``'s state tensors from
    ``root_rank``, in place. Every rank must hold state of the same
    structure (for example, after the same number of steps)."""
    opt = getattr(optimizer, "optimizer", optimizer)
    tensors = []
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state.get(p, {})
            tensors.extend(state[k] for k in sorted(state)
                           if isinstance(state[k], torch.Tensor))
    _broadcast_in_place(tensors, root_rank, process_set)
    return optimizer
