"""A loader that gives each rank its share of seeded global batches (port
of ``ShardedArrayLoader`` in ``horovod_tpu/data/loader.py``).

:class:`ShardedArrayLoader` walks the same seeded global batches as the JAX
loader; where that one shards each global batch over the mesh, here each
rank (one process per card) takes its own contiguous rows of it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import runtime


class ShardedArrayLoader:
    """Batches of host arrays, each rank's share of each global batch.

    Epoch ``e`` walks the rows in the order of one seeded global
    permutation (``default_rng(seed + e)``), ``batch_size`` rows a global
    batch; rank ``r`` of ``size`` yields rows ``[r * b, (r + 1) * b)`` of
    each, ``b = batch_size // size``, as a tuple of tensors on ``device``
    (default: ``hvd.device()``, else the card). The global batch size must
    divide by the world size; the trailing remainder of an epoch is dropped
    unless ``drop_remainder=False``, which then needs it to divide too.
    """

    def __init__(self, *arrays, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True, device=None):
        if not arrays:
            raise ValueError("ShardedArrayLoader needs at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("all arrays must share the leading dimension")
        self.arrays = [np.asarray(a) for a in arrays]
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.device = device
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.arrays[0])
        return n // self.batch_size if self.drop_remainder else \
            -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.arrays[0])
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        rank, size = ((runtime.rank(), runtime.size())
                      if runtime.is_initialized() else (0, 1))
        if self.batch_size % size != 0:
            raise ValueError(
                f"batch_size {self.batch_size} must divide by the "
                f"world size {size}")
        if not self.drop_remainder and n % self.batch_size \
                and (n % self.batch_size) % size:
            raise ValueError(
                f"drop_remainder=False with a trailing partial batch of "
                f"{n % self.batch_size} samples cannot be sharded over "
                f"{size} devices; drop the remainder or pad the dataset")
        device = runtime.default_device(self.device)
        stop = (n - self.batch_size + 1) if self.drop_remainder else n
        for start in range(0, max(stop, 0), self.batch_size):
            idx = order[start:start + self.batch_size]
            per = len(idx) // size
            idx = idx[rank * per:(rank + 1) * per]
            yield tuple(torch.from_numpy(a[idx]).to(device)
                        for a in self.arrays)
