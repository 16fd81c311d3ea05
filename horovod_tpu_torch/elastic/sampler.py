"""Elastic-aware dataset sampler (port of ``horovod_tpu/elastic/sampler.py``).

The reference's ``ElasticSampler`` (``horovod/torch/elastic/sampler.py``):
partitions a dataset's indices over the ranks, tracks how many samples the
epoch has consumed, and after an elastic reset partitions the *remaining*
indices over the new world, so that a grown or shrunk job finishes the
epoch without processing a sample twice or skipping one.

With :class:`~horovod_tpu_torch.elastic.TorchState` (``sampler=``) the
sampler's progress is committed and restored with the rest of the state::

    sampler = hvd.elastic.ElasticSampler(len(dataset))
    state = hvd.elastic.TorchState(model=model, optimizer=opt,
                                   sampler=sampler)
    for idx in batches_of(sampler.local_indices(), batch):
        ...
        sampler.record_batch(batch)
        state.commit()
"""

from __future__ import annotations

import math
import random

from .. import runtime


class ElasticSampler:
    """Deterministic partition of a dataset's indices over the ranks, with
    the processed samples tracked (plain integer indices; it is also an
    iterable a ``torch.utils.data.DataLoader`` takes as ``sampler=``)."""

    def __init__(self, dataset_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.dataset_size = int(dataset_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_num = 0
        self.reset()

    # -- epoch and progress ------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        """Advance to ``epoch`` and clear the processed count. Call it at
        the END of each epoch, so that a partly done epoch is not
        processed again."""
        self.epoch = epoch
        self.processed_num = 0
        self.reset()

    def record_batch(self, batch_size: int) -> None:
        """Account one processed batch of each rank (every rank consumed
        ``batch_size`` samples this step)."""
        self.processed_num += int(batch_size) * self.num_replicas

    # -- elastic state -----------------------------------------------------

    def state_dict(self) -> dict:
        return dict(epoch=self.epoch, processed_num=self.processed_num)

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.processed_num = state["processed_num"]
        self.reset()

    def reset(self) -> None:
        """Partition the unprocessed indices over the current world (after
        ``load_state_dict`` and ``set_epoch``). A rank is a process, the
        unit that feeds data."""
        self.num_replicas = (runtime.size()
                             if runtime.is_initialized() else 1)
        self.rank = runtime.rank() if runtime.is_initialized() else 0
        indices = list(range(self.dataset_size))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(indices)
        self.remaining_indices = indices[self.processed_num:]
        self.num_samples = int(
            math.ceil(len(self.remaining_indices) / max(self.num_replicas, 1)))
        self.total_size = self.num_samples * self.num_replicas

    # -- iteration ---------------------------------------------------------

    def local_indices(self) -> list:
        """This rank's indices for the rest of the epoch, padded cyclically
        so that every rank yields the same count."""
        indices = list(self.remaining_indices)
        if not indices:
            return []
        reps = -(-self.total_size // len(indices))  # ceil: a full cyclic pad
        indices = (indices * reps)[:self.total_size]
        return indices[self.rank:self.total_size:self.num_replicas]

    def __iter__(self):
        return iter(self.local_indices())

    def __len__(self) -> int:
        return self.num_samples
