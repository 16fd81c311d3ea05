"""Loader base, an async prefetch mixin, and a loader that gives each rank
its share of seeded global batches (port of ``horovod_tpu/data/loader.py``).

:class:`BaseDataLoader` and :class:`AsyncDataLoaderMixin` are the
reference's (``horovod/data/data_loader_base.py``), composed the same way::

    class MyAsyncLoader(AsyncDataLoaderMixin, MyLoader):
        pass

:class:`ShardedArrayLoader` walks the same seeded global batches as the JAX
loader; where that one shards each global batch over the mesh, here each
rank (one process per card) takes its own contiguous rows of it.
"""

from __future__ import annotations

from queue import Empty, Queue
from threading import Event, Thread

import numpy as np
import torch

from .. import runtime


class BaseDataLoader:
    """Iterable of batches (reference ``BaseDataLoader``)."""

    def __len__(self):
        raise NotImplementedError()

    def _iterate(self):
        """Yield raw batches; concrete loaders implement it."""
        raise NotImplementedError()

    def __iter__(self):
        for batch in self._iterate():
            yield self._process_batch(batch)

    def _process_batch(self, batch):
        """Hook for a subclass's or trainer's batch post-processing."""
        return batch


class AsyncDataLoaderMixin:
    """Prefetch ``_iterate()`` on a daemon thread into a bounded queue
    (reference ``AsyncDataLoaderMixin``; a queue size of 0 turns it off).

    Mix it in FIRST: ``class Loader(AsyncDataLoaderMixin, Base)``.
    """

    def __init__(self, *args, async_loader_queue_size: int = 64, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        super().__init__(*args, **kwargs)
        self._queue: Queue | None = None
        self._finished: Event | None = None
        self._thread: Thread | None = None

    def close_async_loader(self) -> None:
        """Stop the prefetch thread and drain the queue."""
        if self._thread is None:
            return
        self._finished.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._queue.get_nowait()
            except Empty:
                break
        self._thread.join(timeout=30)
        self._thread = None

    def _async_worker(self):
        try:
            for batch in super().__iter__():
                if self._finished.is_set():
                    return
                self._queue.put((batch, None))
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            # a producer's error surfaces in the training loop: an epoch cut
            # short on one rank would hang the next collective
            self._queue.put((None, e))
            return
        self._queue.put((None, None))  # the end of the epoch

    def __iter__(self):
        if self.async_loader_queue_size <= 0:
            yield from super().__iter__()
            return
        self._finished = Event()
        self._queue = Queue(self.async_loader_queue_size)
        self._thread = Thread(target=self._async_worker, daemon=True,
                              name="hvd-data-prefetch")
        self._thread.start()
        try:
            while True:
                batch, error = self._queue.get()
                if error is not None:
                    raise error
                if batch is None:
                    break
                yield batch
        finally:
            self.close_async_loader()


class ShardedArrayLoader(BaseDataLoader):
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

    def _iterate(self):
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
