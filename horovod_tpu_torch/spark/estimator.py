"""The estimator's role on Spark: train a model *from data* (port of
``horovod_tpu/spark/estimator.py``).

The role of reference Horovod's Spark estimators with a Store: the driver
hands data and a model recipe over and gets the trained parameters back,
with checkpoints kept. Built of the port's own pieces:

* placement and start: :func:`horovod_tpu_torch.spark.run`'s barrier
  tasks;
* data: :class:`~horovod_tpu_torch.data.ShardedArrayLoader` over arrays in
  memory, or an ``.npz`` that every executor can read;
* the Store: a :class:`~horovod_tpu_torch.checkpoint.Checkpointer` at
  ``store_path``: a checkpoint an epoch, and a rerun resumes from the
  latest.

The recipe in torch's form::

    def init_fn(generator, batch) -> torch.nn.Module: ...
    def loss_fn(model, batch) -> torch.Tensor: ...   # a scalar

    params = fit((features, labels), init_fn, loss_fn, epochs=3,
                 batch_size=64, num_proc=4, store_path="/shared/run1",
                 optimizer=functools.partial(torch.optim.SGD, lr=0.05))

``optimizer`` maps the model's parameters to a ``torch.optim.Optimizer``
(default Adam at 1e-3); the gradients sync through
:class:`~horovod_tpu_torch.optim.DistributedOptimizer`. The result is the
model's ``state_dict`` as numpy arrays. Each task runs on the card of its
slot unless ``device`` names another (``"cpu"``: a gloo world on the
hosts). Rank 0's Store decides the epoch every rank resumes at, and the
optimizer's state resumes with the model's.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

__all__ = ["fit", "fit_dataframe", "save_dataset"]


def save_dataset(store_path: str, *arrays) -> str:
    """Write arrays to ``<store_path>/dataset.npz``: the Store's inputs, one
    write on the driver, read by every executor over shared storage.
    Returns the ``.npz`` path, which :func:`fit` takes."""
    import numpy as np

    os.makedirs(store_path, exist_ok=True)
    path = os.path.join(store_path, "dataset.npz")
    np.savez(path, **{f"arr_{i}": a for i, a in enumerate(arrays)})
    return path


def _load_data(data) -> tuple:
    import numpy as np

    if isinstance(data, str):
        with np.load(data) as npz:
            return tuple(npz[k] for k in sorted(
                npz.files, key=lambda k: int(k.split("_")[-1])))
    return tuple(np.asarray(a) for a in data)


def _adam(params):
    import torch
    return torch.optim.Adam(params, lr=1e-3)


def _to_numpy(t):
    t = t.detach().cpu()
    import torch
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _fit_task(data, init_fn, loss_fn, optimizer, epochs, batch_size,
              shuffle, seed, store_path, device=None):
    """One rank, in a barrier task: shard, train, checkpoint."""
    import torch

    import horovod_tpu_torch as hvd
    from ..checkpoint import Checkpointer
    from ..data import ShardedArrayLoader

    owns = not hvd.is_initialized()
    hvd.init(device=device)
    try:
        arrays = _load_data(data)
        loader = ShardedArrayLoader(*arrays, batch_size=batch_size,
                                    shuffle=shuffle, seed=seed)
        if len(loader) == 0:
            raise ValueError(
                f"batch_size {batch_size} exceeds the dataset "
                f"({len(arrays[0])} rows): zero batches per epoch")
        dev = hvd.device()
        # an example batch of the loader's leading dimension
        example = tuple(torch.from_numpy(a[:batch_size]).to(dev)
                        for a in arrays)
        model = init_fn(torch.Generator().manual_seed(seed), example).to(dev)
        opt = (optimizer or _adam)(model.parameters())

        ckpt = (Checkpointer(os.path.join(store_path, "checkpoints"))
                if store_path else None)
        latest = ckpt.latest_step() if ckpt is not None else None
        # rank 0's Store decides the epoch of every rank: a rank whose
        # store_path shows another step must not run epochs of collectives
        # that nobody else joins
        start_epoch = hvd.broadcast_object(
            0 if latest is None else latest + 1, root_rank=0)
        if start_epoch > 0:
            step = start_epoch - 1
            state = (ckpt.restore(step=step)
                     if ckpt is not None and step in ckpt.all_steps()
                     else None)
            if any(hvd.allgather_object(state is None)):
                state = hvd.broadcast_object(state, root_rank=0)
            model.load_state_dict(state["model"])
            # the optimizer's moments resume with the parameters
            opt.load_state_dict(state["optimizer"])
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        if start_epoch > 0:
            hvd.broadcast_optimizer_state(opt, root_rank=0)
        dopt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())

        last_loss = None
        for epoch in range(start_epoch, epochs):
            loader.set_epoch(epoch)
            loss = None
            for batch in loader:
                dopt.zero_grad()
                loss = loss_fn(model, batch)
                loss.backward()
                dopt.step()
            if loss is not None:
                last_loss = float(loss.detach())
            if ckpt is not None and hvd.rank() == 0:
                ckpt.save(epoch, {"model": model.state_dict(),
                                  "optimizer": opt.state_dict()}, wait=True)
        if ckpt is not None:
            ckpt.close()
        return {"params": {k: _to_numpy(v)
                           for k, v in model.state_dict().items()},
                "last_loss": last_loss,
                "epochs_run": max(0, epochs - start_epoch)}
    finally:
        if owns:
            hvd.shutdown()


def fit(data, init_fn: Callable, loss_fn: Callable, *,
        optimizer=None, epochs: int = 1, batch_size: int = 32,
        shuffle: bool = True, seed: int = 0, store_path: str | None = None,
        num_proc: int | None = None, start_timeout: float | None = None,
        env: dict | None = None, device=None) -> Any:
    """Train on Spark's executors; returns the trained ``state_dict`` as
    numpy arrays. ``data`` is a sequence of arrays with one leading
    dimension (``(features, labels)``, as ``loss_fn`` takes them) or the
    path of an ``.npz`` every executor can read (:func:`save_dataset`).
    With ``store_path``, a checkpoint an epoch goes there and a rerun
    resumes from the latest."""
    from . import run as spark_run

    results = spark_run(
        _fit_task,
        args=(data, init_fn, loss_fn, optimizer, epochs, batch_size,
              shuffle, seed, store_path, device),
        num_proc=num_proc, start_timeout=start_timeout, env=env)
    return results[0]["params"]


def fit_dataframe(df, feature_cols: Sequence[str], label_cols: Sequence[str],
                  init_fn: Callable, loss_fn: Callable, *,
                  store_path: str, **fit_kwargs) -> Any:
    """Train from a Spark DataFrame: the selected columns go to the Store
    once, collected on the driver (for data that fits the driver's
    memory), then :func:`fit` trains from the ``.npz``. Array-typed
    feature columns are stacked to 2-D."""
    import numpy as np

    cols = list(feature_cols) + list(label_cols)
    rows = df.select(*cols).collect()
    features = np.asarray([[row[c] for c in feature_cols] for row in rows],
                          dtype=np.float32)
    labels = np.asarray([[row[c] for c in label_cols] for row in rows])
    if features.ndim == 3:  # array-typed feature columns: one per column
        features = features.reshape(len(rows), -1)
    if labels.shape[-1] == 1:
        labels = labels[:, 0]
    path = save_dataset(store_path, features, labels)
    return fit(path, init_fn, loss_fn, store_path=store_path, **fit_kwargs)
