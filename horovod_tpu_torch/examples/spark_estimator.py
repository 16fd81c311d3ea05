#!/usr/bin/env python
"""The estimator's role on Spark, ``fit(dataset) -> trained parameters``:
the twin of the JAX package's ``examples/spark_estimator.py``.

The driver hands data and a model recipe to
``horovod_tpu_torch.spark.fit``; barrier tasks train on sharded batches
with the gradient allreduce, a checkpoint an epoch lands at
``store_path``, and a rerun resumes from the latest. On a machine with
pyspark::

    python -m horovod_tpu_torch.examples.spark_estimator

Without pyspark it prints SKIP and exits 0. ``--process-stub`` runs it
over :func:`horovod_tpu_torch.testing.make_process_pyspark` instead;
``--device cpu`` trains in a gloo world on the host.
"""

from __future__ import annotations

import argparse
import functools
import sys
import tempfile


def init_fn(generator, batch):
    """The example's linear regression, zeros, for ``(features,
    labels)``."""
    import torch
    x, _ = batch
    model = torch.nn.Linear(x.shape[1], 1)
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    return model


def loss_fn(model, batch):
    x, y = batch
    return ((model(x)[:, 0] - y) ** 2).mean()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-proc", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=6)
    parser.add_argument("--smoke", action="store_true",
                        help="the smallest useful run (6 epochs of 4 "
                             "steps: SGD at 0.05 needs about 20 steps "
                             "to bring the MSE under 0.5)")
    parser.add_argument("--device", default=None,
                        help="cpu for a gloo world on the host (default: "
                             "the cards)")
    parser.add_argument("--process-stub", action="store_true",
                        help="barrier tasks as child processes, without "
                             "pyspark")
    args = parser.parse_args(argv)
    if args.smoke:
        args.epochs = 6

    import numpy as np
    import torch

    import horovod_tpu_torch.spark as hvd_spark

    spark = None
    if args.process_stub:
        from horovod_tpu_torch import testing
        sys.modules["pyspark"] = testing.make_process_pyspark()
    else:
        try:
            from pyspark.sql import SparkSession
        except ImportError:
            print("SKIP: pyspark not installed")
            return 0
        spark = (SparkSession.builder.master(f"local[{args.num_proc}]")
                 .appName("horovod_tpu_torch-spark-estimator")
                 .config("spark.ui.enabled", "false").getOrCreate())
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((256, 4)).astype(np.float32)
        y = (x @ np.arange(1.0, 5.0, dtype=np.float32)) + 0.5

        with tempfile.TemporaryDirectory() as store:
            params = hvd_spark.fit(
                (x, y), init_fn, loss_fn,
                optimizer=functools.partial(torch.optim.SGD, lr=0.05),
                epochs=args.epochs, batch_size=64, num_proc=args.num_proc,
                store_path=store, device=args.device)
        w, b = params["weight"][0], params["bias"][0]
        mse = float(np.mean((x @ w + b - y) ** 2))
        print(f"trained: mse={mse:.4f} w={w}")
        assert mse < 0.5, mse
        return 0
    finally:
        if spark is not None:
            spark.stop()


if __name__ == "__main__":
    sys.exit(main())
