#!/usr/bin/env python
"""Training on Spark's executors through ``horovod_tpu_torch.spark.run``:
the twin of the JAX package's ``examples/spark_train.py``.

One barrier task a rank, results in rank order. On a machine with
pyspark::

    python -m horovod_tpu_torch.examples.spark_train

Without pyspark it prints SKIP and exits 0. ``--process-stub`` runs it
over :func:`horovod_tpu_torch.testing.make_process_pyspark` instead
(barrier tasks as child processes); ``--device cpu`` trains in a gloo
world on the host instead of on the cards.
"""

from __future__ import annotations

import argparse
import sys


def train_fn(steps: int = 10, device=None) -> float:
    """One rank: the five-line pattern (the Ray twin's function). Defined
    here, in the ``__main__`` module, so that pyspark's cloudpickle sends
    it by value: executors need not import this example."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    dev = hvd.device()
    rng = np.random.default_rng(hvd.rank())
    w_true = torch.tensor([[2.0], [-3.0]])
    x = torch.from_numpy(rng.standard_normal((32, 2)).astype(np.float32))
    y = (x @ w_true).to(dev)
    x = x.to(dev)
    model = torch.nn.Linear(2, 1, bias=False).to(dev)
    with torch.no_grad():
        model.weight.zero_()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    loss = None
    for _ in range(steps):
        opt.zero_grad()
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
    out = float(loss.detach())
    hvd.shutdown()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-proc", type=int, default=2)
    parser.add_argument("--smoke", action="store_true",
                        help="fewer training steps")
    parser.add_argument("--device", default=None,
                        help="cpu for a gloo world on the host (default: "
                             "the cards)")
    parser.add_argument("--process-stub", action="store_true",
                        help="barrier tasks as child processes, without "
                             "pyspark")
    args = parser.parse_args(argv)
    steps = 20 if args.smoke else 40

    import horovod_tpu_torch.spark as hvd_spark

    if args.process_stub:
        from horovod_tpu_torch import testing
        sys.modules["pyspark"] = testing.make_process_pyspark()
        results = hvd_spark.run(train_fn, args=(steps, args.device),
                                num_proc=args.num_proc)
    else:
        try:
            from pyspark.sql import SparkSession
        except ImportError:
            print("SKIP: pyspark not installed (install pyspark to run "
                  "this example)")
            return 0
        spark = (SparkSession.builder.master(f"local[{args.num_proc}]")
                 .appName("horovod_tpu_torch-spark-example").getOrCreate())
        try:
            results = hvd_spark.run(train_fn, args=(steps, args.device),
                                    num_proc=args.num_proc)
        finally:
            spark.stop()
    print(f"final losses per rank: {results}")
    assert all(loss < 1.0 for loss in results), results
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
