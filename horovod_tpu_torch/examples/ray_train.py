#!/usr/bin/env python
"""Training on a Ray cluster, static and elastic: the twin of the JAX
package's ``examples/ray_train.py``.

Actors take the place of ssh placement, and the worker function is the
five-line pattern starting with ``hvd.init()``. On a machine with Ray::

    python -m horovod_tpu_torch.examples.ray_train              # 2 workers
    python -m horovod_tpu_torch.examples.ray_train --elastic    # min 2

Without Ray it prints SKIP and exits 0. ``--process-stub`` runs it over
:func:`horovod_tpu_torch.testing.make_process_ray` instead (actors as
child processes, one node); ``--device cpu`` trains in a gloo world on the
host instead of on the cards.
"""

from __future__ import annotations

import argparse
import sys


def train_fn(steps: int = 10, device=None) -> float:
    """One rank: the five-line pattern on a linear regression (32 rows of 2
    features a rank, from a generator seeded by the rank)."""
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
    parser.add_argument("--elastic", action="store_true")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--smoke", action="store_true",
                        help="fewer training steps")
    parser.add_argument("--device", default=None,
                        help="cpu for a gloo world on the host (default: "
                             "the cards)")
    parser.add_argument("--process-stub", action="store_true",
                        help="actors as child processes, without Ray")
    args = parser.parse_args(argv)
    steps = 20 if args.smoke else 40

    if args.process_stub:
        from horovod_tpu_torch import testing
        sys.modules["ray"] = testing.make_process_ray(
            {"127.0.0.1": args.workers})
    try:
        import ray  # noqa: F401
    except ImportError:
        print("SKIP: ray not installed (install Ray to run this example)")
        return 0

    if args.elastic:
        from horovod_tpu_torch.ray import ElasticRayExecutor
        ex = ElasticRayExecutor(min_workers=args.workers)
    else:
        from horovod_tpu_torch.ray import RayExecutor
        ex = RayExecutor(num_workers=args.workers)
    ex.start()
    try:
        # an elastic worker wraps its loop in hvd.elastic.run; the example
        # runs the static function for brevity, as the JAX one does
        results = ex.run(train_fn, args=(steps, args.device))
    finally:
        ex.shutdown()
    print(f"final losses per rank: {results}")
    assert all(loss < 1.0 for loss in results), results
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
