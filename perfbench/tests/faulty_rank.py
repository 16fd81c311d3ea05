"""A rank of the benchmark with a fault planted in the program, for the
tests: ``PERFBENCH_TEST_FAULT=no_exchange`` leaves out the exchange
between ranks (``DistributedOptimizer`` hands back the optimizer as it
is, so each rank steps on its own gradient)."""

import os
import sys

import horovod_tpu_torch as hvd

from perfbench import worker

if __name__ == "__main__":
    if os.environ.get("PERFBENCH_TEST_FAULT") == "no_exchange":
        hvd.DistributedOptimizer = lambda opt, **kw: opt
    sys.exit(worker.main())
