"""The benchmark of ``horovod_tpu_torch``: one command runs one cell once.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:
a cell's configuration (``configs/<config>.json``, built by
``families/<family>.py``, recomputed by ``reference/<family>.py``), its
traffic (``traffic/<traffic>.json``), its correctness limits
(``limits/<workload>.json``) and each per-layer metric
(``metrics/<metric>.py``). ``frozen/`` holds the yardstick: peaks, bound
arithmetic, the token generator and the trace reader.
"""
