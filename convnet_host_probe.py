#!/usr/bin/env python3
"""How earlier work in one process slows the host-bound convnet step.

Times the synthetic-benchmark twin's ResNet-50 (224x224, batch 32, 2
warmup and 20 timed steps, NCCL world 1) in one process on one card: three
times fresh (the third with fp16 on the wire), then after a
card-against-CPU reference step (ResNet-18, float32,
``testing.convnet_reference_errors``), then twice after a profiled step
(``chip_smoke._profile_step``). This is why ``chip_smoke.py`` times the
twins first thing in a child process of its own. From the repository root,
on a host with a card::

    python3 convnet_host_probe.py
"""

from __future__ import annotations

import subprocess
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("convnet_host_probe: no CUDA device is visible")
    import chip_smoke
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import testing
    from horovod_tpu_torch.examples import synthetic_benchmark as sb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    hvd.init()

    def run(tag, flags=()):
        res, step, _ = sb.train(sb.parse_args(list(flags)
                                              + ["--num-iters", "20"]))
        print(f"[probe] {tag}: step {res['step_ms']:.2f} ms, "
              f"{res['img_sec']:.1f} images/s", flush=True)
        return step

    run("fresh 1")
    step = run("fresh 2")
    run("fresh 3, fp16 on the wire", ["--fp16-allreduce"])
    testing.convnet_reference_errors("ResNet18", 224, dev)
    run("after the CPU reference step")
    chip_smoke._profile_step(step)
    run("after a profiled step")
    run("after a profiled step, again")
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
