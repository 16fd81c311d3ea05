"""Device milliseconds a traced step spends in the program's BatchNorm
kernels: every device launch whose name holds ``hvdbn`` (the kernels of
``horovod_tpu_torch/csrc/batch_norm.cu``) in rank 0's traced block,
summed, over the block's ``perfbench.step`` spans. None where the trace
holds no such launch: an untraced run, or a program without the
kernels."""


def read(art):
    t = art.lead.get("trace")
    if not t:
        return None
    runs = [e - s for name, s, e in t["device"] if "hvdbn" in name]
    steps = sum(1 for name, _, _ in t["host"] if name == "perfbench.step")
    if not runs or not steps:
        return None
    return sum(runs) / 1e3 / steps
