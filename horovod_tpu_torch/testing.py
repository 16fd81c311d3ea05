"""Card-against-CPU checks of the port's convnets, shared by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

:func:`convnet_steps` runs one step of a model from the same weights and
batch in several (device, compute dtype, mode) settings; :func:`step_errors`
compares two of them. TF32 is off for the steps: cuDNN's float32
convolutions use it by default, which would need a 1e-3-scale tolerance.
:func:`pooling_errors` reads the average pool's backward on channels-last
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# One step from the same weights, the card's against the CPU's in float64:
# the largest logit error relative to the largest logit, the
# relative norm error of all gradients together and of the worst tensor,
# and the largest running-average error.
REFERENCE_LIMITS = {"logits_rel": 1e-3, "grads_rel": 1e-3,
                    "worst_grad_rel": 1e-2, "stats_abs": 1e-3}


def _reference_weights(name: str) -> dict:
    """flax's init from a seed, then BatchNorm scales and biases moved off
    their initial values (the last norm of each residual block to about
    0.2), so that every gradient is live."""
    from horovod_tpu_torch import models
    from horovod_tpu_torch.models import BatchNorm
    model = getattr(models, name)(num_classes=1000, device="cpu",
                                  generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n, s = m.weight.numel(), 0.2 if m.zero_scale else 1.0
                m.weight.copy_(s * (1 + 0.2 * torch.randn(n, generator=g)))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
    return model.state_dict()


def convnet_steps(name: str, size: int, settings, batch: int = 2) -> list:
    """One step of the port's ``name`` (1000 classes, Dropout off) in each
    ``(device, compute dtype, train)`` of ``settings``, from the same
    float32 weights (:func:`_reference_weights`) and the same seeded batch
    of ``size`` x ``size`` images: cross-entropy, backward. Returns, per
    setting, the logits, every parameter's gradient and the running
    averages after the step, on the CPU."""
    from horovod_tpu_torch import models
    state = _reference_weights(name)
    kw = {"dropout_rate": 0.0} if name == "InceptionV3" else {}
    g = torch.Generator().manual_seed(6)
    x = torch.randn((batch, 3, size, size), generator=g)
    y = torch.randint(0, 1000, (batch,), generator=g)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = []
        for device, dtype, train in settings:
            model = getattr(models, name)(num_classes=1000, dtype=dtype,
                                          device=device, **kw)
            model.load_state_dict(state)
            model.train(train)
            logits = model(x.to(device))
            F.cross_entropy(logits, y.to(device)).backward()
            res.append((logits.detach().cpu(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()},
                        {k: t.cpu() for k, t in model.state_dict().items()
                         if k.endswith(("running_mean", "running_var"))}))
            del model, logits
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return res


def step_errors(got, want) -> dict:
    """``got`` against ``want`` (two results of :func:`convnet_steps`), as
    the keys of ``REFERENCE_LIMITS``."""
    (l1, g1, s1), (l0, g0, s0) = got, want
    rel = lambda a, b: ((a.double() - b.double()).norm()
                        / b.double().norm()).item()
    flat = lambda d: torch.cat([d[n].flatten().double() for n in sorted(d)])
    return {"logits_rel": ((l1.double() - l0.double()).abs().max()
                           / l0.double().abs().max()).item(),
            "grads_rel": rel(flat(g1), flat(g0)),
            "worst_grad_rel": max(rel(g1[n], g0[n]) for n in g0),
            "stats_abs": max(((s1[k].double() - s0[k].double()).abs().max()
                              .item() for k in s0), default=0.0)}


def convnet_reference_errors(name: str, size: int, device,
                             dtype=torch.float32, train: bool = True) -> dict:
    """One step of ``name`` on ``device`` computing in ``dtype`` against the
    same step on the CPU in float64 (see :func:`convnet_steps`). float64 is
    the yardstick because the host's own float32 convolutions differ from
    host to host: ResNet-18's float32 gradients from oneDNN on the H100's
    host read 5.3e-3 from float64, the card's 3.0e-5."""
    cpu, card = convnet_steps(name, size, [("cpu", torch.float64, train),
                                           (device, dtype, train)])
    return step_errors(card, cpu)


def pooling_errors(device, shape=(2, 288, 35, 35)) -> dict:
    """The backward of a 3x3 stride-1 average pool with counted padding on
    a channels-last float32 tensor on ``device``, against float64 on the
    CPU: torch's ``avg_pool2d`` itself (``"avg_pool2d"``) and the port's
    :func:`~horovod_tpu_torch.models.layers.avg_pool_same`, each as the
    relative norm error of dx."""
    from horovod_tpu_torch.models.layers import avg_pool_same
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    ct = torch.randn(shape, generator=g, dtype=torch.float64)
    pools = {"avg_pool2d": lambda t: F.avg_pool2d(t, 3, 1, 1,
                                                  count_include_pad=True),
             "avg_pool_same": avg_pool_same}
    want = torch.autograd.grad(pools["avg_pool2d"](x.requires_grad_()), x,
                               ct)[0]
    errs = {}
    for name, pool in pools.items():
        xs = (x.detach().float().to(device)
              .contiguous(memory_format=torch.channels_last).requires_grad_())
        dx = torch.autograd.grad(pool(xs), xs, ct.float().to(device).contiguous(
            memory_format=torch.channels_last))[0]
        errs[name] = ((dx.double().cpu() - want).norm() / want.norm()).item()
    return errs
