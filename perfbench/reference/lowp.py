"""Matrix products in float32, and the control: the same products one
precision below the program's.

The configurations compute their products in bfloat16: bfloat16 operands
in, a bfloat16 result out, forward and backward. The control, the
nearest precision below, is fp8 in the same places: each product's
operands are rounded to ``float8_e4m3fn`` and its result to
``float8_e4m3fn`` in the forward pass; in the backward pass the incoming
gradient and the gradients it gives are rounded to ``float8_e5m2`` (the
hybrid recipe of fp8 training). Each rounding takes one scale a tensor,
which maps its largest magnitude to the format's largest finite value.
The products themselves run in float32 on the rounded values, as fp8
tensor cores accumulate in float32. Norms, softmax, the loss and the
optimizer stay float32, as in the reference.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP32, FP8 = "fp32", "fp8"
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
PRECISIONS = (FP32, FP8)


@contextlib.contextmanager
def fp32_exact():
    """Float32 products in float32 inside: TF32 off for cuBLAS and cuDNN;
    the settings as they were afterwards."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
        torch.set_float32_matmul_precision(was[2])


def round8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to the fp8 ``dtype`` with one per-tensor scale, back
    in float32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round8(a, E4M3), round8(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return round8(qa @ qb, E4M3)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round8(g, E5M2)
        return (round8(qg @ qb.transpose(-1, -2), E5M2),
                round8(qa.transpose(-1, -2) @ qg, E5M2))


def matmul(a, b, precision: str):
    """``a @ b`` (same leading dims, or 2-D) at ``precision``."""
    if precision == FP8:
        return _Fp8Matmul.apply(a, b)
    return a @ b


def linear(x, w, precision: str):
    """``x @ w.T`` over the last dim of ``x``."""
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]), w.t(), precision)
    return y.reshape(*lead, w.shape[0])


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, qw = round8(x, E4M3), round8(w, E4M3)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding)
        return round8(F.conv2d(qx, qw, None, stride, padding), E4M3)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding = ctx.conf
        qg = round8(g, E5M2)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride, padding)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride, padding)
        return round8(gx, E5M2), round8(gw, E5M2), None, None


def conv2d(x, w, stride, padding, precision: str):
    """``F.conv2d`` without bias at ``precision``; ``padding`` symmetric."""
    if precision == FP8:
        return _Fp8Conv.apply(x, w, stride, padding)
    return F.conv2d(x, w, None, stride, padding)
