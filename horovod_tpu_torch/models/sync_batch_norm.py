"""Batch normalization with flax's semantics, local or over the world
(port of ``horovod_tpu/models/sync_batch_norm.py``).

:class:`BatchNorm` is flax ``nn.BatchNorm``, not ``nn.BatchNorm2d``:

* the batch moments E[x] and E[x^2] are taken in float32 (or in the
  input's dtype where that is wider) from the input (bf16 in the models),
  and the variance is ``max(E[x^2] - E[x]^2, 0)``, the biased one;
* the running averages move as ``ra = momentum * ra + (1 - momentum) *
  batch``, with flax's ``momentum`` (0.9 is torch's 0.1), and the running
  variance takes the biased batch variance (``nn.BatchNorm2d`` takes the
  unbiased one, n / (n - 1) larger);
* normalization is computed in that dtype, ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``, and only the output is cast to ``dtype``;
* ``zero_scale`` initializes the scale to 0 (the last norm of a residual
  block).

:class:`SyncBatchNorm` takes the moments over the whole world: the twin of
flax ``BatchNorm(axis_name=...)``, which ``pmean``s (E[x], E[x^2]) across the
mesh axis. Its forward averages the two moments with the port's
``allreduce`` and its backward averages their cotangents, as XLA
differentiates through the ``pmean``. At a world of one it equals
:class:`BatchNorm`. It runs collectives in training mode, so it needs
``hvd.init()``; in eval mode it reads the running averages, as flax does.

Both run one autograd function, :class:`_BatchNormFunction`, in four steps:
``stats`` (the moments), ``norm`` (the output), ``bwd_reduce`` (dweight,
dbias and the moments' cotangents) and ``bwd_dx``. A module's pair of hooks
sits between them: ``_reduce`` on the (2, C) moments after ``stats``, and its
transpose ``_reduce_grad`` on their cotangents after ``bwd_reduce``. On the
card each step is a hand-written CUDA kernel (``csrc/batch_norm.cu``), two
passes over the activation each way, which reads rows of C contiguous
channels: the function takes a channels-innermost x (channels-last, or
(n, C)) as it lies and copies any other once to that layout, forward, as it
does dy backward; its output and dx lie so. On the CPU each step is its
plain PyTorch version below: the forward is torch's ops as flax's formula
writes them, the backward their gradient in closed form. A CUDA input takes
the kernels or raises. Each kernel launch adds one to its entry of
:data:`launches`. The backward is differentiable once: a second derivative
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn as nn
from torch.autograd.function import once_differentiable

from .. import runtime
from ..ops import _build, collectives
from ..ops.reduce_ops import ReduceOp

# Kernel launches since the last reset_launch_counts(), by kernel.
launches = {"stats": 0, "norm": 0, "bwd_reduce": 0, "bwd_dx": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _acc(dtype) -> torch.dtype:
    """The dtype the statistics and the arithmetic take: float32, or the
    input's where that is wider."""
    return torch.promote_types(dtype, torch.float32)


def _dims(x) -> list:
    return [0] + list(range(2, x.dim()))


def _per_channel(t, x):
    """A (C,) tensor shaped to broadcast over ``x``'s channel dim."""
    return t.view((1, -1) + (1,) * (x.dim() - 2))


def _mean_var(stats, train):
    """(mean, var, E[x^2] - E[x]^2) from the (2, C) ``stats``: the moments
    in training mode; the running (mean, var) in eval mode, whose variance
    is taken as it is (the third is then None)."""
    mean = stats[0]
    if not train:
        return mean, stats[1], None
    d = stats[1] - mean.square()
    return mean, d.clamp_min(0.0), d


# --------------------------------------------------------------------------
# plain versions (the CPU's path; the kernels' yardstick on the card)
# --------------------------------------------------------------------------

def stats_plain(x):
    """The (2, C) moments (E[x], E[x^2]) of ``x`` over all but dim 1."""
    x32 = x.to(_acc(x.dtype))
    return torch.stack((x32.mean(_dims(x)), x32.square().mean(_dims(x))))


def norm_plain(x, stats, train, weight, bias, eps, dtype, running=None):
    """``((x - mean) * (rsqrt(var + eps) * weight) + bias)`` cast to
    ``dtype``, with (mean, var) from ``stats`` (see :func:`_mean_var`).
    ``running``, ``(running_mean, running_var, momentum)`` in training mode,
    moves the running averages toward the batch's (mean, var) in place."""
    mean, var, _ = _mean_var(stats, train)
    if running is not None:
        ra_mean, ra_var, m = running
        with torch.no_grad():
            ra_mean.copy_(m * ra_mean + (1 - m) * mean)
            ra_var.copy_(m * ra_var + (1 - m) * var)
    mul = torch.rsqrt(var + eps) * weight
    x32 = x.to(_acc(x.dtype))
    return ((x32 - _per_channel(mean, x)) * _per_channel(mul, x)
            + _per_channel(bias, x)).to(dtype)


def bwd_reduce_plain(dy, x, stats, train, weight, eps):
    """``(dweight, dbias, dstats)`` for the cotangent ``dy`` of
    :func:`norm_plain`'s output: ``dstats`` is the cotangent of the moments
    in ``stats`` through ``var = clamp_min(E[x^2] - E[x]^2, 0)`` (the
    gradient passes where that is >= 0, as torch's ``clamp_min`` passes
    it), None in eval mode."""
    mean, var, d = _mean_var(stats, train)
    r = torch.rsqrt(var + eps)
    acc = _acc(x.dtype)
    dy32 = dy.to(acc)
    s1 = dy32.sum(_dims(x))
    s2 = (dy32 * (x.to(acc) - _per_channel(mean, x))).sum(_dims(x))
    dstats = None
    if train:
        dvar = -0.5 * (s2 * weight) * r.pow(3)
        dd = torch.where(d >= 0, dvar, torch.zeros_like(dvar))
        dstats = torch.stack((-(r * weight) * s1 - 2 * mean * dd, dd))
    return s2 * r, s1, dstats


def bwd_dx_plain(dy, x, stats, train, weight, eps, dstats):
    """dx for the cotangent ``dy``: ``dy * mul``, and with the moments'
    cotangents ``dstats`` (training mode) their share through
    E[x] = mean(x) and E[x^2] = mean(x^2):
    ``dE[x] / n + 2 x dE[x^2] / n``, written about the mean."""
    mean, var, _ = _mean_var(stats, train)
    mul = torch.rsqrt(var + eps) * weight
    acc = _acc(x.dtype)
    dx = dy.to(acc) * _per_channel(mul, x)
    if dstats is not None:
        n = x.numel() // x.shape[1]
        b = 2 * dstats[1] / n
        c = (dstats[0] + 2 * mean * dstats[1]) / n
        dx = dx + (_per_channel(c, x) + _per_channel(b, x)
                   * (x.to(acc) - _per_channel(mean, x)))
    return dx.to(x.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

# dtype codes of csrc/batch_norm.cu, the accumulator dtype of each, and the
# (x, y) dtype pairs it is built for; dy takes y's dtype and dx x's
_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_ACC = {torch.bfloat16: torch.float32, torch.float32: torch.float32,
        torch.float64: torch.float64}
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.float64, torch.float64)}
_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "hvd_bn_max_chunks": [],
    # x xk R C part cap moments stream
    "hvd_bn_stats": [_P, _I, _L, _I, _P, _I, _P, _P],
    # x xk y yk R C stats from_moments weight bias eps running_mean
    # running_var momentum stream
    "hvd_bn_norm": [_P, _I, _P, _I, _L, _I, _P, _I, _P, _P, _D, _P, _P, _D,
                    _P],
    # dy yk x xk R C part cap stats from_moments weight eps dweight dbias
    # dstats stream
    "hvd_bn_bwd_reduce": [_P, _I, _P, _I, _L, _I, _P, _I, _P, _I, _P, _D,
                          _P, _P, _P, _P],
    # dy yk x xk dx R C stats from_moments weight eps dstats stream
    "hvd_bn_bwd_dx": [_P, _I, _P, _I, _P, _L, _I, _P, _I, _P, _D, _P, _P],
}


_entries: dict = {}  # C entry name -> (library, function)


def _entry(name: str):
    """The C entry ``name`` of the built ``batch_norm`` library, typed."""
    got = _entries.get(name)
    if got is None:
        lib = _build.load("batch_norm")
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _SIGNATURES[name], ctypes.c_int
        got = _entries[name] = (lib, fn)
    return got


def _rows(t):
    """``t``'s data as rows of C contiguous channels, the layout every
    kernel wrapper below takes: ``t`` itself where it lies so
    (channels-last, or a contiguous (n, C)), else one copy."""
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last) \
            or t.dim() == 2 and t.is_contiguous():
        return t
    inner = t.movedim(1, -1)
    return t if inner.is_contiguous() else inner.contiguous().movedim(-1, 1)


def _shape_of(x) -> tuple[int, int]:
    if x.dim() < 2:
        raise ValueError(f"BatchNorm takes (n, C, ...) tensors, got shape "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    return x.numel() // c if c else 0, c


def _coeffs(t, acc):
    """A (C,) or (2, C) coefficient tensor in the accumulator dtype: ``t``
    itself where it is one."""
    if t.dtype == acc and t.is_contiguous():
        return t
    return t.detach().to(acc).contiguous()


def _call(name, *args, device):
    """The C entry ``name`` on ``args``, a tensor passed as its data
    pointer (the list keeps every tensor alive until the launch is
    queued), then the current stream of ``device``."""
    lib, fn = _entry(name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch._C._cuda_getDevice():
        status = fn(*ptrs, stream)
    else:
        with torch.cuda.device(device):
            status = fn(*ptrs, stream)
    _build.check(lib, status, name)


_max_chunks: dict = {}  # device index -> hvd_bn_max_chunks() there


def _scratch(rows, c, device):
    """A reduction's scratch: a (2, C) row of float64 partial sums for each
    chunk, as many rows as the card holds blocks at once
    (``hvd_bn_max_chunks``, which bounds the chunks the kernels cut the
    rows into) or as ``rows``, where that is fewer."""
    cap = _max_chunks.get(device.index)
    if cap is None:
        with torch.cuda.device(device):
            cap = _max_chunks[device.index] = _entry("hvd_bn_max_chunks")[1]()
    return torch.empty((min(cap, max(rows, 1)), 2, c), dtype=torch.float64,
                       device=device)


def stats_kernel(x):
    """:func:`stats_plain` on the card, for ``x`` laid out by
    :func:`_rows`."""
    rows, c = _shape_of(x)
    part = _scratch(rows, c, x.device)
    moments = torch.empty((2, c), dtype=_ACC[x.dtype], device=x.device)
    _call("hvd_bn_stats", x, _KINDS[x.dtype], rows, c, part, part.shape[0],
          moments, device=x.device)
    launches["stats"] += 1
    return moments


def norm_kernel(x, stats, train, weight, bias, eps, dtype, running=None):
    """:func:`norm_plain` on the card, for ``x`` laid out by :func:`_rows`;
    the output lies as ``x`` does. The kernel moves the running averages (a
    running average of another dtype than the arithmetic's moves through a
    copy)."""
    rows, c = _shape_of(x)
    acc = _ACC[x.dtype]
    y = torch.empty_like(x, dtype=dtype)
    ra, momentum = (None, None), 0.0
    if running is not None:
        ra, momentum = [_coeffs(t, acc) for t in running[:2]], running[2]
    _call("hvd_bn_norm", x, _KINDS[x.dtype], y, _KINDS[dtype], rows,
          c, _coeffs(stats, acc), int(train), _coeffs(weight, acc),
          _coeffs(bias, acc), float(eps), *ra, float(momentum),
          device=x.device)
    if running is not None:
        for buf, moved in zip(running[:2], ra):
            if moved is not buf:
                buf.copy_(moved)
    launches["norm"] += 1
    return y


def bwd_reduce_kernel(dy, x, stats, train, weight, eps):
    """:func:`bwd_reduce_plain` on the card, for ``dy`` and ``x`` laid out
    by :func:`_rows`."""
    rows, c = _shape_of(x)
    acc = _ACC[x.dtype]
    part = _scratch(rows, c, x.device)
    out = torch.empty((4, c), dtype=acc, device=x.device)
    dweight, dbias, dstats = out[0], out[1], out[2:] if train else None
    _call("hvd_bn_bwd_reduce", dy, _KINDS[dy.dtype], x, _KINDS[x.dtype],
          rows, c, part, part.shape[0],
          _coeffs(stats, acc), int(train), _coeffs(weight, acc), float(eps),
          dweight, dbias, dstats, device=x.device)
    launches["bwd_reduce"] += 1
    return dweight, dbias, dstats


def bwd_dx_kernel(dy, x, stats, train, weight, eps, dstats):
    """:func:`bwd_dx_plain` on the card, for ``dy`` and ``x`` laid out by
    :func:`_rows`; dx lies as ``x`` does."""
    rows, c = _shape_of(x)
    acc = _ACC[x.dtype]
    dx = torch.empty_like(x)
    _call("hvd_bn_bwd_dx", dy, _KINDS[dy.dtype], x, _KINDS[x.dtype], dx,
          rows, c, _coeffs(stats, acc), int(train),
          _coeffs(weight, acc), float(eps),
          None if dstats is None else _coeffs(dstats, acc), device=x.device)
    launches["bwd_dx"] += 1
    return dx


PLAIN = {"stats": stats_plain, "norm": norm_plain,
         "bwd_reduce": bwd_reduce_plain, "bwd_dx": bwd_dx_plain}
KERNELS = {"stats": stats_kernel, "norm": norm_kernel,
           "bwd_reduce": bwd_reduce_kernel, "bwd_dx": bwd_dx_kernel}


def _steps(x, dtype) -> dict:
    """The plain versions for a CPU input, the kernels for a CUDA one."""
    if x.device.type == "cpu":
        return PLAIN
    if x.device.type != "cuda":
        raise ValueError(f"BatchNorm runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if (x.dtype, dtype) not in _PAIRS:
        raise TypeError(f"the BatchNorm kernels take (input, output) dtypes "
                        f"{sorted(map(str, _PAIRS))}, got ({x.dtype}, "
                        f"{dtype})")
    return KERNELS


class _BatchNormFunction(torch.autograd.Function):
    """One training- or eval-mode norm of ``x`` by ``norm`` (a
    :class:`BatchNorm`) with ``weight`` and ``bias``. Saves ``x`` (on the
    card as the kernels read it, :func:`_rows`) and the (2, C) statistics it
    normalized with, nothing of full size besides. Its backward takes the
    moments as constants, so it is differentiable once only."""

    @staticmethod
    def forward(ctx, x, weight, bias, norm):
        steps = _steps(x, norm.compute_dtype)
        if steps is KERNELS:
            x = _rows(x)
        train = norm.training
        if train:
            stats = norm._reduce(steps["stats"](x))
            running = (norm.running_mean, norm.running_var, norm.momentum)
        else:
            stats = torch.stack((norm.running_mean, norm.running_var))
            running = None
        ctx.save_for_backward(x, weight, stats)
        ctx.norm, ctx.train = norm, train
        return steps["norm"](x, stats, train, weight, bias, norm.epsilon,
                             norm.compute_dtype, running)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        norm, train = ctx.norm, ctx.train
        steps = _steps(x, dy.dtype)
        if steps is KERNELS:
            dy = _rows(dy)
        dweight, dbias, dstats = steps["bwd_reduce"](dy, x, stats, train,
                                                     weight, norm.epsilon)
        dx = None
        if ctx.needs_input_grad[0]:
            if dstats is not None:
                dstats = norm._reduce_grad(dstats)
            dx = steps["bwd_dx"](dy, x, stats, train, weight, norm.epsilon,
                                 dstats)
        return dx, dweight.to(weight.dtype), dbias.to(weight.dtype), None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW (or NC) tensor;
    ``momentum`` and ``epsilon`` are flax's. Statistics come from the batch
    in training mode (``model.train()``) and from the running averages in
    eval mode."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=torch.bfloat16,
                 zero_scale: bool = False, device=None):
        super().__init__()
        device = runtime.default_device(device)
        self.momentum, self.epsilon = momentum, epsilon
        self.compute_dtype, self.zero_scale = dtype, zero_scale
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.empty(num_features, device=device))
        self.register_buffer("running_var",
                             torch.empty(num_features, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        """flax's initializers: scale 1 (0 with ``zero_scale``), bias 0,
        running mean 0 and running variance 1."""
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _reduce(self, moments: torch.Tensor) -> torch.Tensor:
        """The (2, C) moments the batch normalizes with: here this rank's
        own."""
        return moments

    def _reduce_grad(self, cotangents: torch.Tensor) -> torch.Tensor:
        """The transpose of :meth:`_reduce` on the moments' cotangents."""
        return cotangents

    def forward(self, x):
        return _BatchNormFunction.apply(x, self.weight, self.bias, self)


class SyncBatchNorm(BatchNorm):
    """:class:`BatchNorm` whose batch moments are averaged over every rank
    of the world (reference ``hvd.SyncBatchNorm``). Every rank must hold
    the same number of samples, as the mean of the ranks' means is the
    global mean only then (flax's ``pmean`` assumes the same)."""

    def _reduce(self, moments):
        return collectives.allreduce(moments, op=ReduceOp.AVERAGE)

    def _reduce_grad(self, cotangents):
        """The gradient of a mean over the ranks is the mean of the ranks'
        cotangents (the transpose of ``lax.pmean``)."""
        return collectives.allreduce(cotangents.contiguous(),
                                     op=ReduceOp.AVERAGE)
