"""Pipeline parallelism: a GPipe microbatch schedule over a stage group
(port of ``horovod_tpu/parallel/pipeline.py``).

Every rank of a stage group (a ``torch.distributed`` group; None is this
rank alone) holds one stage, stage r on group rank r. The batch is cut into
microbatches that flow from stage to stage over point-to-point sends; the
last stage's output is broadcast to every stage, so a loss computed after
it is the same everywhere::

    out = pipeline_apply(stage, x, pp_group, n_microbatches=8)

The reference's three conventions hold:

* the output is the last stage's, on every stage; in the backward the last
  stage takes the MEAN of the replicas' cotangents, the others none, so a
  loss computed on every stage counts once;
* d(loss)/dx is the whole input cotangent, summed over the group so that
  every stage holds it (only stage 0 reads x), so replicated layers before
  the pipeline get the same gradient on every stage;
* a stage's output is cast back to ``x.dtype``.

The schedule is one autograd Function, :class:`_Pipeline`, which posts
every send and receive itself. Forward, stage r runs microbatches 0..M-1
in order, receiving each from stage r-1 before it and sending its output
to stage r+1 after it. Backward runs the microbatches in reverse, M-1..0,
on every stage: stage r receives microbatch m's output cotangent from r+1,
back-propagates its stage, and sends the input cotangent to r-1. NCCL pairs
point-to-point operations by their order on each pair of ranks, and both
ends of every pair post in the same microbatch order; a receive waits only
on a send its peer posts before it blocks itself, so the chain ends at the
last stage (forward) or the first (backward) and never closes a cycle. The
stage's parameters are inputs of the Function: their gradients over all
microbatches are summed inside it and land in ``.grad`` once, so a
``DistributedOptimizer``'s gradient hooks fire once a step. The reference
also computes fill and drain ticks on zero microbatches, whose outputs it
drops; the port does not run them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.program_issue import ordered
from .sequence import group_rank, group_size


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B/n_micro, ...); the batch must divide."""
    if x.shape[0] % n_microbatches:
        raise ValueError(
            f"batch {x.shape[0]} must divide into n_microbatches="
            f"{n_microbatches}")
    return x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                     *x.shape[1:])


def _peer(group, r: int) -> int:
    return dist.get_global_rank(group, r)


def _wait(works) -> None:
    for w in works:
        w.wait()


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule; see the module's docstring for its order."""

    @staticmethod
    def forward(ctx, x, run, group, n_micro, *params):
        n, r = group_size(group), group_rank(group)
        micro = microbatch(x, n_micro)
        ctx.group, ctx.params = group, params
        ctx.dtype, ctx.shape, ctx.x_requires_grad = (
            x.dtype, micro.shape[1:], x.requires_grad)
        ins, outs, sends = [], [], []
        for m in range(n_micro):
            h = micro[m]
            if r > 0:
                h = torch.empty_like(micro[m])
                with ordered():
                    dist.recv(h, _peer(group, r - 1), group)
            h = h.detach().requires_grad_()
            with torch.enable_grad():
                out = run(h).to(x.dtype)
            ins.append(h)
            outs.append(out)
            if r < n - 1:
                with ordered():
                    sends.append(dist.isend(out.detach().contiguous(),
                                            _peer(group, r + 1), group))
        _wait(sends)
        ctx.ins, ctx.outs = ins, outs
        done = torch.cat([o.detach() for o in outs]) if r == n - 1 else \
            x.new_empty((x.shape[0],) + tuple(micro.shape[2:]))
        if n > 1:
            with ordered():
                dist.broadcast(done, _peer(group, n - 1), group)
        return done

    @staticmethod
    def backward(ctx, g):
        group, params = ctx.group, ctx.params
        n, r = group_size(group), group_rank(group)
        n_micro = len(ctx.ins)
        if n > 1:  # the last stage takes the mean of the replicas'
            g = g.contiguous().clone()
            with ordered():
                dist.all_reduce(g, group=group)
            g = g / n
        g_micro = microbatch(g, n_micro)
        grads = [None] * len(params)
        dx, sends = [None] * n_micro, []
        for m in reversed(range(n_micro)):
            if r == n - 1:
                gm = g_micro[m].to(ctx.dtype)
            else:
                gm = torch.empty(ctx.shape, dtype=ctx.dtype,
                                 device=g.device)
                with ordered():
                    dist.recv(gm, _peer(group, r + 1), group)
            got = torch.autograd.grad(ctx.outs[m], (ctx.ins[m], *params),
                                      gm, allow_unused=True)
            ctx.outs[m] = None  # free the microbatch's graph
            grads = [a if b is None else (b if a is None else a + b)
                     for a, b in zip(grads, got[1:])]
            gh = torch.zeros_like(ctx.ins[m]) if got[0] is None else got[0]
            if r > 0:
                with ordered():
                    sends.append(dist.isend(gh.contiguous(),
                                            _peer(group, r - 1), group))
            else:
                dx[m] = gh
        _wait(sends)
        gx = None
        if ctx.x_requires_grad:
            gx = (torch.cat(dx) if r == 0 else
                  torch.zeros((n_micro * ctx.shape[0],) + tuple(
                      ctx.shape[1:]), dtype=ctx.dtype, device=g.device))
            if n > 1:  # every stage holds the whole input cotangent
                with ordered():
                    dist.all_reduce(gx, group=group)
        return (gx, None, None, None, *grads)


def pipeline_apply(stage_fn, x: torch.Tensor, group=None, *,
                   n_microbatches: int, remat: bool = False, params=None):
    """Run the GPipe schedule of ``stage_fn`` over the stage group.

    Args:
      stage_fn: THIS rank's stage, an ``nn.Module`` or a callable mapping a
        microbatch to an output of the same shape (computed in any dtype;
        cast back to ``x.dtype``).
      x: the whole (batch, ...) input, the same on every stage.
      group: the stage group; its size is the number of stages.
      n_microbatches: the schedule's depth; the bubble is
        (stages - 1) / (n_micro + stages - 1) of the step.
      remat: recompute the stage's inside in the backward
        (``torch.utils.checkpoint``) instead of keeping its activations.
      params: the tensors a callable stage trains (default: an
        ``nn.Module`` stage's parameters).

    Returns the (batch, ...) output of the LAST stage on every stage.
    """
    if params is None:
        params = (stage_fn.parameters() if isinstance(stage_fn, nn.Module)
                  else ())
    params = tuple(p for p in params if p.requires_grad)
    run = stage_fn
    if remat:
        def run(h):
            return checkpoint(stage_fn, h, use_reentrant=False)
    return _Pipeline.apply(x, run, group, n_microbatches, *params)
