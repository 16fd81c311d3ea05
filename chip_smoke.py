#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the repository root, on a host with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the three flash-attention kernels from ``horovod_tpu_torch/csrc``
   for ``sm_90a``, one ``nvcc`` per source in parallel, with each kernel's
   registers, shared memory and spills as ``-Xptxas -v`` reports them (a
   kernel that spills fails the phase);
3. tile edges: the three bf16 tensor-core kernels (forward, dq and dk/dv)
   against their plain versions at shapes that end one row before, one row
   after or inside a tile, with fully masked rows, and with whole query
   tiles that see no key (``TILE_EDGE_SHAPES``), at d 64 and 128, causal
   and not, the forward from random incoming carries, held to the per-row
   limits of ``TRAINING_LIMITS`` (and m and lse = m + log l to theirs);
4. kernels: each kernel against its plain PyTorch version at the training
   shape (bh 64, s 2048, d 64, bf16, causal) and at an awkward one (sq 13,
   sk 11, q offset 3, d 64, float32, causal and not), timed with CUDA events
   beside its plain version, ``scaled_dot_product_attention`` (the
   library's yardstick; the port never calls it) and its roofline bound;
4b. batch norm (alone: ``python3 chip_smoke.py --batch-norm``): the four
   BatchNorm kernels of ``csrc/batch_norm.cu`` built (a spill fails the
   phase), held to their plain versions and timed by their device time
   beside their bound, the plain versions and ``F.batch_norm`` at
   ResNet-50's stem and last-stage shapes at batch 256 (``BN_SHAPES``);
5. reference: the model's flash path against its plain attention path on a
   small float32 input;
6. trainer: data-parallel TransformerLM training at the full width of the
   repo's ``TransformerConfig`` defaults with ``attn_mode="ulysses"``, through
   ``init`` (NCCL), ``broadcast_parameters`` and
   ``DistributedOptimizer(Adam)``, whose gradient hooks start each bucket's
   allreduce during the backward pass, for 5 steps on 8 x 2048 tokens; the
   loss must be finite and fall, every kernel must have been launched
   ``num_layers x steps`` times, the 46.4 M float32 parameters must make at
   least 3 buckets at the default ``HVD_BUCKET_BYTES``, and every step must
   have started at least one bucket before ``backward()`` returned. One
   more step then runs under ``torch.profiler``, which prints its device
   time by kernel and whether an NCCL kernel ran before the backward pass's
   last kernel ended. Then a second run from the same initial weights,
   ``backward_passes_per_step=2`` with the token embedding on the sparse
   path (``sparse_gradient_paths=["^embed\\."]``, ``sparse_max_rows`` 8 x
   2048): 10 backward passes, one on each 4 x 2048 half of the batch in
   turn; the loss must be finite and fall, every kernel be launched
   ``num_layers x passes`` times, every odd pass leave the parameters as
   they were, and the first full step agree with one plain Adam step on the
   mean of the same two halves' gradients within ``K2_AGREEMENT`` of the
   parameters' norm;
7. MoE: the MoE TransformerLM at the same full width with one expert
   (``TransformerConfig(attn_mode="ulysses", moe_experts=1)``; the expert
   group is the world of one), bf16, 8 x 2048 tokens, Adam with the
   reference trainer's ``0.01 * moe_aux_loss()``, 5 steps: the loss must be
   finite and fall, each block's load-balance loss be exactly 1 (one
   expert: gate 1, capacity 20480 drops nothing), every kernel be launched
   ``num_layers x steps`` times, and the first step's logits agree with
   the dense TransformerLM on the same weights (expert 0 as its MLP) within
   ``MOE_LOGITS_AGREEMENT``; one profiled step by kind of work (dispatch
   and combine, GEMMs, flash, copies);
7b. adasum: the trainer again with ``DistributedOptimizer(op=Adasum)``
   at NCCL world 1, 5 steps, beside a shadow ``op=Average`` optimizer fed
   the same local gradients: each step's reduced gradients must equal the
   local ones and both runs' parameters stay bitwise equal (both ops are
   the identity at world 1), the loss must fall and every step start a
   bucket in the backward pass; the fused per-tensor combine of one VHDD
   level (``ops.adasum.combine``) on two batches' gradients, float32 and
   rounded to bf16, within ``ADASUM_AGREEMENT`` of its float64 version, and
   timed; the native negotiation engine built with ``g++`` and one
   in-process cycle of two engines, and one KV round's time;
7c. negotiation: the trainer again, with ``HVD_TIMELINE`` set at
   ``init()`` (the file must hold the parameters' broadcast), then STEPS
   steps in each of four turns, the timeline off, on, on and off: every on
   turn's file must parse as Chrome-trace JSON and hold a range for every
   gradient bucket of every step, and each turn's step time is printed
   (the timeline's cost); every kernel ``num_layers x STEPS x 4`` launches.
   Then two ``DynamicService``s in this process over a ``KVServer`` on this
   host, with ``HVD_RESPONSE_CACHE=1``, flat and then two-level with leader
   groups of one: one named allreduce request ``NEG_CALLS`` times; once
   the cache confirms it, every call must be served with no busy round
   (the rounds a call before and after, the hits and misses, a round's
   time); ``metrics_dump()`` must hold every busy round in its round
   histogram;
7d. fusion: K1-K3 against their plain versions at the trainer's shape
   once more; then the trainer (as in 6, its gradients kept in place by
   ``zero_grad(set_to_none=False)``) through the fusion cycle and its
   pipelined executor, twice (the eager path's spread against itself),
   then with ``HVD_STEP_CAPTURE=1``: step 1 records and steps 2-5 each
   replay one CUDA Graph of the step's sync (pack, NCCL, unpack), with no
   divergence, and the parameters after the steps must equal the eager
   run's bit for bit (or, were the eager run not bitwise equal to itself,
   lie within its own spread); every kernel ``num_layers x steps``
   launches a run; flushes by trigger and the executor's counters. Then
   the captured trainer's step with capture off and on in turns
   (``FUSION_TURNS`` pairs), one profiled step under capture, and
   ResNet-50's ``synchronize()`` alone (161 gradients, bf16) with capture
   off and on in turns, in host ms and CUDA-event ms a call;
7e. cached step: the trainer (as in 7d, with ``Adam(capturable=True)``)
   twice eagerly (its own spread), then under ``hvd.cached_step`` with a
   fresh closure every step: step 1 runs eagerly and captures the whole
   step (forward, loss, backward, the gradient sync and Adam) into one
   CUDA Graph, steps 2-5 replay it. One plan, one record, at least 4
   replays, no fallback, a falling loss, and the parameters after the
   steps equal to the eager run's bit for bit (or, were the eager run not
   bitwise equal to itself, within its own spread); K1-K3 ``num_layers``
   times at each capture and by name in one profiled replay. A second
   batch shape (4 x 2048) records a second graph and both replay. Then
   the step eagerly and cached in turns, one profiled step of each (the
   device's busy share), and each run's peak memory;
7f. checkpoint: the cached trainer under ``elastic.TorchState``,
   committing every step with the state plane on (``HVD_CKPT_DIR`` in a
   temporary directory, interval 1): each commit's time, the background
   snapshot's time and size, a ``Checkpointer`` save; a fresh model and
   optimizer restored from the sealed step (``sharded_restore_or_none``)
   and another from the ``Checkpointer`` each take 2 more steps, and their
   parameters must equal the uninterrupted run's bit for bit;
7g. launch: the trainer (as in 6) through ``python -m
   horovod_tpu_torch.runner.launch -np 1`` and started directly, each in a
   process of its own (``--trainer-worker``): losses and parameters
   bitwise equal, K1-K3 ``num_layers x STEPS`` launches, the worker on
   the launcher's card and KV store; the launcher's start-up time (spawn
   to ``init()`` done, against the direct run's);
7h. elastic: the cached trainer (as in 7e) under ``hvd.elastic.run`` with
   ``TorchState``, a commit a step (``--elastic-worker``), through the
   elastic launcher at ``--min-np 1 --max-np 1`` (this process runs its
   driver): at the worker's request the driver publishes a new round that
   keeps the slot, and the worker re-forms in its own process
   (``HostsUpdatedInterrupt`` once, a new NCCL group on the same card, the
   cached step recorded again: 2 records); its losses and parameters must
   be bitwise those of the same run uninterrupted; the re-form's time,
   interrupt to training and to the new round's first step's end;
7i. autoscale: the same worker uninterrupted through the elastic launcher
   at ``--min-np 1 --max-np 1`` with ``HVD_AUTOSCALE=1`` and an SLO below
   its step time (this process runs the driver and the policy, with one
   ``policy.eval`` fault): sensor blobs of the job's round, the breach
   streak past its windows and no membership decision (the ceiling), the
   fault a counted hold, the observer's mean step time within
   ``OBSERVER_AGREEMENT`` of the worker's own, losses and parameters
   bitwise 7h's uninterrupted run; the observer's cost a commit, on
   against off in turns;
7j. ray: over ``testing.make_process_ray`` (an actor is a child process),
   ``RayExecutor(num_workers=1)`` of the trainer, bitwise 7g's direct run
   with ``num_layers x STEPS`` launches, and ``ElasticRayExecutor`` of
   7h's worker uninterrupted, bitwise its reference; start-up against
   7g's;
7k. spark: over ``testing.make_process_pyspark`` (a barrier task is a
   child process), ``spark.run(num_proc=1)`` of the trainer, bitwise 7g's
   direct run; ``spark.fit`` of the full-width TransformerLM from seeded
   tokens with a Store: 2 epochs, a rerun that runs 0 epochs to the same
   parameters, 3 epochs resumed from the Store bitwise 3 from scratch; the
   per-epoch checkpoint's size and its save and load times;
8. pipeline: the pipeline twin (``examples/pipeline_train.py --model
   full``: vocab 32000, d_model 512, hidden 2048, 4 residual-MLP blocks, 8
   x 2048 tokens, bf16) at pp 1 with 4 microbatches for 5 steps: the loss
   must be finite and fall;
9. long context, in a fresh process of its own: the long-context twin
   (``horovod_tpu_torch.examples.long_context_lm --model full``) at the full
   width of the repo's ``TransformerConfig`` defaults over 1 x 16384
   tokens, bf16 compute, NCCL world 1, for each of ``ring``,
   ``ring_zigzag`` and ``ulysses``: 2 warm-up and 3 timed steps each; the
   loss must be finite and fall, each kernel must be launched
   ``num_layers`` times a step (3 times that for the zigzag, which halves
   the block even at one rank) at the offsets the schedule gives, and the
   modes' first-step logits on the same weights must agree within
   ``LOGITS_AGREEMENT``; once all three are timed, one profiled step each;
10. ring patterns: K1, K2 and K3 at bh 8, d 64, bf16 against their plain
   versions (computed one bh slice at a time) under the kernels phase's
   per-row limits, at every block (sq, sk, qpos0, kpos0) the long-context
   phase launches (16384 x 16384 at (0, 0); 8192 x 8192 at (0, 0), (8192,
   0) and (8192, 8192)) and every live block that rank 3 of a contiguous
   causal ring of 4 over 16384 tokens and rank 0 of a zigzag ring of 4
   launch; each kernel timed on the fully-past 4096 x 4096 block, where
   every pair is live;
11. convnets: the data-parallel convnet path, whose only kernels of the
   port are BatchNorm's (convolutions and pooling are cuDNN and torch ops,
   as they are XLA's in the JAX package). First, in a fresh process of its
   own, so that no earlier host work slows the host-bound steps: the
   synthetic-benchmark twin at its defaults (ResNet-50, 224x224, batch 32,
   NCCL world 1, 2 warmup and 10 timed steps) with ``Compression.none`` and
   ``fp16``, whose loss must be finite and fall, then VGG-16 at 224x224 and
   Inception V3 at 299x299 for 3 timed steps (finite losses); after those,
   the sync layer and the SGD update alone at ResNet-50's gradients, and
   one profiled ResNet-50 step per wire format (busy share of the timed
   step, top kernels, device time by kind). Then, here: the port's average
   pool's backward on a channels-last tensor (torch's own is wrong on the
   card); ResNet-18 and Inception V3 on the card against the same modules
   in float64 on the CPU with TF32 off (``CONVNET_REFERENCE_CASES``:
   logits, gradients and running averages within
   ``testing.REFERENCE_LIMITS``), with the float32 training-mode gap from
   float64 measured on both (``CONDITIONING_CASES``); the MNIST twin's
   smoke epoch, whose step loss must fall.

The last lines are a ``{"trainer": {"hooks": ..., "k2_sparse": ...}}`` JSON
object (each run's step time, tokens/s, peak memory, losses and buckets,
with the per-step count of buckets started during the backward pass), a
``{"moe": ..., "pipeline": ...}`` one, one ``{"kernels": [...]}`` JSON
object (each kernel's launches on the trainer's, the k=2 run's, the
Adasum run's, the negotiation phase's, the fusion phase's, the cached
step's, the launched trainer's, the re-formed trainer's, the autoscaled
trainer's, the Ray and Spark trainers' and the MoE run's main path),
preceded by ``{"adasum": ...}``, ``{"negotiation": ...}``,
``{"fusion": ...}``, ``{"cached_step": ..., "checkpoint": ...}``,
``{"launch": ..., "elastic": ...}`` and ``{"autoscale": ..., "ray": ...,
"spark": ...}`` and followed by ``{"batch_norm": [...]}`` (the BatchNorm
kernels' rows), the card's ``nvidia-smi`` name and power limit, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
STEPS = 5
BATCH, SEQ = 8, 2048
# The long-context phase: one sequence of LC_SEQ tokens at world 1.
LC_SEQ, LC_WARMUP, LC_TIMED = 16384, 2, 3
LC_MODES = ("ring", "ring_zigzag", "ulysses")
# The ring-pattern phase: the blocks of a ring of RING_N ranks over
# RING_SEQ tokens, at bh RING_BH.
RING_N, RING_SEQ, RING_BH = 4, 16384, 8


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def synthetic_tokens(n_seqs, seq_len, vocab, seed=0):
    """Arithmetic progressions mod vocab (``examples/long_context_lm.py``):
    something learnable at every context position."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n_seqs, 1))
    step = rng.integers(1, 7, size=(n_seqs, 1))
    pos = np.arange(seq_len)[None, :]
    return ((start + step * pos) % vocab).astype(np.int64)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card over ``reps`` back-to-back calls,
    after ``warmup`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def unmasked_pairs(sq, sk, qpos0, kpos0, causal) -> int:
    """(query, key) pairs that take part: the work this data needs."""
    from horovod_tpu_torch.ops import flash
    return int(flash.live_keys(sq, sk, qpos0, kpos0, causal).sum())


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def _launch_config(lib, name, d, bf16) -> tuple[int, int]:
    """(threads, dynamic shared memory bytes) of one block."""
    threads, smem = ctypes.c_int(), ctypes.c_int()
    getattr(lib, f"hvd_{name}_config")(d, int(bf16), ctypes.byref(threads),
                                       ctypes.byref(smem))
    return threads.value, smem.value


def phase_build():
    from horovod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.KERNEL_SOURCES)} kernels for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for name in _build.KERNEL_SOURCES:
        for line in _build.build_logs.get(name, "(cached)").splitlines():
            if ("entry function" in line or "Used" in line
                    or "spill" in line or "cached" in line):
                print(f"[build] {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)) > 0:
                spills.append(f"{name}: {line.strip()}")
        lib = _build.load(name)
        for d in (64, 128):
            for bf16 in (True, False):
                threads, smem = _launch_config(lib, name, d, bf16)
                print(f"[build] {name} d={d} "
                      f"{'bf16' if bf16 else 'float32'}: {threads} threads, "
                      f"{smem} B dynamic shared memory per block")
    require(not spills, f"kernels spill registers: {spills}")


def device_ms(fn, reps: int, warmup: int = 2) -> tuple[float, dict]:
    """Device time of one call of ``fn``: every kernel, copy and set its
    ``reps`` calls run, from ``torch.profiler``, over ``reps``; and that time
    by kernel name. Unlike :func:`time_ms` it leaves out the host's time
    between launches, which at small shapes exceeds the kernels'."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))
              and not getattr(e, "is_user_annotation", False)]
    by_name = {e.key[:120]: e.self_device_time_total / 1e3 / reps
               for e in events}
    return sum(by_name.values()), by_name


# The BatchNorm phase's shapes (n, c, h, w): ResNet-50's stem and its last
# stage at batch 256, bf16, channels-last.
BN_SHAPES = {"stem": (256, 64, 112, 112), "stage4": (256, 2048, 7, 7)}
# The kernels against the plain versions there, with the bf16 limits of
# tests/test_torch_cuda.py's BN_LIMITS: y and dx within one bf16 step (2^-7
# of the value) plus 1e-5; each per-channel sum (the moments, dweight,
# dbias, the moments' cotangents) and the moved running averages within
# 1e-5 of the absolute sum of its terms, the float32 sums' rounding, plus
# two float32 steps of its value (its own last roundings).
BN_RTOL, BN_ATOL, BN_SUMS = 2 ** -7, 1e-5, 1e-5
BATCH_NORM_FLAG = "--batch-norm"


def phase_batch_norm(dev) -> dict:
    """The BatchNorm kernels (``csrc/batch_norm.cu``): their build (each
    kernel's registers, shared memory and spills; a spill fails the
    phase), then at ``BN_SHAPES`` the kernels against their plain versions
    in training mode, every output (``BN_RTOL``, ``BN_ATOL``, ``BN_SUMS``)
    and, by :func:`device_ms`, the forward kernels
    (stats, norm) and the backward ones (bwd_reduce, bwd_dx) beside their
    bound (each input byte read once, each output byte written once, at
    3.35 TB/s), the two-pass design's bytes, the plain versions and
    torch's ``F.batch_norm`` (``library_ms``; the port never calls it)."""
    import torch.nn.functional as F
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    from horovod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(["batch_norm"])
    print(f"[batch_norm] build {time.perf_counter() - t0:.1f} s")
    spills = []
    for line in _build.build_logs.get("batch_norm", "(cached)").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line \
                or "cached" in line:
            print(f"[batch_norm] {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)) > 0:
            spills.append(line.strip())
    require(not spills, f"BatchNorm kernels spill registers: {spills}")
    rows, failed = [], []
    for name, shape in BN_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(17)
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        dy = torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        c = shape[1]
        w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        b = 0.1 * torch.randn(c, generator=g, device=dev)
        eps, bf = 1e-5, torch.bfloat16
        ra0 = (0.1 * torch.randn(c, generator=g, device=dev),
               1 + 0.1 * torch.randn(c, generator=g, device=dev).abs())
        out = {}
        for who, steps in (("kernels", sbn.KERNELS), ("plain", sbn.PLAIN)):
            rm, rv = ra0[0].clone(), ra0[1].clone()
            stats = steps["stats"](x)
            y = steps["norm"](x, stats, True, w, b, eps, bf, (rm, rv, 0.9))
            dw, db, dstats = steps["bwd_reduce"](dy, x, stats, True, w, eps)
            dx = steps["bwd_dx"](dy, x, stats, True, w, eps, dstats)
            out[who] = {"stats": stats, "y": y, "dweight": dw, "dbias": db,
                        "dstats": dstats, "dx": dx, "running_mean": rm,
                        "running_var": rv}
        # each sum's terms, summed in absolute value (per channel)
        dims = (0, 2, 3)
        x32, dy32 = x.float(), dy.float()
        mean = x32.mean(dims, keepdim=True)
        r = torch.rsqrt(x32.var(dims, unbiased=False) + eps)
        dyx = (dy32 * (x32 - mean)).abs().sum(dims)
        ddvar = 0.5 * w.abs() * r ** 3 * dyx
        batch = torch.stack((mean.flatten(), x32.var(dims, unbiased=False)))
        terms = {"stats": torch.stack((x32.abs().mean(dims),
                                       x32.square().mean(dims))),
                 "dweight": dyx * r, "dbias": dy32.abs().sum(dims),
                 "dstats": torch.stack((
                     (r * w).abs() * dy32.abs().sum(dims)
                     + 2 * mean.flatten().abs() * ddvar, ddvar))}
        for i, k in enumerate(("running_mean", "running_var")):
            terms[k] = 0.9 * ra0[i].abs() + 0.1 * batch[i].abs()
        got, want = out["kernels"], out["plain"]
        errs = {}
        for k in ("y", "dx"):
            err = (got[k].float() - want[k].float()).abs()
            errs[k] = (err / (BN_ATOL + BN_RTOL * want[k].float().abs())
                       ).max().item()
        f32 = torch.finfo(torch.float32).eps
        for k, t in terms.items():
            err = (got[k].float() - want[k].float()).abs()
            errs[k] = (err / (BN_SUMS * t + 2 * f32 * want[k].float().abs())
                       ).max().item()
        failed += [f"{name} {k}" for k, v in errs.items() if not v <= 1.0]
        stats, dstats = got["stats"], got["dstats"]
        xs = x.detach().requires_grad_()
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()

        def library():
            F.batch_norm(xs, rm, rv, wl, bl, True, 0.1, eps).backward(dy)

        runs = {
            "fwd_ms": lambda: sbn.norm_kernel(
                x, sbn.stats_kernel(x), True, w, b, eps, bf),
            "bwd_ms": lambda: sbn.bwd_dx_kernel(
                dy, x, stats, True, w, eps,
                sbn.bwd_reduce_kernel(dy, x, stats, True, w, eps)[2]),
            "plain_fwd_ms": lambda: sbn.norm_plain(
                x, sbn.stats_plain(x), True, w, b, eps, bf),
            "plain_bwd_ms": lambda: sbn.bwd_dx_plain(
                dy, x, stats, True, w, eps,
                sbn.bwd_reduce_plain(dy, x, stats, True, w, eps)[2]),
            "library_ms": library}
        times, kernels = {}, {}
        for key, fn in runs.items():
            times[key], named = device_ms(fn, 10)
            if key in ("fwd_ms", "bwd_ms"):
                kernels.update({k: v for k, v in named.items()
                                if "hvdbn" in k})
        for k, v in kernels.items():
            print(f"[batch_norm] {name}: {v:.4f} ms {k}")
        n = x.numel()
        row = {"name": name, "shape": list(shape), "dtype": "bf16",
               "layout": "channels_last", "errors": errs, **times,
               # each input read once, each output written once: forward
               # x and y, backward x, dy and dx; two passes: x twice
               # forward, x and dy twice backward
               "bound_fwd_ms": 4 * n / HBM_BYTES_PER_S * 1e3,
               "bound_bwd_ms": 6 * n / HBM_BYTES_PER_S * 1e3,
               "two_pass_fwd_ms": 6 * n / HBM_BYTES_PER_S * 1e3,
               "two_pass_bwd_ms": 10 * n / HBM_BYTES_PER_S * 1e3}
        rows.append(row)
        print(f"[batch_norm] {name} {tuple(shape)} bf16 channels-last: "
              f"forward {row['fwd_ms']:.3f} ms (bound "
              f"{row['bound_fwd_ms']:.3f}, two-pass "
              f"{row['two_pass_fwd_ms']:.3f}, plain "
              f"{row['plain_fwd_ms']:.3f}); backward {row['bwd_ms']:.3f} "
              f"ms (bound {row['bound_bwd_ms']:.3f}, two-pass "
              f"{row['two_pass_bwd_ms']:.3f}, plain "
              f"{row['plain_bwd_ms']:.3f}); F.batch_norm forward and "
              f"backward {row['library_ms']:.3f} ms; errors against the "
              f"plain version as shares of the limit {errs}")
    require(not failed, f"BatchNorm kernels disagree with the plain "
            f"versions: {failed}")
    return {"batch_norm": rows}


def by_slice(fn, *args):
    """``fn(*args)`` one slice of dim 0 (bh) of the tensor arguments at a
    time, the results concatenated: a plain version's (sq, sk) score
    matrices of a long block then fit on the card."""
    bh = next(a for a in args if torch.is_tensor(a)).shape[0]
    parts = [fn(*(a[i:i + 1] if torch.is_tensor(a) else a for a in args))
             for i in range(bh)]
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _block_inputs(g, dev, dtype, bh, sq, sk, d, qpos0, kpos0, causal,
                  dv=None):
    """Seeded (q, k, v) with q pre-scaled, the forward's lse and out, and a
    random float32 dout with D = rowsum(dout * out); v of width ``dv``
    (``d`` by default)."""
    from horovod_tpu_torch.ops import flash
    dv = dv or d
    q = (torch.randn((bh, sq, d), generator=g, device=dev)
         / math.sqrt(d)).to(dtype)
    k = torch.randn((bh, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((bh, sk, dv), generator=g, device=dev).to(dtype)
    carries = (torch.full((bh, sq, 1), flash.NEG_INF, device=dev),
               torch.zeros((bh, sq, 1), device=dev),
               torch.zeros((bh, sq, dv), device=dev))
    m, l, acc = by_slice(flash.attend_plain, q, k, v, qpos0, kpos0, causal,
                         *carries)
    l_safe = l.clamp_min(1e-30)
    lse = m + torch.log(l_safe)
    dout = torch.randn((bh, sq, dv), generator=g, device=dev)
    D = (dout * (acc / l_safe)).sum(-1, keepdim=True)
    return q, k, v, carries, lse, dout, D


def _row_errs(got, want) -> torch.Tensor:
    """The error of each row (a query's or a key's d-vector) relative to
    that row's norm in the plain result, so that a tile of the grid whose
    values are small cannot be wrong unseen."""
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    return diff / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)


def _row_rel_err(got, want) -> float:
    return _row_errs(got, want).max().item()


def _fwd_errs(got, want) -> dict:
    """Errors of the values the model consumes: the normalized output
    acc / l (max abs and per row relative), and the carry m and lse =
    m + log l (max abs)."""
    (m1, l1, a1), (m2, l2, a2) = got, want
    o1, o2 = a1 / l1.clamp_min(1e-30), a2 / l2.clamp_min(1e-30)
    lse1 = m1 + torch.log(l1.clamp_min(1e-30))
    lse2 = m2 + torch.log(l2.clamp_min(1e-30))
    return {"out_abs": (o1 - o2).abs().max().item(),
            "out_row_rel": _row_rel_err(o1, o2),
            "m_abs": (m1 - m2).abs().max().item(),
            "lse_abs": (lse1 - lse2).abs().max().item()}


def _rounded_grad_errs(name, rows) -> dict:
    """Summary of the per-row errors of a gradient whose ds is rounded to
    bf16 inside the function (dq, dk): the largest, the 90th percentile,
    and how many rows exceed 1e-3."""
    return {f"{name}_row_rel": rows.max().item(),
            f"{name}_row_rel_p90": torch.quantile(rows.flatten(), 0.9).item(),
            f"{name}_rows_over_1e-3": int((rows > 1e-3).sum())}


def _dq_errs(got, want, sq, sk, qpos0, kpos0, causal) -> dict:
    """Per-row errors of dq, as of dk. A query row that sees one key has
    dq = 0 in exact arithmetic (its one softmax weight is 1 whatever q is),
    and both versions compute fp32 noise of (dp - D) . k there, so its
    error is absolute; every other row's is relative to its plain row."""
    from horovod_tpu_torch.ops import flash
    one = flash.live_keys(sq, sk, qpos0, kpos0, causal, got.device) == 1
    rows = torch.where(one, torch.linalg.vector_norm(got - want, dim=-1),
                       _row_errs(got, want))
    return _rounded_grad_errs("dq", rows)


def _dkv_errs(got, want) -> dict:
    """Per-row relative errors of dk (as of dq) and of dv (the largest)."""
    (dk, dv), (dk_p, dv_p) = got, want
    return {**_rounded_grad_errs("dk", _row_errs(dk, dk_p)),
            "dv_row_rel": _row_rel_err(dv, dv_p)}


def _failures(name, errs, where, skip=(), limits=None) -> list:
    """Print one kernel's errors beside their limits (``limits``, by default
    ``TRAINING_LIMITS``; but those in ``skip``) and return the keys that
    exceed them."""
    lim = {k: x for k, x in (limits or TRAINING_LIMITS)[name].items()
           if k not in skip}
    print(f"[{where}] {name}: " + ", ".join(
        f"{key} {errs[key]:.4g}" + (f" (limit {lim[key]:g})" if key in lim
                                    else "") for key in errs))
    return [f"{name} {key}" for key in lim if not errs[key] <= lim[key]]


def _max_err(got, want):
    return max((x - y).abs().max().item() for x, y in zip(got, want))


# Limits at the training shape (bh 64, s 2048, d 64, bf16, causal), each set
# from the error an H100 run of the kernels showed (chip_smoke.py, H100 80GB
# HBM3 at 700 W). The row limits are relative to each query's or key's own
# row, so a kernel wrong on any tile fails however small that tile's values
# are. Where a bf16 rounding sits inside the function, kernel and plain
# version may round one entry to neighbouring bf16 values (2^-8 to 2^-7
# apart), and a row fed by few entries then differs by up to that much:
# K1 rounds p against its running row max, the plain version against the
# block's max; K2 and K3 (tensor cores) sum s = q . k^T in another order
# than the plain version's fp32 matmul, so ds = p (dp - D) sometimes rounds
# to the other neighbour before dq = ds . k and dk = ds^T . q. Those rows
# take 1e-2. dv has no rounding inside (p and dO enter as bf16 pairs, about
# 16 bits each).
TRAINING_LIMITS = {
    "flash_fwd": {"out_abs": 5e-3,       # measured 1.57e-3
                  "out_row_rel": 1e-2,   # measured 3.45e-3
                  "m_abs": 1e-4,         # measured 1.43e-6
                  "lse_abs": 1e-4},      # measured 9.5e-7
    "flash_bwd_dq": {"dq_row_rel": 1e-2,         # measured 3.43e-3
                     "dq_row_rel_p90": 1e-4,     # measured 2.53e-6
                     "dq_rows_over_1e-3": 131},  # measured 60
    "flash_bwd_dkv": {"dk_row_rel": 1e-2,   # measured 4.28e-3
                      "dk_row_rel_p90": 1e-4,     # measured 3.75e-6
                      "dk_rows_over_1e-3": 131,   # measured 56
                      "dv_row_rel": 1e-3},  # measured 1.87e-5
}
# The bulk of dq and dk: a flipped bf16(ds) moves a row past 1e-3 only
# where few keys (dq) or queries (dk) feed it, so nine rows in ten stay
# within 1e-4, and at most one row in a thousand (131 of the 131072)
# exceeds 1e-3. A K3 whose dp took dO in two bf16 parts instead of three
# gave 186 such dk rows here, and a 90th-percentile row of 1.1e-4 to
# 1.2e-4 at the non-causal 2047 x 2049 tile-edge shapes (3.8e-5 with three
# parts); a K2 so built gave a 90th-percentile dq row above 1e-4 there too
# (1.12e-4 at d 128; 3.4e-5 with three parts).

# Each kernel's design.
DESIGNS = {
    "flash_fwd": "bf16 wgmma (q.k^T from shared memory, p.v with p from "
                 "registers) fed by a 2-stage TMA ring of 128B-swizzled "
                 "tiles; 128 query rows x 128 keys (64 at d=128) a step, 2 "
                 "consumer warpgroups + 1 producer warp",
    "flash_bwd_dq": "bf16 wgmma for all three products (fp32 dO split once "
                    "into 3 bf16 parts: 5 products a tile) with K/V fed by "
                    "a 3-stage TMA ring (2 at d=128); 64 query rows per "
                    "consumer warpgroup (2 at d=64, 1 at d=128) + 1 "
                    "producer warp",
    "flash_bwd_dkv": "bf16 wgmma for all four products (fp32 dO split into "
                     "3 bf16 parts, p into 2: 8 products a tile) fed by a "
                     "3-stage TMA ring (2 at d=128); 64 keys per consumer "
                     "warpgroup + a producer warpgroup that also splits dO "
                     "(setmaxnreg)",
}


# The bf16 tile-edge phase: shapes (sq, sk, qpos0, kpos0) that end one row
# before, one row after, or inside a tile of the tensor-core kernels, one
# whose first 70 query rows see no key under causal masking, and one whose
# first 200 query rows (whole query tiles of K2) see none.
TILE_EDGE_SHAPES = ((63, 65, 0, 0), (129, 127, 0, 0), (2047, 2049, 0, 0),
                    (130, 200, 0, 70), (300, 40, 0, 200))


def phase_tile_edges(dev) -> dict:
    """The bf16 tensor-core kernels (K1, K2, K3) against their plain
    versions at the tile-edge shapes, d 64 and 128, causal and not; K1 from
    random incoming carries. Each shape is held to the limits of the
    training shape but those set for its scale: K1's ``out_abs`` (acc / l
    from random carries is not of the training output's scale) and the
    counts of dq and dk rows over 1e-3 (131 of 131072 rows; a row in a
    thousand would allow none here, where every row may be fed by a few
    hundred keys or queries or fewer). Returns the worst reading of each
    kernel's errors."""
    from horovod_tpu_torch.ops import flash
    g = torch.Generator(device=dev).manual_seed(2)
    worst, failed = {n: {} for n in TRAINING_LIMITS}, []
    for d in (64, 128):
        for sq, sk, qpos0, kpos0 in TILE_EDGE_SHAPES:
            for causal in (True, False):
                q, k, v, _, lse, dout, D = _block_inputs(
                    g, dev, torch.bfloat16, 2, sq, sk, d, qpos0, kpos0,
                    causal)
                carries = (torch.randn((2, sq, 1), generator=g, device=dev),
                           torch.rand((2, sq, 1), generator=g, device=dev),
                           torch.randn((2, sq, d), generator=g, device=dev))
                args = (q, k, v, qpos0, kpos0, causal, *carries)
                errs = {"flash_fwd": _fwd_errs(flash._launch_fwd(*args),
                                               flash.attend_plain(*args))}
                args = (q, k, v, lse, dout, D, qpos0, kpos0, causal)
                errs["flash_bwd_dq"] = _dq_errs(
                    flash._launch_bwd_dq(*args), flash.plain_bwd_dq(*args),
                    sq, sk, qpos0, kpos0, causal)
                errs["flash_bwd_dkv"] = _dkv_errs(flash._launch_bwd_dkv(*args),
                                                  flash.plain_bwd_dkv(*args))
                torch.cuda.synchronize()
                where = (f"tile-edge d={d} sq={sq} sk={sk} qpos0={qpos0} "
                         f"kpos0={kpos0} causal={causal} bf16")
                for n, e in errs.items():
                    failed += [f"{where}: {f}" for f in _failures(
                        n, e, where, skip=("out_abs", "dq_rows_over_1e-3",
                                           "dk_rows_over_1e-3"))]
                    for key, x in e.items():
                        worst[n][key] = max(worst[n].get(key, 0), x)
    print(f"[tile-edge] worst readings {worst}")
    require(not failed, f"tile-edge shapes disagree with their plain "
            f"versions: {failed}")
    return worst


def hold_training_kernels(g, dev, where: str):
    """K1, K2 and K3 at the trainer's shape (bh 64, s 2048, d 64, bf16,
    causal) against their plain versions on the same inputs, within
    ``TRAINING_LIMITS``: the errors, and the inputs."""
    from horovod_tpu_torch.ops import flash
    bh, s, d, dtype = BATCH * 8, SEQ, 64, torch.bfloat16
    q, k, v, carries, lse, dout, D = _block_inputs(g, dev, dtype, bh, s, s,
                                                   d, 0, 0, True)
    args = (q, k, v, lse, dout, D, 0, 0, True)
    fwd_k = flash.block_attend(q, k, v, 0, 0, True, *carries)
    fwd_p = flash.attend_plain(q, k, v, 0, 0, True, *carries)
    errs = {"flash_fwd": _fwd_errs(fwd_k, fwd_p)}
    del fwd_k, fwd_p
    dq, dq_p = flash._launch_bwd_dq(*args), flash.plain_bwd_dq(*args)
    errs["flash_bwd_dq"] = {"abs": (dq - dq_p).abs().max().item(),
                            **_dq_errs(dq, dq_p, s, s, 0, 0, True)}
    del dq, dq_p
    got, want = flash._launch_bwd_dkv(*args), flash.plain_bwd_dkv(*args)
    errs["flash_bwd_dkv"] = {"abs": _max_err(got, want),
                             **_dkv_errs(got, want)}
    del got, want
    torch.cuda.synchronize()
    where = f"{where} bh={bh} s={s} d={d} bf16 causal"
    failed = [f for n, e in errs.items() for f in _failures(n, e, where)]
    require(not failed, f"kernels disagree with their plain versions: "
            f"{failed}")
    return errs, (q, k, v, carries, lse, dout, D)


def phase_kernels(dev):
    from horovod_tpu_torch.ops import flash
    g = torch.Generator(device=dev).manual_seed(1)
    # awkward shape: ragged, offset, float32 - against the plain version
    awkward_tol, awkward_err = 1e-4, {}
    for causal in (True, False):
        q, k, v, carries, lse, dout, D = _block_inputs(
            g, dev, torch.float32, 2, 13, 11, 64, 3, 0, causal)
        e_f = _max_err(flash.block_attend(q, k, v, 3, 0, causal, *carries),
                       flash.attend_plain(q, k, v, 3, 0, causal, *carries))
        e_b = _max_err(flash.flash_block_grads(q, k, v, lse, dout, D, 3, 0,
                                               causal),
                       flash.plain_block_grads(q, k, v, lse, dout, D, 3, 0,
                                               causal))
        torch.cuda.synchronize()
        print(f"[kernels] awkward sq=13 sk=11 qpos0=3 d=64 float32 "
              f"causal={causal}: fwd err {e_f:.3g}, bwd err {e_b:.3g} "
              f"(tolerance {awkward_tol:g})")
        require(e_f <= awkward_tol and e_b <= awkward_tol,
                f"awkward-shape kernels disagree (causal={causal})")
        awkward_err["fwd"] = max(awkward_err.get("fwd", 0.0), e_f)
        awkward_err["bwd"] = max(awkward_err.get("bwd", 0.0), e_b)

    # the training shape
    bh, s, d, dtype = BATCH * 8, SEQ, 64, torch.bfloat16
    errs, (q, k, v, carries, lse, dout, D) = hold_training_kernels(
        g, dev, "kernels")
    args = (q, k, v, lse, dout, D, 0, 0, True)

    times = {
        "flash_fwd": (lambda: flash._launch_fwd(q, k, v, 0, 0, True,
                                                *carries),
                      lambda: flash.attend_plain(q, k, v, 0, 0, True,
                                                 *carries)),
        "flash_bwd_dq": (lambda: flash._launch_bwd_dq(*args),
                         lambda: flash.plain_bwd_dq(*args)),
        "flash_bwd_dkv": (lambda: flash._launch_bwd_dkv(*args),
                          lambda: flash.plain_bwd_dkv(*args)),
    }
    ms = {n: (time_ms(kern, 10), time_ms(plain, 5))
          for n, (kern, plain) in times.items()}

    # library yardstick: one scaled_dot_product_attention call, forward and
    # backward (the backward computes dq, dk and dv together)
    F = torch.nn.functional
    q4, k4, v4 = (t.view(BATCH, 8, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=1.0), 10)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=1.0)
    dout4 = dout.view(BATCH, 8, s, d).to(dtype)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), dout4, retain_graph=True), 10)

    pairs = bh * unmasked_pairs(s, s, 0, 0, True)
    qkv_bytes = 3 * bh * s * d * q.element_size()
    carry_bytes = bh * s * (d + 2) * 4
    grad_in = qkv_bytes + bh * s * (d + 2) * 4  # + dout, lse, D (fp32)
    work = {
        "flash_fwd": (4 * d * pairs, qkv_bytes + 2 * carry_bytes),
        "flash_bwd_dq": (6 * d * pairs, grad_in + bh * s * d * 4),
        "flash_bwd_dkv": (8 * d * pairs, grad_in + 2 * bh * s * d * 4),
    }
    meta = {
        "flash_fwd": ("csrc/flash_fwd.cu", "horovod_tpu/ops/flash.py:97",
                      lib_fwd, "scaled_dot_product_attention forward"),
        "flash_bwd_dq": ("csrc/flash_bwd_dq.cu",
                         "horovod_tpu/ops/flash.py:268", lib_bwd,
                         "scaled_dot_product_attention backward (dq, dk, dv)"),
        "flash_bwd_dkv": ("csrc/flash_bwd_dkv.cu",
                          "horovod_tpu/ops/flash.py:294", lib_bwd,
                          "scaled_dot_product_attention backward (dq, dk, dv)"),
    }
    rows = []
    for n in times:
        flops, nbytes = work[n]
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        src, replaces, lib_ms, lib_call = meta[n]
        rows.append({
            "name": n, "route": "cuda", "source": "horovod_tpu_torch/" + src,
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[n].get("out_abs", errs[n].get("abs")),
            "errors": errs[n],
            "awkward_max_abs_err": awkward_err[
                "fwd" if n == "flash_fwd" else "bwd"],
            "ms": ms[n][0], "plain_ms": ms[n][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "library_ms": lib_ms, "library_call": lib_call,
            "design": DESIGNS[n],
            "shape": f"bh={bh} s={s} d={d} bf16 causal"})
        print(f"[kernels] {n}: {ms[n][0]:.3f} ms (plain {ms[n][1]:.3f} ms, "
              f"library {lib_ms:.3f} ms, bound {bound_ms:.3f} ms by "
              f"{bound_by})")
    return rows


MLA_KERNELS_FLAG = "--mla-kernels"

# The row limits of tests/test_torch_cuda.py's bf16 kernel tests, which the
# multi-head latent attention widths are held to at every shape: each row of
# acc / l, dq and dk within 1e-2 of its plain row (a bf16 rounding of p or
# ds inside the function may go to the neighbouring value), dv within 1e-3,
# and dq's and dk's 90th-percentile rows within 1e-4.
MLA_LIMITS = {"flash_fwd": {"out_row_rel": 1e-2},
              "flash_bwd_dq": {"dq_row_rel": 1e-2, "dq_row_rel_p90": 1e-4},
              "flash_bwd_dkv": {"dk_row_rel": 1e-2, "dk_row_rel_p90": 1e-4,
                                "dv_row_rel": 1e-3}}


def phase_mla_kernels(dev, bh: int = 64, s: int = 8192,
                      held: int = 2) -> dict:
    """K1-K3 at multi-head latent attention's widths (q and k 192, v 128)
    at the Moonlight cell's shape, s 8192, bf16, causal. First ``held``
    heads against the plain versions (each head's plain (s, s) float32
    scores take 268 MB), within ``MLA_LIMITS``; the phase fails on any
    miss. Then, at the cell's bh 64, each kernel's time from CUDA events
    over 10 launches, its bound (unmasked pairs, each input read and each
    output written once), the block's threads and shared memory, and the
    library's yardstick (``scaled_dot_product_attention``, forward and
    forward + backward, which the port never calls). Alone on the card:
    ``python3 chip_smoke.py --mla-kernels``."""
    from horovod_tpu_torch.ops import _build, flash
    dqk, dv = 192, 128
    flash.reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, carries, lse, dout, D = _block_inputs(
        g, dev, torch.bfloat16, held, s, s, dqk, 0, 0, True, dv=dv)
    fwd = flash.block_attend(q, k, v, 0, 0, True, *carries)
    plain = by_slice(flash.attend_plain, q, k, v, 0, 0, True, *carries)
    errs = {"flash_fwd": _fwd_errs(fwd, plain)}
    del fwd, plain
    args = (q, k, v, lse, dout, D, 0, 0, True)
    got = flash.flash_block_grads(*args)
    want = by_slice(flash.plain_block_grads, *args)
    errs["flash_bwd_dq"] = _dq_errs(got[0], want[0], s, s, 0, 0, True)
    errs["flash_bwd_dkv"] = _dkv_errs(got[1:], want[1:])
    del got, want
    torch.cuda.synchronize()
    where = f"mla_kernels bh={held} s={s} d={dqk}/{dv} bf16 causal"
    failed = [f for n, e in errs.items()
              for f in _failures(n, e, where, limits=MLA_LIMITS)]
    ran = dict(flash.launches)
    require(all(ran.values()), f"{where}: a kernel did not launch: {ran}")
    require(not failed, f"K1-K3 at {dqk}/{dv} disagree with their plain "
            f"versions: {failed}")
    out = {"errors": errs}

    g = torch.Generator(device=dev).manual_seed(4)
    q = (torch.randn(bh, s, dqk, device=dev, generator=g)
         / dqk ** 0.5).bfloat16()
    k = torch.randn(bh, s, dqk, device=dev, generator=g).bfloat16()
    v = torch.randn(bh, s, dv, device=dev, generator=g).bfloat16()
    carries = (torch.full((bh, s, 1), flash.NEG_INF, device=dev),
               torch.zeros((bh, s, 1), device=dev),
               torch.zeros((bh, s, dv), device=dev))
    m, l, acc = flash.block_attend(q, k, v, 0, 0, True, *carries)
    l = l.clamp_min(1e-30)
    dout = torch.randn(bh, s, dv, device=dev, generator=g)
    args = (q, k, v, m + torch.log(l), dout,
            (dout * acc / l).sum(-1, keepdim=True), 0, 0, True)
    pairs = bh * unmasked_pairs(s, s, 0, 0, True)
    qkv = bh * s * (2 * dqk + dv) * 2
    grad_in = qkv + bh * s * (dv + 2) * 4
    runs = {"flash_fwd": (lambda: flash.block_attend(q, k, v, 0, 0, True,
                                                     *carries),
                          2 * (dqk + dv), qkv + 2 * bh * s * (dv + 2) * 4),
            "flash_bwd_dq": (lambda: flash._launch_bwd_dq(*args),
                             4 * dqk + 2 * dv, grad_in + bh * s * dqk * 4),
            "flash_bwd_dkv": (lambda: flash._launch_bwd_dkv(*args),
                              4 * (dqk + dv),
                              grad_in + bh * s * (dqk + dv) * 4)}
    for name, (fn, per_pair, nbytes) in runs.items():
        ms = time_ms(fn, 10)
        bound_ms, by = bound(per_pair * pairs, nbytes, torch.bfloat16)
        threads, smem = _launch_config(_build.load(name), name, dqk, True)
        out[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                     "threads": threads, "smem": smem}
        print(f"[mla_kernels] {name}: {ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"by {by}, {threads} threads, {smem} B shared memory")
    F = torch.nn.functional
    q4, k4 = (t.view(4, bh // 4, s, dqk).detach().requires_grad_()
              for t in (q, k))
    v4 = v.view(4, bh // 4, s, dv).detach().requires_grad_()
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    o4 = sdpa()
    go = torch.randn_like(o4)
    out["library_fwd_ms"] = time_ms(sdpa, 10)
    out["library_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        sdpa(), (q4, k4, v4), go), 5)
    print(f"[mla_kernels] library: forward {out['library_fwd_ms']:.3f} ms, "
          f"forward and backward {out['library_fwd_bwd_ms']:.3f} ms")
    return out


def phase_reference(dev):
    """The model's flash path (kernels, float32) against its plain
    attention path on the same weights and a small input."""
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    cfg = dict(num_layers=1, max_seq_len=256, dtype=torch.float32)
    flash_lm = TransformerLM(TransformerConfig(attn_mode="ulysses", **cfg),
                             device=dev)
    flash_lm.reset_parameters(torch.Generator().manual_seed(3))
    full_lm = TransformerLM(TransformerConfig(attn_mode="full", **cfg),
                            device=dev)
    full_lm.load_state_dict(flash_lm.state_dict())
    tokens = torch.from_numpy(synthetic_tokens(2, 256, 32000, 3)).to(dev)
    with torch.no_grad():
        got, want = flash_lm(tokens), full_lm(tokens)
    err = (got - want).abs().max().item()
    print(f"[reference] float32 logits (2, 256, 32000), flash vs plain "
          f"attention: max abs err {err:.3g} (tolerance 1e-3)")
    require(got.shape == (2, 256, 32000) and torch.isfinite(got).all().item(),
            "reference logits are not finite of the expected shape")
    require(err <= 1e-3, "flash path disagrees with plain attention")


def _train_step(model, opt, tokens) -> float:
    from horovod_tpu_torch.models import lm_loss
    opt.zero_grad()
    loss = lm_loss(model(tokens), tokens)
    with torch.profiler.record_function("backward"):  # a profile's marker
        loss.backward()
    opt.step()
    return loss.item()


# Kinds of device work in a profiled step, by kernel name (first match).
PROFILE_KINDS = (
    ("flash kernels (the port's K1, K2, K3)", ("hvdflash",)),
    ("nccl", ("nccl",)),
    ("convolution and GEMM (cuDNN, cuBLAS)",
     ("conv", "cudnn", "xmma", "gemm", "sm90_", "sm80_", "cutlass", "nvjet",
      "implicit", "wgrad", "dgrad", "fprop")),
    ("pooling", ("pool",)),
    ("reductions (BatchNorm moments, their gradients, loss)",
     ("reduce", "softmax", "nll")),
    ("copies, casts and concatenation (pack/unpack, dtype casts)",
     ("copy", "cat", "fill", "memcpy", "memset")),
    ("optimizer (fused multi-tensor)", ("multi_tensor",)),
    ("elementwise (BatchNorm normalize, ReLU, adds)", ("elementwise",)),
)


def _profile_step(step, overlap: bool = False,
                  kinds=PROFILE_KINDS) -> dict:
    """One more training step under ``torch.profiler``: device time by
    kernel, by kind of work (``kinds``), and the device's busy
    share of the step's wall time. With ``overlap``, also whether the
    gradient allreduce's NCCL kernels started before the backward pass's
    last kernel ended (``testing.backward_overlap``). Returns those
    numbers."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from horovod_tpu_torch import testing
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    found = None
    if overlap:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            found = testing.backward_overlap(path)
        print(f"[profile] backward pass and gradient allreduce: {found}")
    # device kernels and copies; user annotations (e.g. "Optimizer.step")
    # span kernels already counted
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))
              and not getattr(e, "is_user_annotation", False)]
    kernels = sorted(events, key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] one step: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for e in kernels[:12]:
        print(f"[profile] {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    by_kind: dict = {}
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, words in kinds
                     if any(w in name for w in words)), "other")
        ms, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] by kind: {ms:8.3f} ms x{n:<5d} "
              f"({100 * ms / busy_ms:.1f} % of busy) {kind}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "overlap": found,
            "kinds": {k: ms for k, (ms, _) in by_kind.items()},
            "flash_kernels": _flash_named(kernels)}


def _flash_named(events) -> dict:
    """K1-K3's device launches among a profile's kernel events, counted
    by the kernels' names (``hvdflash``)."""
    return {name: sum(e.count for e in events
                      if "hvdflash" in e.key and name in e.key)
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def _bucket_report(opt) -> dict:
    stats = opt.stats
    return {"buckets": len(stats["bucket_bytes"]),
            "bucket_mb": [round(b / 1e6, 3) for b in stats["bucket_bytes"]],
            "started_in_backward": list(stats["started_in_backward"])}


def phase_trainer(dev):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    from horovod_tpu_torch.ops import flash
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    cfg = TransformerConfig(attn_mode="ulysses")  # full-width defaults
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))
    tokens = torch.from_numpy(
        synthetic_tokens(BATCH, SEQ, cfg.vocab_size, 0)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    flash.reset_launch_counts()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(_train_step(model, opt, tokens))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(flash.launches)
    buckets = _bucket_report(opt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _profile_step(lambda: _train_step(model, opt, tokens),
                            overlap=True)
    steady = sum(step_s[1:]) / (STEPS - 1)
    print(f"[trainer] TransformerLM {n_params / 1e6:.1f} M params, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads, vocab {cfg.vocab_size}, bf16, ulysses; batch {BATCH} x "
          f"{SEQ} tokens; NCCL world 1")
    print(f"[trainer] losses {['%.4f' % x for x in losses]}")
    print(f"[trainer] step time {steady * 1e3:.1f} ms (mean of steps 2-"
          f"{STEPS}; step 1 {step_s[0] * 1e3:.1f} ms), "
          f"{BATCH * SEQ / steady:.0f} tokens/s, peak memory "
          f"{peak:.2f} GiB on {torch.cuda.get_device_name(0)}")
    print(f"[trainer] gradient buckets {buckets['bucket_mb']} MB; buckets "
          "started by the gradient hooks before backward() returned, per "
          f"step: {buckets['started_in_backward']}")
    print(f"[trainer] kernel launches {launches}")
    require(all(math.isfinite(x) for x in losses), "loss is not finite")
    require(losses[-1] < losses[0], "loss did not fall")
    want = cfg.num_layers * STEPS
    require(all(v == want for v in launches.values()),
            f"launch counts {launches}, want {want} each")
    require(buckets["buckets"] >= 3,
            f"{buckets['buckets']} gradient buckets, want at least 3")
    require(min(buckets["started_in_backward"]) >= 1,
            "a step started no bucket before backward() returned")
    del model, opt
    hvd.shutdown()
    torch.cuda.empty_cache()
    run = {"step_ms": steady * 1e3, "tokens_per_s": BATCH * SEQ / steady,
           "peak_memory_gib": peak, "losses": losses, "step_s": step_s,
           "profile": profile, **buckets}
    k2, k2_launches = phase_trainer_k2(dev)
    return launches, k2_launches, {"hooks": run, "k2_sparse": k2}


K2_AGREEMENT = 1e-5  # relative, the parameters' norm


def _lm_grads(model, tokens) -> tuple[list, float]:
    from horovod_tpu_torch.models import lm_loss
    model.zero_grad()
    loss = lm_loss(model(tokens), tokens)
    loss.backward()
    return [p.grad.clone() for p in model.parameters()], loss.item()


def _rel_diff(params, ref) -> float:
    num = sum((p.detach().float() - q.float()).pow(2).sum()
              for p, q in zip(params, ref))
    return math.sqrt(num.item() / sum(q.float().pow(2).sum()
                                      for q in ref).item())


def phase_trainer_k2(dev):
    """The trainer again from the same initial weights, through
    ``DistributedOptimizer(backward_passes_per_step=2)`` with the token
    embedding on the sparse path: 2 x STEPS backward passes, one on each
    half of the batch. Every odd pass leaves the parameters as they were;
    the first full step agrees with one plain Adam step on the mean of the
    same two halves' gradients."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    from horovod_tpu_torch.ops import flash
    hvd.init()
    cfg = TransformerConfig(attn_mode="ulysses")
    tokens = torch.from_numpy(
        synthetic_tokens(BATCH, SEQ, cfg.vocab_size, 0)).to(dev)
    halves = tokens.chunk(2)
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    # the dense reference: one Adam step on the mean of the halves' grads
    ref = TransformerLM(cfg, device=dev)
    ref.load_state_dict(model.state_dict())
    g1, _ = _lm_grads(ref, halves[0])
    g2, _ = _lm_grads(ref, halves[1])
    ref_opt = torch.optim.Adam(ref.parameters(), lr=1e-3)
    for p, a, b in zip(ref.parameters(), g1, g2):
        p.grad = a + (b - a) / 2  # MultiSteps' running mean of two
    ref_opt.step()
    want = [p.detach().clone() for p in ref.parameters()]
    start = [p.detach().clone() for p in model.parameters()]
    del ref, ref_opt, g1, g2
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2, sparse_gradient_paths=["^embed\\."],
        sparse_max_rows=BATCH * SEQ)
    require(opt.stats["sparse_rows"] == [BATCH * SEQ],
            "the token embedding is not on the sparse path")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    losses, pass_s, agreement = [], [], None
    for i in range(2 * STEPS):
        before = ([p.detach().clone() for p in model.parameters()]
                  if i % 2 == 0 else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_train_step(model, opt, halves[i % 2]))
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
        if before is not None:
            require(all(torch.equal(p, q) for p, q in
                        zip(model.parameters(), before)),
                    f"pass {i + 1} (a folding pass) changed the parameters")
        if i == 1:
            agreement = _rel_diff(model.parameters(), want)
            moved = _rel_diff(want, start)
    launches = dict(flash.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    buckets = _bucket_report(opt)
    del model, opt, want, start
    hvd.shutdown()
    torch.cuda.empty_cache()
    step_s = [pass_s[i] + pass_s[i + 1] for i in range(0, 2 * STEPS, 2)]
    steady = sum(step_s[1:]) / (STEPS - 1)
    step_losses = [(losses[i] + losses[i + 1]) / 2
                   for i in range(0, 2 * STEPS, 2)]
    print(f"[trainer k=2] backward_passes_per_step=2, embed.weight on the "
          f"sparse path ({BATCH * SEQ} rows); {2 * STEPS} passes of "
          f"{BATCH // 2} x {SEQ} tokens")
    print(f"[trainer k=2] pass losses {['%.4f' % x for x in losses]}")
    print(f"[trainer k=2] step time {steady * 1e3:.1f} ms (two passes; mean "
          f"of steps 2-{STEPS}; step 1 {step_s[0] * 1e3:.1f} ms), "
          f"{BATCH * SEQ / steady:.0f} tokens/s, peak memory {peak:.2f} GiB")
    print(f"[trainer k=2] first step against one Adam step on the mean of "
          f"the two halves' gradients: relative difference {agreement:.3e} "
          f"of the parameters' norm (limit {K2_AGREEMENT:g}; the step "
          f"itself moved them {moved:.3e})")
    print(f"[trainer k=2] buckets started before backward() returned, per "
          f"step: {buckets['started_in_backward']}; kernel launches "
          f"{launches}")
    require(all(math.isfinite(x) for x in losses), "k=2: loss is not finite")
    require(step_losses[-1] < step_losses[0], "k=2: loss did not fall")
    want_launches = cfg.num_layers * 2 * STEPS
    require(all(v == want_launches for v in launches.values()),
            f"k=2: launch counts {launches}, want {want_launches} each")
    require(agreement <= K2_AGREEMENT,
            f"k=2: first step {agreement:.3e} from the dense mean step")
    require(len(buckets["started_in_backward"]) == STEPS
            and min(buckets["started_in_backward"]) >= 1,
            "k=2: a step started no bucket before backward() returned")
    return {"step_ms": steady * 1e3, "tokens_per_s": BATCH * SEQ / steady,
            "peak_memory_gib": peak, "losses": losses, "pass_s": pass_s,
            "agreement": agreement, "step_moved": moved, **buckets}, launches


# The MoE phase's first-step logits against the dense TransformerLM on the
# same weights, expert 0 as its MLP (float32 (8, 2048, 32000) from bf16
# compute): with one expert the gate is exactly 1 and the MoE FFN is the
# dense MLP run on a 20480-row bucket, so the two differ only where cuBLAS
# picks another GEMM for the taller operand; held to the limits the
# long-context phase holds its bf16 modes' logits to.
MOE_LOGITS_AGREEMENT = {"max_abs": 0.25, "mean_abs": 1e-2}
# Kinds of device work in a profiled MoE step: the dispatch and combine
# (the slot positions' cumsum, index_add into the buckets, index_select
# back; the two embedding lookups are index_selects too), then
# PROFILE_KINDS.
MOE_PROFILE_KINDS = (
    ("MoE dispatch and combine (cumsum, index_add, index_select)",
     ("indexfunc", "indexselect", "cumsum", "scan")),) + PROFILE_KINDS


ADASUM_AGREEMENT = 1e-5  # max abs error over the largest |value|


def _adasum_plain(a, b, sizes) -> torch.Tensor:
    """The combine of one VHDD level in float64, tensor by tensor (the
    plain version of ``ops.adasum.combine``)."""
    out = []
    for x, y in zip(a.double().split(sizes), b.double().split(sizes)):
        dot, na, nb = (x * y).sum(), (x * x).sum(), (y * y).sum()
        ac = 1 - dot / (2 * na) if na > 0 else 1.0
        bc = 1 - dot / (2 * nb) if nb > 0 else 1.0
        out.append(ac * x + bc * y)
    return torch.cat(out)


def _kv_round_ms(rounds: int = 50) -> float:
    """Mean time of one negotiation round of two members over the port's
    KV store on this host (both members in this process, one thread
    each)."""
    import threading
    from horovod_tpu_torch.runner.http_kv import (KVClient, KVServer,
                                                  make_secret)
    from horovod_tpu_torch.engine_service import KVTransport
    server = KVServer(secret=make_secret(), host="127.0.0.1")
    port = server.start()
    try:
        members = [KVTransport(KVClient("127.0.0.1", port,
                                        secret=server.secret), 2, r)
                   for r in range(2)]
        errors = []

        def run(t):
            try:
                for c in range(rounds):
                    t.exchange(c, b"x" * 64, b"\x01", 60.0)
            except Exception as e:  # re-raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(t,)) for t in members]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return (time.perf_counter() - t0) * 1e3 / rounds
    finally:
        server.stop()


def phase_adasum(dev) -> tuple[dict, dict]:
    """(a) The trainer at full width with ``DistributedOptimizer(op=
    Adasum)`` at NCCL world 1, beside a shadow ``op=Average`` optimizer fed
    the same local gradients: at world 1 both reductions are the identity,
    so each step's reduced gradients equal the local ones and both runs'
    parameters stay bitwise equal; the loss falls. (b) The fused
    per-tensor combine of one VHDD level on the trainer's gradients of two
    different batches, float32 and rounded to bf16, against its float64
    version, timed. (c) The native negotiation engine built with ``g++``
    here, and one in-process ``drive_cycle`` of two engines; one KV
    round's time on this host."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import dynamic, _native
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from horovod_tpu_torch.ops import adasum, flash
    hvd.init()
    cfg = TransformerConfig(attn_mode="ulysses")  # full-width defaults
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = list(model.parameters())
    shadow = [torch.nn.Parameter(p.detach().clone()) for p in params]
    local, capture = {}, [True]

    def keep_local(p):
        if capture[0]:
            local[id(p)] = p.grad.clone()

    for p in params:
        p.register_post_accumulate_grad_hook(keep_local)
    opt = hvd.DistributedOptimizer(torch.optim.Adam(params, lr=1e-3),
                                   op=hvd.Adasum)
    opt_avg = hvd.DistributedOptimizer(torch.optim.Adam(shadow, lr=1e-3),
                                       op=hvd.Average)
    tokens = torch.from_numpy(
        synthetic_tokens(BATCH, SEQ, cfg.vocab_size, 0)).to(dev)
    losses, step_s, identity, same = [], [], [], []
    flash.reset_launch_counts()
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        opt.synchronize()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
        for p, q in zip(params, shadow):
            q.grad = local[id(p)]
        opt_avg.step()
        identity.append(all(torch.equal(p.grad, local[id(p)])
                            and torch.equal(q.grad, local[id(p)])
                            for p, q in zip(params, shadow)))
        same.append(all(torch.equal(p, q) for p, q in zip(params, shadow)))
    launches = dict(flash.launches)
    buckets = _bucket_report(opt)
    steady = sum(step_s[1:]) / (STEPS - 1)
    print(f"[adasum] trainer, DistributedOptimizer(Adam, op=Adasum), NCCL "
          f"world 1: losses {['%.4f' % x for x in losses]}, step "
          f"{steady * 1e3:.1f} ms (mean of steps 2-{STEPS}); reduced "
          f"gradients equal the local ones: {identity}; parameters bitwise "
          f"those of op=Average: {same}; buckets started in the backward "
          f"pass per step: {buckets['started_in_backward']}")
    require(all(math.isfinite(x) for x in losses), "adasum loss not finite")
    require(losses[-1] < losses[0], "adasum loss did not fall")
    require(all(identity), "Adasum or Average at world 1 is not the "
            "identity")
    require(all(same), "op=Adasum and op=Average parameters differ")
    require(min(buckets["started_in_backward"]) >= 1,
            "a step started no Adasum bucket before backward() returned")
    want = cfg.num_layers * STEPS
    require(all(v == want for v in launches.values()),
            f"adasum run's launch counts {launches}, want {want} each")
    # (b) one VHDD level's combine on two batches' gradients, the
    # optimizers' hooks gone
    del opt, opt_avg, shadow
    gc.collect()
    capture[0] = False
    local.clear()
    grads = []
    for seed in (0, 1):
        t = torch.from_numpy(synthetic_tokens(BATCH, SEQ, cfg.vocab_size,
                                              seed)).to(dev)
        model.zero_grad()
        lm_loss(model(t), t).backward()
        grads.append(torch.cat([p.grad.reshape(-1).float()
                                for p in params]))
    sizes = [p.numel() for p in params]
    model.zero_grad(set_to_none=True)
    combine = {}
    for name, cast in (("float32", lambda x: x),
                       ("bf16", lambda x: x.bfloat16().float())):
        a, b = cast(grads[0]), cast(grads[1])
        got = adasum.combine(a, b, sizes)
        want = _adasum_plain(a, b, sizes)
        err = (got.double() - want).abs().max().item()
        scale = want.abs().max().item()
        ms = time_ms(lambda: adasum.combine(a, b, sizes), reps=10)
        plain_ms = time_ms(lambda: _adasum_plain(a, b, sizes), reps=3)
        # a and b read once, the result written once, float32
        bound_ms = 3 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
        combine[name] = {"max_abs_err": err, "max_abs_value": scale,
                         "ms": ms, "plain_float64_ms": plain_ms,
                         "bound_ms": bound_ms}
        print(f"[adasum] fused per-tensor combine of one level, {name} "
              f"gradients of {len(sizes)} tensors ({a.numel() / 1e6:.1f} M "
              f"elements): max abs err {err:.3g} vs float64 (max |value| "
              f"{scale:.3g}, tolerance {ADASUM_AGREEMENT} of it); "
              f"{ms:.3f} ms (float64 plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms)")
        require(torch.isfinite(got).all().item(), "combine not finite")
        require(err <= ADASUM_AGREEMENT * scale,
                f"{name} combine disagrees with float64")
    del model, grads
    hvd.shutdown()
    torch.cuda.empty_cache()
    # (c) the native engine, built here, and two engines' cycle
    t0 = time.perf_counter()
    path = _native.build()
    build_s = time.perf_counter() - t0
    engines = [dynamic.NativeEngine(world_size=2, rank=r) for r in range(2)]
    for e in engines:
        e.enqueue("t", dynamic.REQ_ALLREDUCE, shape=(4,))
    plans = dynamic.drive_cycle(engines)
    for e in engines:
        e.close()
    ok = all(len(pl) == 1 and pl[0].tensor_names == ["t"]
             and pl[0].type == dynamic.REQ_ALLREDUCE for pl in plans)
    kv_ms = _kv_round_ms()
    print(f"[adasum] native engine {_native.version()} built in "
          f"{build_s:.1f} s ({path.name}); two engines' cycle: {plans[0]}; "
          f"one KV round of two members on this host: {kv_ms:.3f} ms")
    require(ok, "the native engines' cycle gave no allreduce plan")
    return {"losses": losses, "step_ms": steady * 1e3, "step_s": step_s,
            "identity": identity, "bitwise_average": same, **buckets,
            "combine": combine, "engine_build_s": build_s,
            "kv_round_ms": kv_ms}, launches


NEG_CALLS = 20  # repetitions of the named request in the negotiation phase


def _bucket_ranges(path: str) -> list[int]:
    """The gradient buckets' ranges a step in a timeline file: the
    ``GROUPED_ALLREDUCE`` and ``ALLREDUCE`` begins after each ``STEP``
    instant. The file must be Chrome-trace JSON."""
    with open(path) as f:
        events = json.load(f)
    per_step: list[int] = []
    for e in events:
        if e.get("name") == "STEP" and e.get("ph") == "i":
            per_step.append(0)
        elif (per_step and e.get("ph") == "B"
              and e.get("name") in ("ALLREDUCE", "GROUPED_ALLREDUCE")):
            per_step[-1] += 1
    return per_step


def _cached_calls(transport_cls, **kw) -> dict:
    """Two ``DynamicService``s in this process over a ``KVServer`` on this
    host (``HVD_RESPONSE_CACHE=1``), one member each, negotiating the same
    named allreduce request ``NEG_CALLS`` times: each call's busy rounds,
    whether it was served, and its time; the cache's hits and misses; the
    mean busy round."""
    import threading
    from horovod_tpu_torch import dynamic, engine_service
    from horovod_tpu_torch.runner.http_kv import (KVClient, KVServer,
                                                  make_secret)
    server = KVServer(secret=make_secret(), host="127.0.0.1")
    port = server.start()
    svcs = []
    req = dict(name="loss", request_type=dynamic.REQ_ALLREDUCE,
               shape=(1 << 16,), dtype=11, element_size=4)
    try:
        for r in range(2):
            svcs.append(engine_service.DynamicService(
                dynamic.NativeEngine(world_size=2, rank=r),
                transport_cls(KVClient("127.0.0.1", port,
                                       secret=server.secret), 2, r,
                              prefix="smoke", **kw)))
        rounds, served, call_ms, errors = [], [], [], []
        for _ in range(NEG_CALLS):
            before = svcs[0].rounds
            got = [None, None]

            def call(i):
                try:
                    t = svcs[i].negotiate_many_submit([dict(req)])
                    got[i] = (t.served, svcs[i].negotiate_many_wait(
                        t, timeout=60.0)[0].tensor_names)
                except Exception as e:  # re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(2)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            call_ms.append((time.perf_counter() - t0) * 1e3)
            if errors:
                raise errors[0]
            require(all(g is not None and g[1] == ["loss"] for g in got),
                    f"{transport_cls.__name__}: a call got {got}")
            require(got[0][0] == got[1][0],
                    "the two members decided differently to serve")
            served.append(got[0][0])
            rounds.append(svcs[0].rounds - before)
        stats = [s.response_cache_stats() for s in svcs]
        busy = sum(s.rounds for s in svcs)
        round_ms = sum(s.round_seconds for s in svcs) / max(busy, 1) * 1e3
    finally:
        for s in svcs:
            s.stop()
        server.stop()
    first = served.index(True) if True in served else NEG_CALLS
    return {"transport": transport_cls.__name__, "kw": kw,
            "rounds": rounds, "served": served, "call_ms": call_ms,
            "rounds_per_call_before": sum(rounds[:first]) / max(first, 1),
            "rounds_per_call_after": (sum(rounds[first:])
                                      / max(NEG_CALLS - first, 1)),
            "hits": stats[0]["hits"], "misses": stats[0]["misses"],
            "stats": stats, "busy_rounds": busy, "round_ms": round_ms}


def phase_negotiation(dev) -> tuple[dict, dict]:
    """(a) The trainer at full width (8 x 2048 tokens, K1-K3) with
    ``HVD_TIMELINE`` set at ``init()``: the file holds the parameters'
    broadcast; then STEPS steps in each of four turns, timeline off, on,
    on, off, in this process; each on turn's file must parse as Chrome
    trace JSON and hold every gradient bucket of every step. (b) Two
    in-process services over the port's ``KVServer`` on this host, flat
    and then two-level with groups of one: a named allreduce request
    ``NEG_CALLS`` times, served from the ResponseCache once confirmed,
    when it must take no round. (c) ``metrics_dump()`` holds the round
    histograms of every busy round."""
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, timeline
    from horovod_tpu_torch.engine_service import KVTransport
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    from horovod_tpu_torch.negotiation import HierarchicalTransport
    from horovod_tpu_torch.ops import flash
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HVD_TIMELINE"] = os.path.join(tmp, "init.json")
        try:
            hvd.init()
        finally:
            del os.environ["HVD_TIMELINE"]
        require(timeline.timeline_active(),
                "HVD_TIMELINE did not start the timeline at init()")
        cfg = TransformerConfig(attn_mode="ulysses")  # full-width defaults
        model = TransformerLM(cfg, device=dev)
        model.reset_parameters(torch.Generator().manual_seed(0))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        timeline.stop_timeline()
        with open(os.path.join(tmp, "init.json")) as f:
            init_events = json.load(f)
        require(any(e.get("name") in ("BROADCAST", "GROUPED_BROADCAST")
                    for e in init_events),
                "the init timeline holds no broadcast of the parameters")
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3))
        tokens = torch.from_numpy(
            synthetic_tokens(BATCH, SEQ, cfg.vocab_size, 0)).to(dev)
        turns, losses = [], []
        flash.reset_launch_counts()
        for i, on in enumerate((False, True, True, False)):
            path = os.path.join(tmp, f"turn{i}.json")
            if on:
                timeline.start_timeline(path)
            step_s = []
            for _ in range(STEPS):
                if on:
                    timeline.record("step", "STEP", timeline.PHASE_INSTANT)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(_train_step(model, opt, tokens))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            turn = {"timeline": on, "step_s": step_s,
                    "step_ms": sum(step_s[1:]) / (STEPS - 1) * 1e3}
            if on:
                timeline.stop_timeline()
                turn["file_bytes"] = os.path.getsize(path)
                turn["buckets_per_step"] = _bucket_ranges(path)
            turns.append(turn)
        launches = dict(flash.launches)
        n_buckets = len(opt.stats["bucket_bytes"])
        del model, opt
        hvd.shutdown()
    torch.cuda.empty_cache()
    off = [t["step_ms"] for t in turns if not t["timeline"]]
    on_ms = [t["step_ms"] for t in turns if t["timeline"]]
    cost = sum(on_ms) / len(on_ms) - sum(off) / len(off)
    print(f"[negotiation] trainer with the timeline off/on/on/off: step "
          f"{['%.2f' % t['step_ms'] for t in turns]} ms (mean of steps 2-"
          f"{STEPS} a turn); timeline cost {cost:+.3f} ms a step; bucket "
          f"ranges a step in the on turns "
          f"{[t['buckets_per_step'] for t in turns if t['timeline']]} "
          f"({n_buckets} buckets); losses "
          f"{['%.4f' % x for x in losses[::STEPS]]}...; launches {launches}")
    require(all(math.isfinite(x) for x in losses), "loss is not finite")
    require(losses[-1] < losses[0], "loss did not fall")
    for t in turns:
        if t["timeline"]:
            require(t["buckets_per_step"] == [n_buckets] * STEPS,
                    f"timeline misses a bucket: {t['buckets_per_step']}, "
                    f"want {n_buckets} in each of {STEPS} steps")
    want = cfg.num_layers * STEPS * len(turns)
    require(all(v == want for v in launches.values()),
            f"negotiation phase's launch counts {launches}, want {want}")
    out["timeline"] = {"turns": turns, "cost_ms": cost,
                       "buckets": n_buckets}
    os.environ["HVD_RESPONSE_CACHE"] = "1"
    before = metrics.snapshot()
    try:
        runs = [_cached_calls(KVTransport),
                _cached_calls(HierarchicalTransport, group_size=1)]
    finally:
        del os.environ["HVD_RESPONSE_CACHE"]
    grown = metrics.delta(metrics.snapshot(), before)
    for run in runs:
        print(f"[negotiation] two services, {run['transport']} "
              f"{run['kw']}: {NEG_CALLS} calls of one named allreduce "
              f"request; busy rounds a call {run['rounds']}, served "
              f"{sum(run['served'])}; rounds a call before confirmation "
              f"{run['rounds_per_call_before']:.2f}, after "
              f"{run['rounds_per_call_after']:.2f}; hits {run['hits']}, "
              f"misses {run['misses']}; a busy round "
              f"{run['round_ms']:.3f} ms; a call "
              f"{['%.2f' % x for x in run['call_ms']]} ms")
        first = run["served"].index(True) if True in run["served"] else -1
        require(first >= 1 and all(run["served"][first:]),
                f"{run['transport']}: the request was never served, or "
                "stopped being served")
        require(run["rounds_per_call_after"] == 0.0,
                f"{run['transport']}: a served call took a round")
        require(run["rounds_per_call_before"] >= 1.0,
                f"{run['transport']}: a negotiated call took no round")
        require(run["hits"] == NEG_CALLS - first and run["misses"] == first,
                f"{run['transport']}: hits and misses {run['hits']}, "
                f"{run['misses']}")
    hist = metrics.metrics_dump()["hvd_negotiation_round_seconds"]
    counted = sum(v for (name, _), v in grown.items()
                  if name == "hvd_negotiation_round_seconds_count")
    busy = sum(run["busy_rounds"] for run in runs)
    series = [(x["labels"], x["count"], round(x["sum"], 6))
              for x in hist["series"]]
    print(f"[negotiation] metrics_dump(): hvd_negotiation_round_seconds "
          f"{series}; {counted} rounds observed in this phase, {busy} busy "
          "rounds counted by the services")
    require(counted == busy and busy > 0,
            "the round histogram does not hold every busy round")
    out.update({"flat": runs[0], "hierarchical": runs[1],
                "round_histogram": hist["series"]})
    return out, launches


FUSION_TURNS = 3  # capture off/on pairs of the trainer's step, in turns
SYNC_REPS = 20  # synchronize() calls a turn of the ResNet-50 sync


def _fusion_trainer(dev, capture: bool) -> dict:
    """The trainer through the fusion cycle and its pipelined executor
    (``capture`` off), or under step capture: full width, bf16, ulysses,
    8 x 2048 tokens, ``DistributedOptimizer(Adam)`` with its gradients
    kept in place (``zero_grad(set_to_none=False)``), STEPS steps from the
    trainer phase's seed. Returns the model, the optimizer, the parameters
    after the steps, the losses and step times, the K1-K3 launches and
    ``fusion_stats()``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from horovod_tpu_torch.ops import dispatch_cache, flash, fusion_cycle
    os.environ["HVD_STEP_CAPTURE"] = "1" if capture else "0"
    fusion_cycle.reset()
    dispatch_cache.reset()
    cfg = TransformerConfig(attn_mode="ulysses")
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))
    tokens = torch.from_numpy(
        synthetic_tokens(BATCH, SEQ, cfg.vocab_size, 0)).to(dev)

    def step() -> float:
        opt.zero_grad(set_to_none=False)
        loss = lm_loss(model(tokens), tokens)
        with torch.profiler.record_function("backward"):
            loss.backward()
        opt.step()
        return loss.item()

    torch.cuda.synchronize()
    flash.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(flash.launches)
    params = [p.detach().clone() for p in model.parameters()]
    return {"model": model, "opt": opt, "step": step, "params": params,
            "losses": losses, "step_s": step_s, "launches": launches,
            "stats": hvd.fusion_stats(), "layers": cfg.num_layers}


def _params_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def _sync_turns(opt, turns) -> dict:
    """``synchronize()`` alone, again and again (:func:`_sync_again`),
    with capture off and on as ``turns`` says: each turn's host ms a call
    (the issue, no device wait) and CUDA-event ms a call."""
    out = {"off": {"host_ms": [], "event_ms": []},
           "on": {"host_ms": [], "event_ms": []}}
    for turn in turns:
        os.environ["HVD_STEP_CAPTURE"] = "1" if turn == "on" else "0"
        for _ in range(3):
            _sync_again(opt)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        host = 0.0
        start.record()
        for _ in range(SYNC_REPS):
            t0 = time.perf_counter()
            _sync_again(opt)
            host += time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        out[turn]["host_ms"].append(host * 1e3 / SYNC_REPS)
        out[turn]["event_ms"].append(start.elapsed_time(end) / SYNC_REPS)
    return out


def phase_fusion(dev):
    """The fusion and plan machinery on the trainer's path. The trainer
    through the fusion cycle and its pipelined executor, twice (the eager
    path's own run-to-run spread), then under step capture: the first
    step records, every later one replays one CUDA Graph of the step's
    sync with no divergence, and the parameters equal the eager run's.
    Then the captured trainer's step with capture off and on in turns, and
    ResNet-50's ``synchronize()`` alone (161 gradients) off and on in
    turns. K1-K3 are held against their plain versions at the path's
    shape first."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.ops import fusion_cycle
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    g = torch.Generator(device=dev).manual_seed(2)
    errs, _ = hold_training_kernels(g, dev, "fusion")
    del _
    prior = os.environ.get("HVD_STEP_CAPTURE")
    try:
        runs = {}
        for name, capture in (("cycle", False), ("cycle_again", False),
                              ("capture", True)):
            runs[name] = _fusion_trainer(dev, capture)
            if name != "capture":
                del runs[name]["model"], runs[name]["opt"]
        cyc, again, cap = runs["cycle"], runs["cycle_again"], runs["capture"]
        spread = _params_diff(cyc["params"], again["params"])
        diff = _params_diff(cyc["params"], cap["params"])
        st, cst = cyc["stats"], cap["stats"]["capture"]
        # the captured trainer's step, capture off and on in turns
        step_turns = {"off": [], "on": []}
        for turn in ["off", "on"] * FUSION_TURNS:
            os.environ["HVD_STEP_CAPTURE"] = "1" if turn == "on" else "0"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cap["step"]()
            torch.cuda.synchronize()
            step_turns[turn].append((time.perf_counter() - t0) * 1e3)
        turns_stats = hvd.fusion_stats()["capture"]
        profile = _profile_step(cap["step"])  # under capture (env is on)
        del cap["model"], cap["opt"], cap["step"]
        torch.cuda.empty_cache()
        # ResNet-50's sync alone
        fusion_cycle.reset()
        torch.backends.cudnn.benchmark = True
        model = models.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                                device=dev,
                                generator=torch.Generator().manual_seed(0))
        model.train()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9))
        x = torch.randn(32, 3, 224, 224, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        y = torch.randint(0, 1000, (32,), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(4))
        os.environ["HVD_STEP_CAPTURE"] = "0"
        opt.zero_grad(set_to_none=False)
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.synchronize()
        n_grads = sum(1 for p in model.parameters() if p.grad is not None)
        sync = _sync_turns(opt, ["off", "on", "on", "off", "off", "on"])
        sync_stats = hvd.fusion_stats()["capture"]
        del model, opt, x, y
    finally:
        if prior is None:
            os.environ.pop("HVD_STEP_CAPTURE", None)
        else:
            os.environ["HVD_STEP_CAPTURE"] = prior
    hvd.shutdown()
    torch.cuda.empty_cache()
    steady = lambda r: sum(r["step_s"][1:]) / (STEPS - 1) * 1e3  # noqa: E731
    want = cyc["layers"] * STEPS
    print(f"[fusion] trainer through the fusion cycle (pipelined executor, "
          f"{st['pipeline']['max_inflight']} slots): step "
          f"{steady(cyc):.1f} ms (mean of steps 2-{STEPS}), losses "
          f"{['%.4f' % x for x in cyc['losses']]}; flushes by trigger "
          f"{ {k: v for k, v in st['flushes'].items() if v} }, executor "
          f"submitted {st['pipeline']['submitted']}, inflight peak "
          f"{st['pipeline']['inflight_peak']}, slot waits "
          f"{st['pipeline']['slot_waits']}")
    print(f"[fusion] trainer under capture: step {steady(cap):.1f} ms "
          f"(mean of steps 2-{STEPS}, the capturing step 2 included; the "
          f"replays of steps 3-{STEPS} "
          f"{sum(cap['step_s'][2:]) / (STEPS - 2) * 1e3:.1f} ms); "
          f"recorded {cst['recorded_steps']}, replayed "
          f"{cst['replayed_steps']}, fallbacks {cst['fallbacks']}, graph "
          f"launches {cst['graph_launches']}; parameters after {STEPS} "
          f"steps against the eager run: max abs {diff:.3g} (the eager "
          f"run against itself: {spread:.3g})")
    print(f"[fusion] step in turns, capture off "
          f"{['%.1f' % x for x in step_turns['off']]} ms, on "
          f"{['%.1f' % x for x in step_turns['on']]} ms; fallbacks over "
          f"the turns {turns_stats['fallbacks']}")
    print(f"[fusion] ResNet-50 synchronize() alone, {n_grads} gradients, "
          f"{SYNC_REPS} calls a turn: capture off host "
          f"{['%.3f' % x for x in sync['off']['host_ms']]} ms, event "
          f"{['%.3f' % x for x in sync['off']['event_ms']]} ms; capture on "
          f"host {['%.3f' % x for x in sync['on']['host_ms']]} ms, event "
          f"{['%.3f' % x for x in sync['on']['event_ms']]} ms; fallbacks "
          f"{sync_stats['fallbacks']}, graph launches "
          f"{sync_stats['graph_launches']}")
    require(all(math.isfinite(x) for x in cyc["losses"] + cap["losses"]),
            "fusion: loss is not finite")
    require(cyc["losses"][-1] < cyc["losses"][0], "fusion: loss did not fall")
    for r in (cyc, cap):
        require(all(v == want for v in r["launches"].values()),
                f"fusion: launch counts {r['launches']}, want {want} each")
    require(cst["recorded_steps"] == 1 and cst["replayed_steps"] == STEPS - 1
            and cst["fallbacks"] == 0
            and cst["graph_launches"] == STEPS - 1,
            f"fusion: capture {cst}, want 1 recorded and {STEPS - 1} "
            "replays of the graph, none diverged")
    require(diff == 0.0 or (spread > 0.0 and diff <= spread),
            f"fusion: parameters under capture off by {diff:.3g} from the "
            f"eager run, whose own spread is {spread:.3g}")
    require(turns_stats["fallbacks"] == 0 and sync_stats["fallbacks"] == 0,
            "fusion: a replay diverged in the turns")
    require(n_grads == 161, f"fusion: ResNet-50 has {n_grads} gradients")
    launches = {name: {"cycle": cyc["launches"][name],
                       "capture": cap["launches"][name]}
                for name in cyc["launches"]}
    return {"step_ms": {"cycle": steady(cyc), "capture": steady(cap)},
            "replay_step_ms": sum(cap["step_s"][2:]) / (STEPS - 2) * 1e3,
            "losses": {"cycle": cyc["losses"], "capture": cap["losses"]},
            "step_s": {"cycle": cyc["step_s"], "capture": cap["step_s"]},
            "flushes": {k: v for k, v in st["flushes"].items() if v},
            "pipeline": st["pipeline"], "capture": cst,
            "params_vs_eager_max_abs": diff,
            "eager_spread_max_abs": spread,
            "step_turns_ms": step_turns, "profile": profile,
            "resnet50_sync": {"gradients": n_grads, **sync},
            "kernel_errors": errs}, launches



# the cached trainer's step, eager and cached in turns, CACHED_TURN_STEPS a turn
CACHED_TURNS = ["eager", "cached", "cached", "eager"] * 2
CACHED_TURN_STEPS = 4


def _cached_trainer(dev):
    """The trainer at full width (bf16, ulysses, NCCL world 1) with
    ``DistributedOptimizer(Adam(capturable=True))`` from the trainer phase's
    seed, its gradients kept in place, and its step as a function that
    builds a fresh closure over them on every call (the re-created-closure
    pattern ``hvd.cached_step`` keys on)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    cfg = TransformerConfig(attn_mode="ulysses")
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True))

    def make_step():
        def train_step(tokens):
            opt.zero_grad(set_to_none=False)
            loss = lm_loss(model(tokens), tokens)
            loss.backward()
            opt.step()
            return loss.detach()
        return train_step

    return cfg, model, opt, make_step


def phase_cached_step(dev):
    """The whole trainer step as one CUDA Graph (``hvd.cached_step``). The
    eager trainer twice (its own spread), then the same trainer with a
    fresh ``cached_step`` closure every step: step 1 runs eagerly and
    captures, steps 2-STEPS replay under the profiler. One plan, one
    record, no fallback, a falling loss, and the parameters equal to the
    eager run's. K1-K3's launches on this path are the record's eager run
    (the wrappers' counters: ``num_layers`` each) and, in the replays,
    the kernels counted by name in the profile (``num_layers`` each a
    replay; the counters stand still there, since a replay launches
    through the graph). Each capture's counter steps are checked apart:
    a capture records ``num_layers`` of each and launches nothing. A
    second batch shape records a second graph, and both replay. Then the
    step eager and cached in turns, one profiled step of each, and each
    run's peak memory."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import (dispatch_cache, flash,
                                       gspmd_cache)
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    tokens = torch.from_numpy(synthetic_tokens(BATCH, SEQ, 32000, 0)).to(dev)
    runs = {}
    for name in ("eager", "eager_again"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cfg, model, opt, make_step = _cached_trainer(dev)
        flash.reset_launch_counts()
        losses, step_s = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            losses.append(make_step()(tokens).item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        runs[name] = {"losses": losses, "step_s": step_s,
                      "launches": dict(flash.launches),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "params": [p.detach().clone()
                                 for p in model.parameters()]}
        del model, opt, make_step
        torch.cuda.empty_cache()
    # the cached run; each capture's launches are counted apart
    dispatch_cache.reset()
    gspmd_cache.reset_stats()
    captures = []
    capture = gspmd_cache.CachedStep._capture

    def counted_capture(self, *args):
        before = dict(flash.launches)
        out = capture(self, *args)
        captures.append({k: v - before[k] for k, v in flash.launches.items()})
        return out

    gspmd_cache.CachedStep._capture = counted_capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cfg, model, opt, make_step = _cached_trainer(dev)
        flash.reset_launch_counts()
        losses, step_s = [], []

        def cached():
            t0 = time.perf_counter()
            losses.append(hvd.cached_step(make_step())(tokens).item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)

        cached()  # the record: its eager run, then the capture
        record_launches = dict(flash.launches)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS - 1):
                cached()  # the replays
        replay_counted = {k: v - record_launches[k]
                          for k, v in flash.launches.items()}
        replay_named = _flash_named(
            [e for e in prof.key_averages()
             if "CUDA" in str(getattr(e, "device_type", ""))])
        del prof
        peak_cached = torch.cuda.max_memory_allocated() / 2**30
        params = [p.detach().clone() for p in model.parameters()]
        stats = gspmd_cache.stats()
        # a second batch shape: a second graph; then both replay
        half = tokens[:BATCH // 2].contiguous()
        for toks in (half, tokens, half):
            hvd.cached_step(make_step())(toks)
        torch.cuda.synchronize()
        shapes_stats = gspmd_cache.stats()
        # eager and cached in turns on the same model
        turns = {"eager": [], "cached": []}
        for turn in CACHED_TURNS:
            step = (make_step() if turn == "eager"
                    else hvd.cached_step(make_step()))
            for _ in range(CACHED_TURN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(tokens)
                torch.cuda.synchronize()
                turns[turn].append((time.perf_counter() - t0) * 1e3)
        prof_eager = _profile_step(lambda: make_step()(tokens))
        prof_cached = _profile_step(
            lambda: hvd.cached_step(make_step())(tokens))
        final_stats = gspmd_cache.stats()
    finally:
        gspmd_cache.CachedStep._capture = capture
    del model, opt, make_step
    hvd.shutdown()
    torch.cuda.empty_cache()
    eager, again = runs["eager"], runs["eager_again"]
    spread = _params_diff(eager["params"], again["params"])
    diff = _params_diff(eager["params"], params)
    replays = stats["events"].get("replayed", 0)
    layers = cfg.num_layers
    at_capture = captures[0] if captures else {}
    eager_once = {k: record_launches[k] - at_capture.get(k, 0)
                  for k in record_launches}
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    steady = lambda st: sum(st[1:]) / (len(st) - 1) * 1e3  # noqa: E731
    print(f"[cached_step] trainer under hvd.cached_step, a fresh closure a "
          f"step: builds {stats['builds']}, events {stats['events']}, hits "
          f"{stats['hits']}, passthrough syncs {stats['passthrough_syncs']}"
          f"; losses {['%.4f' % x for x in losses]}")
    print(f"[cached_step] step 1 (eager run and capture) "
          f"{step_s[0] * 1e3:.1f} ms; replays (profiled) "
          f"{['%.2f' % (x * 1e3) for x in step_s[1:]]} ms; eager steps "
          f"2-{STEPS} {steady(eager['step_s']):.2f} ms")
    print(f"[cached_step] parameters after {STEPS} steps against the eager "
          f"run: max abs {diff:.3g} (the eager run against itself: "
          f"{spread:.3g})")
    print(f"[cached_step] K1-K3 in the cached run: the record's eager run "
          f"{eager_once} (counters), recorded at each capture {captures}, "
          f"in the {STEPS - 1} replays {replay_named} by name (counters "
          f"{replay_counted}); by name in the later profiled replay "
          f"{prof_cached['flash_kernels']}")
    print(f"[cached_step] second batch shape {BATCH // 2} x {SEQ}: builds "
          f"{shapes_stats['builds']}, events {shapes_stats['events']}")
    print(f"[cached_step] step in turns (host ms, synchronized): eager "
          f"{['%.2f' % x for x in turns['eager']]}, cached "
          f"{['%.2f' % x for x in turns['cached']]}; medians "
          f"{med(turns['eager']):.2f} / {med(turns['cached']):.2f} ms")
    print(f"[cached_step] one profiled step: eager busy "
          f"{prof_eager['busy_ms']:.2f} of {prof_eager['wall_ms']:.2f} ms "
          f"({100 * prof_eager['busy_ms'] / prof_eager['wall_ms']:.1f} %), "
          f"cached replay busy {prof_cached['busy_ms']:.2f} of "
          f"{prof_cached['wall_ms']:.2f} ms ("
          f"{100 * prof_cached['busy_ms'] / prof_cached['wall_ms']:.1f} %)")
    print(f"[cached_step] peak memory: eager {eager['peak_gib']:.2f} GiB, "
          f"cached {peak_cached:.2f} GiB on {torch.cuda.get_device_name(0)}")
    require(stats["builds"] == 1 and stats["events"].get("recorded") == 1
            and replays >= 4 and stats["events"].get("fallback", 0) == 0,
            f"cached_step: {stats}, want 1 build, 1 record, >= 4 replays "
            "and no fallback")
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0], f"cached_step: losses {losses}")
    require(diff == 0.0 or (spread > 0.0 and diff <= spread),
            f"cached_step: parameters off by {diff:.3g} from the eager "
            f"run, whose own spread is {spread:.3g}")
    require(len(captures) == 2
            and all(c.get(k) == layers for c in captures
                    for k in flash.launches)
            and all(eager_once[k] == layers
                    and replay_named[k] == layers * (STEPS - 1)
                    and replay_counted[k] == 0
                    and prof_cached["flash_kernels"][k] == layers
                    for k in flash.launches),
            f"cached_step: K1-K3 in the record's eager run {eager_once}, at "
            f"each capture {captures}, by name in the {STEPS - 1} replays "
            f"{replay_named} (counters {replay_counted}) and in a later "
            f"profiled replay {prof_cached['flash_kernels']}; want {layers} "
            "each a step")
    require(shapes_stats["builds"] == 2
            and shapes_stats["events"].get("recorded") == 2
            and shapes_stats["events"].get("replayed") == replays + 2
            and shapes_stats["events"].get("fallback", 0) == 0,
            f"cached_step: two batch shapes gave {shapes_stats}")
    require(final_stats["events"].get("fallback", 0) == 0
            and final_stats["builds"] == 2,
            f"cached_step: the turns re-recorded or fell back: "
            f"{final_stats}")
    # the cached path's kernel launches, each measured in this run: the
    # record's eager run by the counters, the replays by name
    launches = {k: eager_once[k] + replay_named[k] for k in eager_once}
    return {"step_ms": {"eager": steady(eager["step_s"]),
                        "cached_replay_profiled":
                            sum(step_s[1:]) / (STEPS - 1) * 1e3,
                        "cached_record": step_s[0] * 1e3},
            "losses": {"eager": eager["losses"], "cached": losses},
            "stats": stats, "two_shapes": shapes_stats,
            "params_vs_eager_max_abs": diff, "eager_spread_max_abs": spread,
            "launches": {"record_eager": eager_once,
                         "replays_by_name": replay_named},
            "recorded_at_capture": at_capture,
            "profiled_replay_flash": prof_cached["flash_kernels"],
            "turns_ms": turns,
            "busy": {"eager": [prof_eager["busy_ms"], prof_eager["wall_ms"]],
                     "cached": [prof_cached["busy_ms"],
                                prof_cached["wall_ms"]]},
            "profile_kinds": {"eager": prof_eager["kinds"],
                              "cached": prof_cached["kinds"]},
            "peak_memory_gib": {"eager": eager["peak_gib"],
                                "cached": peak_cached}}, launches


CKPT_STEPS = 4  # committed steps of the checkpoint phase before its restores
CKPT_AFTER = 2  # steps each restored trainer takes, and the uninterrupted one
CKPT_SAVES = 3  # timed host copies (TorchState.save) with the writer idle


def _ckpt_params_diff(a, b) -> float:
    return _params_diff(a, [p.detach() for p in b.parameters()])


def phase_checkpoint(dev):
    """The cached trainer under ``elastic.TorchState``, committing every
    step with the state plane on (``HVD_CKPT_DIR`` in a temporary
    directory, ``HVD_CKPT_INTERVAL=1``): each commit's time, the
    background snapshot's time and size; then ``save()`` alone (the host
    copy, with the writer idle) CKPT_SAVES times; a ``Checkpointer`` save
    of the model and optimizer at the last commit. Then the live graph
    across an in-place restore: CKPT_AFTER replays move the model on,
    ``restore()`` writes the last commit back into the same tensors, and
    CKPT_AFTER more replays of the same graph (no new record, no drop)
    retrace the first ones bit for bit and give the uninterrupted run.
    Then a fresh model and optimizer (another seed, one step taken, so
    that Adam has its state) restore from the sealed step
    (``sharded_restore_or_none``, loaded in place through the state), and
    another from the ``Checkpointer``; each takes CKPT_AFTER steps, and
    its parameters must equal the uninterrupted run's bit for bit."""
    import shutil
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, metrics
    from horovod_tpu_torch.ops import gspmd_cache
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    tokens = torch.from_numpy(synthetic_tokens(BATCH, SEQ, 32000, 0)).to(dev)
    tmp = tempfile.mkdtemp(prefix="hvd_ckpt_")
    plane_dir = os.path.join(tmp, "plane")
    prior = {k: os.environ.get(k) for k in ("HVD_CKPT_DIR",
                                            "HVD_CKPT_INTERVAL")}
    os.environ["HVD_CKPT_DIR"] = plane_dir
    os.environ["HVD_CKPT_INTERVAL"] = "1"
    checkpoint.reset_plane()
    try:
        before = metrics.snapshot()
        _cfg, model, opt, make_step = _cached_trainer(dev)
        state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0)
        commit_ms = []
        for i in range(CKPT_STEPS):
            hvd.cached_step(make_step())(tokens)
            state.step = i + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state.commit()
            commit_ms.append((time.perf_counter() - t0) * 1e3)
        require(checkpoint.current_plane().flush(120.0),
                "checkpoint: the snapshot writer did not finish")
        snap = metrics.delta(metrics.snapshot(), before)
        n_snap = snap.get(("hvd_ckpt_snapshot_seconds_count", ()), 0)
        snapshot_ms = (snap.get(("hvd_ckpt_snapshot_seconds_sum", ()), 0.0)
                       * 1e3 / max(n_snap, 1))
        with open(checkpoint.manifest_path(plane_dir, CKPT_STEPS)) as f:
            manifest = json.load(f)
        snapshot_mb = sum(m["nbytes"] for m in manifest["shards"]) / 1e6
        save_alone_ms = []
        for _ in range(CKPT_SAVES):  # the same values: the commit stands
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state.save()
            save_alone_ms.append((time.perf_counter() - t0) * 1e3)
        mgr = checkpoint.Checkpointer(os.path.join(tmp, "ckpt"),
                                      max_to_keep=2)
        t0 = time.perf_counter()
        mgr.save(CKPT_STEPS, {"model": model.state_dict(),
                              "optimizer": opt.optimizer.state_dict()})
        save_ms = (time.perf_counter() - t0) * 1e3
        # the live graph across an in-place restore
        live0 = gspmd_cache.stats()
        for _ in range(CKPT_AFTER):
            hvd.cached_step(make_step())(tokens)
        diverged = [p.detach().clone() for p in model.parameters()]
        state.restore()
        for _ in range(CKPT_AFTER):
            hvd.cached_step(make_step())(tokens)
        torch.cuda.synchronize()
        live1 = gspmd_cache.stats()
        want = [p.detach().clone() for p in model.parameters()]
        live = {k: live1["events"].get(k, 0) - live0["events"].get(k, 0)
                for k in ("recorded", "replayed", "invalidated", "fallback")}
        live["builds"] = live1["builds"] - live0["builds"]
        # the replays after restore() retrace the ones before it
        retrace = _params_diff(diverged, want)
        del diverged
        del state, model, opt, make_step

        def fresh():
            _cfg, m, o, mk = _cached_trainer(dev)
            m.reset_parameters(torch.Generator().manual_seed(1))
            mk()(tokens)  # Adam's state exists
            return m, o, mk

        # from the sealed state-plane step, into a TorchState in place
        m, o, mk = fresh()
        restored = hvd.elastic.TorchState(model=m, optimizer=o, step=0)
        t0 = time.perf_counter()
        tree = checkpoint.sharded_restore_or_none(
            plane_dir, target=restored._saved_state)
        require(tree is not None, "checkpoint: no sealed step to restore")
        restored._saved_state = tree
        restored.restore()
        torch.cuda.synchronize()
        plane_restore_ms = (time.perf_counter() - t0) * 1e3
        require(restored.step == CKPT_STEPS,
                f"checkpoint: restored step {restored.step}")
        for _ in range(CKPT_AFTER):
            mk()(tokens)
        plane_diff = _ckpt_params_diff(want, m)
        del restored, m, o, mk, tree
        # from the Checkpointer
        m, o, mk = fresh()
        t0 = time.perf_counter()
        tree = mgr.restore(target={"model": m.state_dict(),
                                   "optimizer": o.optimizer.state_dict()})
        m.load_state_dict(tree["model"])
        o.optimizer.load_state_dict(tree["optimizer"])
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(CKPT_AFTER):
            mk()(tokens)
        ckpt_diff = _ckpt_params_diff(want, m)
        steps = mgr.all_steps()
        del m, o, mk, tree
    finally:
        checkpoint.reset_plane()
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    hvd.shutdown()
    torch.cuda.empty_cache()
    print(f"[checkpoint] TorchState commit every step ({CKPT_STEPS} steps): "
          f"{['%.1f' % x for x in commit_ms]} ms; background snapshots "
          f"{int(n_snap)}, {snapshot_ms:.1f} ms and {snapshot_mb:.1f} MB "
          f"each (manifest of step {CKPT_STEPS}: {len(manifest['shards'])} "
          f"shard, {manifest['n_leaves']} leaves)")
    print(f"[checkpoint] TorchState.save() alone (the host copy, writer "
          f"idle): {['%.1f' % x for x in save_alone_ms]} ms")
    print(f"[checkpoint] the live graph across restore(): {live} (events "
          f"over {CKPT_AFTER} replays, restore(), {CKPT_AFTER} replays); "
          f"the replays after it against those before it: max abs "
          f"{retrace:.3g}")
    print(f"[checkpoint] Checkpointer save {save_ms:.1f} ms, restore "
          f"{restore_ms:.1f} ms; state-plane restore {plane_restore_ms:.1f} "
          f"ms; after {CKPT_AFTER} more steps, parameters against the "
          f"uninterrupted run: plane {plane_diff:.3g}, Checkpointer "
          f"{ckpt_diff:.3g} (max abs) on {torch.cuda.get_device_name(0)}")
    require(n_snap == CKPT_STEPS and manifest["step"] == CKPT_STEPS,
            f"checkpoint: {n_snap} snapshots, manifest {manifest['step']}")
    require(steps == [CKPT_STEPS], f"checkpoint: steps {steps}")
    require(live == {"recorded": 0, "replayed": 2 * CKPT_AFTER,
                     "invalidated": 0, "fallback": 0, "builds": 0},
            f"checkpoint: the graph across restore() gave {live}, want "
            f"{2 * CKPT_AFTER} replays and no record or drop")
    require(retrace == 0.0,
            f"checkpoint: the replays after restore() are {retrace:.3g} off "
            "the same replays before it")
    require(plane_diff == 0.0 and ckpt_diff == 0.0,
            f"checkpoint: restored runs off by {plane_diff:.3g} (plane) "
            f"and {ckpt_diff:.3g} (Checkpointer)")
    return {"commit_ms": commit_ms, "save_alone_ms": save_alone_ms,
            "live_graph_across_restore": live,
            "retrace_max_abs": retrace,
            "snapshot_ms": snapshot_ms,
            "snapshot_mb": snapshot_mb, "snapshots": int(n_snap),
            "checkpointer_save_ms": save_ms,
            "checkpointer_restore_ms": restore_ms,
            "plane_restore_ms": plane_restore_ms,
            "params_vs_uninterrupted_max_abs": {"plane": plane_diff,
                                                "checkpointer": ckpt_diff}}


TRAINER_WORKER_FLAG = "--trainer-worker"
ELASTIC_WORKER_FLAG = "--elastic-worker"
LAUNCH = [sys.executable, "-m", "horovod_tpu_torch.runner.launch"]
# The elastic phase: the cached trainer's committed steps, and the commit
# after which the worker asks the driver for a new round (it re-forms at
# the next one).
ELASTIC_STEPS, ELASTIC_REFORM_AT = 6, 2
REFORM_REQUEST_KEY = "chip_smoke/reform"


def _params_sha256(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def trainer_worker(out_path: str) -> None:
    """The ``[launch]`` phase's worker: the trainer phase's run (its seed,
    Adam, STEPS steps on BATCH x SEQ tokens) in the world the environment
    gives, a world of one where it gives none; writes the losses, the
    kernel launches and its start-up clock to ``out_path`` (its
    ``{rank}``, where it has one, becomes the rank)."""
    t_main = time.time()
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    from horovod_tpu_torch.ops import flash
    hvd.init()
    t_init = time.time()
    dev = hvd.device()
    cfg = TransformerConfig(attn_mode="ulysses")
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))
    tokens = torch.from_numpy(
        synthetic_tokens(BATCH, SEQ, cfg.vocab_size, 0)).to(dev)
    flash.reset_launch_counts()
    losses = [_train_step(model, opt, tokens) for _ in range(STEPS)]
    torch.cuda.synchronize()
    out = {"losses": losses, "launches": dict(flash.launches),
           "layers": cfg.num_layers, "t_main": t_main, "t_init": t_init,
           "t_done": time.time(), "world": hvd.size(), "rank": hvd.rank(),
           "device": str(dev), "backend": dist.get_backend(),
           "params_sha256": _params_sha256(model),
           "card_uuid": str(getattr(torch.cuda.get_device_properties(dev),
                                    "uuid", None)),
           "env": {k: os.environ.get(k) for k in (
               "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT",
               "HVD_CUDA_DEVICE", "HVD_KV_ADDR", "CUDA_VISIBLE_DEVICES")}}
    hvd.shutdown()
    with open(out_path.format(rank=out["rank"]), "w") as f:
        json.dump(out, f)


def elastic_worker(out_path: str, mode: str) -> None:
    """The ``[elastic]`` phase's worker: the cached trainer (``Adam(
    capturable=True)``, ``hvd.cached_step``) under ``hvd.elastic.run`` with
    ``TorchState``, committing every one of ELASTIC_STEPS steps. With
    ``mode`` ``elastic`` (under the elastic launcher), after commit
    ELASTIC_REFORM_AT it asks the driver for a new round over the KV
    store and waits for the notification, so the next commit raises
    ``HostsUpdatedInterrupt`` and the world re-forms in this process; with
    ``reference`` it runs the same commits uninterrupted (without a
    launcher, or under ``ElasticRayExecutor``); ``autoscale`` runs them
    uninterrupted under the elastic launcher with ``HVD_AUTOSCALE`` on, and
    adds the observer's step times and its cost a commit. Writes the
    losses, a digest of the parameters, the cached step's records, the
    process groups seen, the re-form's times and the kernel launches to
    ``out_path``."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, runtime
    from horovod_tpu_torch.elastic import HostsUpdatedInterrupt
    from horovod_tpu_torch.ops import dispatch_cache, flash, gspmd_cache
    hvd.init()
    dev = hvd.device()
    cfg, model, opt, make_step = _cached_trainer(dev)
    tokens = torch.from_numpy(synthetic_tokens(BATCH, SEQ, 32000, 0)).to(dev)
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0,
                                   losses=[])
    info = {"worlds": [], "interrupt_t": None, "entered_t": None,
            "first_step_end_t": None}
    check = state.check_host_updates

    def timed_check():
        try:
            check()
        except HostsUpdatedInterrupt:
            info["interrupt_t"] = time.perf_counter()
            raise

    state.check_host_updates = timed_check
    captures = []
    capture = gspmd_cache.CachedStep._capture

    def counted_capture(self, *args):
        before = dict(flash.launches)
        got = capture(self, *args)
        captures.append({k: v - before[k] for k, v in flash.launches.items()})
        return got

    gspmd_cache.CachedStep._capture = counted_capture
    note_cost = {"on": [], "off": []}
    iteration_s = []
    if mode == "autoscale":
        # the observer's cost a commit, in turns: the commit's own call
        # (observer on), then the same seam with the observer off
        from horovod_tpu_torch.elastic import policy
        note_commit = policy.note_commit

        def timed_note_commit():
            t0 = time.perf_counter()
            note_commit()
            t1 = time.perf_counter()
            obs, policy._process_observer = policy._process_observer, False
            note_commit()
            t2 = time.perf_counter()
            policy._process_observer = obs
            note_cost["on"].append(t1 - t0)
            note_cost["off"].append(t2 - t1)

        policy.note_commit = timed_note_commit
    gspmd_cache.reset_stats()
    dispatch_cache.reset_stats()
    flash.reset_launch_counts()

    @hvd.elastic.run
    def train(state):
        group = dist.distributed_c10d._get_default_group()
        info["worlds"].append({
            "generation": runtime.generation(), "size": hvd.size(),
            "backend": dist.get_backend(), "group": id(group),
            "master_port": os.environ.get("MASTER_PORT"),
            "device": str(hvd.device())})
        if info["interrupt_t"] is not None:
            info["entered_t"] = time.perf_counter()
        while state.step < ELASTIC_STEPS:
            t_iter = time.perf_counter()
            loss = hvd.cached_step(make_step())(tokens)
            state.losses = state.losses + [loss.item()]
            if info["interrupt_t"] is not None \
                    and info["first_step_end_t"] is None:
                torch.cuda.synchronize()
                info["first_step_end_t"] = time.perf_counter()
            state.step += 1
            state.commit()
            iteration_s.append(time.perf_counter() - t_iter)
            if mode == "elastic" and state.step == ELASTIC_REFORM_AT \
                    and info["interrupt_t"] is None:
                from horovod_tpu_torch.elastic.rendezvous import (
                    get_worker_rendezvous)
                get_worker_rendezvous().kv.put(REFORM_REQUEST_KEY, b"1")
                deadline = time.monotonic() + 120
                while state._host_messages.empty():
                    if time.monotonic() > deadline:
                        raise TimeoutError("no new round was announced")
                    time.sleep(0.01)
        return state.losses

    try:
        losses = train(state)
    finally:
        gspmd_cache.CachedStep._capture = capture
    torch.cuda.synchronize()
    total = dict(flash.launches)
    eager = {k: total[k] - sum(c[k] for c in captures) for k in total}
    events = {dict(k).get("kind"): int(v) for k, v in
              metrics.ELASTIC_EVENTS.series().items()}
    out = {"losses": losses, "params_sha256": _params_sha256(model),
           "gspmd": gspmd_cache.stats(), "layers": cfg.num_layers,
           "dispatch_invalidations":
               dispatch_cache.stats()["invalidations"],
           "worlds": info["worlds"], "events": events,
           "launches_eager": eager, "recorded_at_capture": captures,
           "iteration_s": iteration_s}
    if mode == "autoscale":
        steps = list(metrics.ELASTIC_STEP_SECONDS.series().values())
        out["observer"] = {
            "steps": sum(h.count for h in steps),
            "step_s_mean": (sum(h.sum for h in steps)
                            / max(1, sum(h.count for h in steps))),
            "slo_violations": metrics.ELASTIC_SLO_VIOLATIONS.value(),
            "note_cost_s": note_cost}
    if info["interrupt_t"] is not None:
        out["reform_s"] = {
            "interrupt_to_training": info["entered_t"] - info["interrupt_t"],
            "interrupt_to_first_step_end":
                info["first_step_end_t"] - info["interrupt_t"]}
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _worker_run(argv, what: str, timeout: float = 600) -> float:
    """Run ``argv`` with its output relayed; returns its wall time."""
    t0 = time.time()
    proc = subprocess.run(argv, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-8000:])
    require(proc.returncode == 0, f"{what} exited {proc.returncode}")
    return t0


def phase_launch(dev) -> tuple[dict, dict]:
    """The trainer through the launcher: ``python -m
    horovod_tpu_torch.runner.launch -np 1 -- <trainer>`` on NCCL against
    the same trainer started directly (:func:`trainer_worker`, each in a
    process of its own): the per-step losses and the parameters must be
    bitwise equal, K1-K3 launched ``num_layers x STEPS`` times, and the
    launched worker must hold the launcher's contract (its card from the
    pool, the KV store). Prints the launcher's start-up time: spawn to
    ``init()`` done, launched against direct."""
    import tempfile
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.json")
                 for k in ("direct", "launched")}
        t_direct = _worker_run([sys.executable, me, TRAINER_WORKER_FLAG,
                                paths["direct"]], "the direct trainer")
        t_launch = _worker_run(LAUNCH + ["-np", "1", "--", sys.executable,
                                         me, TRAINER_WORKER_FLAG,
                                         paths["launched"]],
                               "the launched trainer")
        runs = {}
        for k in paths:
            with open(paths[k]) as f:
                runs[k] = json.load(f)
    direct, launched = runs["direct"], runs["launched"]
    startup = {"direct_s": direct["t_init"] - t_direct,
               "launched_s": launched["t_init"] - t_launch}
    startup["launcher_s"] = startup["launched_s"] - startup["direct_s"]
    print(f"[launch] launched worker: world {launched['world']} on "
          f"{launched['device']} ({launched['backend']}), env "
          f"{launched['env']}")
    print(f"[launch] losses direct {['%.6f' % x for x in direct['losses']]}"
          f", launched {['%.6f' % x for x in launched['losses']]}; bitwise "
          f"{launched['losses'] == direct['losses']}, parameters bitwise "
          f"{launched['params_sha256'] == direct['params_sha256']}")
    print(f"[launch] start-up, spawn to init() done: direct "
          f"{startup['direct_s']:.2f} s, through the launcher "
          f"{startup['launched_s']:.2f} s (the launcher's own "
          f"{startup['launcher_s']:.2f} s) on {nvidia_smi()}")
    print(f"[launch] kernel launches: launched {launched['launches']}, "
          f"direct {direct['launches']}")
    want = launched["layers"] * STEPS
    require(launched["world"] == 1 and launched["backend"] == "nccl"
            and launched["env"]["HVD_CUDA_DEVICE"] == "0"
            and launched["env"]["HVD_KV_ADDR"] is not None,
            f"launch: the launched worker's world {launched}")
    require(launched["losses"] == direct["losses"]
            and launched["params_sha256"] == direct["params_sha256"],
            "launch: the launched trainer is not bitwise the direct one")
    require(all(math.isfinite(x) for x in launched["losses"])
            and launched["losses"][-1] < launched["losses"][0],
            f"launch: losses {launched['losses']}")
    require(all(v == want for v in launched["launches"].values())
            and launched["launches"] == direct["launches"],
            f"launch: K1-K3 launches {launched['launches']}, want {want}")
    return {"losses": launched["losses"], "startup": startup,
            "bitwise": True,
            "direct": {k: direct[k] for k in ("losses", "params_sha256")}
            }, launched["launches"]


def phase_elastic(dev) -> tuple[dict, dict]:
    """The cached trainer under ``hvd.elastic.run`` through the elastic
    launcher at ``--min-np 1 --max-np 1`` (:func:`elastic_worker`): at the
    worker's request after commit ELASTIC_REFORM_AT, this process (the
    launcher's side: :func:`elastic.launch.start_elastic`) publishes a new
    round through the driver that keeps rank 0's slot. The worker must
    re-form in its own process: ``HostsUpdatedInterrupt`` once, its graphs
    dropped, its NCCL process group ended and made anew (a new generation
    and group on the same card), ``cached_step`` recording again (2 records
    in all), and its losses and parameters after ELASTIC_STEPS steps
    bitwise those of the same run uninterrupted (started directly).
    Prints the re-form's time, interrupt to the first step of the new
    round."""
    import tempfile
    from horovod_tpu_torch.elastic import launch as elastic_launch
    from horovod_tpu_torch.elastic.driver import ROUND_KEY
    from horovod_tpu_torch.runner import launch as launch_mod
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "reference.json")
        el_path = os.path.join(tmp, "elastic.json")
        _worker_run([sys.executable, me, ELASTIC_WORKER_FLAG, ref_path,
                     "reference"], "the uninterrupted elastic trainer")
        args = launch_mod.parse_args(
            ["--min-np", "1", "--max-np", "1", "-H", "localhost:1", "--",
             sys.executable, me, ELASTIC_WORKER_FLAG, el_path, "elastic"])
        job = elastic_launch.start_elastic(args, args.command[1:])
        try:
            deadline = time.monotonic() + 600
            while job.infra.kv.get(REFORM_REQUEST_KEY) is None:
                require(not job.driver.finished()
                        and time.monotonic() < deadline,
                        "elastic: the worker never asked for a new round")
                time.sleep(0.01)
            job.driver.resume()  # a new round; the slot stays
            rounds = int(job.infra.kv.get(ROUND_KEY))
        finally:
            rc = job.wait()
        require(rc == 0, f"elastic: the launcher's job exited {rc}")
        with open(ref_path) as f:
            ref = json.load(f)
        with open(el_path) as f:
            el = json.load(f)
    worlds = el["worlds"]
    events = el["gspmd"]["events"]
    layers = el["layers"]
    print(f"[elastic] rounds {rounds}; worlds the worker trained in "
          f"{worlds}; recovery events {el['events']}")
    print(f"[elastic] cached step: builds {el['gspmd']['builds']}, events "
          f"{events}; dispatch invalidations "
          f"{el['dispatch_invalidations']}")
    print(f"[elastic] losses {['%.6f' % x for x in el['losses']]} against "
          f"the uninterrupted run's: bitwise {el['losses'] == ref['losses']}"
          f"; parameters bitwise "
          f"{el['params_sha256'] == ref['params_sha256']}")
    print(f"[elastic] re-form: interrupt to training again "
          f"{el['reform_s']['interrupt_to_training'] * 1e3:.1f} ms, to the "
          f"end of the new round's first step (its record and capture) "
          f"{el['reform_s']['interrupt_to_first_step_end'] * 1e3:.1f} ms "
          f"on {nvidia_smi()}")
    print(f"[elastic] K1-K3 in the records' eager runs {el['launches_eager']}"
          f" (recorded at each capture {el['recorded_at_capture']})")
    require(rounds == 2 and len(worlds) == 2
            and el["events"].get("hosts-updated") == 1
            and "peer-failure" not in el["events"],
            f"elastic: want one re-form by HostsUpdatedInterrupt, got "
            f"{worlds}, {el['events']}")
    require(all(w["backend"] == "nccl" and w["size"] == 1
                and w["device"] == str(dev) for w in worlds)
            and worlds[0]["generation"] != worlds[1]["generation"]
            and worlds[0]["master_port"] != worlds[1]["master_port"],
            f"elastic: the process group was not made anew: {worlds}")
    require(events.get("recorded") == 2 and el["gspmd"]["builds"] == 2
            and events.get("fallback", 0) == 0
            and el["dispatch_invalidations"] >= 1,
            f"elastic: cached_step {el['gspmd']}, want 2 records")
    require(el["losses"] == ref["losses"]
            and el["params_sha256"] == ref["params_sha256"],
            "elastic: the re-formed run is not bitwise the uninterrupted one")
    require(all(v == 2 * layers for v in el["launches_eager"].values()),
            f"elastic: K1-K3 launches {el['launches_eager']}, want "
            f"{2 * layers} each (two records' eager steps)")
    return {"losses": el["losses"], "reform_s": el["reform_s"],
            "gspmd": el["gspmd"], "worlds": worlds, "bitwise": True,
            "reference": {k: ref[k] for k in (
                "losses", "params_sha256", "launches_eager")}
            }, el["launches_eager"]


# The autoscale phase: an SLO far below the trainer's step (26-40 ms) and
# its commit of the 557 MB state (218-1364 ms, PERF.md), so that every window
# breaches; a window every 0.1 s, so that every commit's blob is one
# window; one policy.eval fault.
AUTOSCALE_ENV = {"HVD_AUTOSCALE": "1", "HVD_AUTOSCALE_SLO_MS": "10",
                 "HVD_AUTOSCALE_INTERVAL": "0.1",
                 "HVD_AUTOSCALE_BREACH_WINDOWS": "2"}
AUTOSCALE_FAULT = "policy.eval:error:times=1"
OBSERVER_AGREEMENT = 0.25  # observer's mean step time vs the worker's own


def phase_autoscale(dev, elastic) -> tuple[dict, dict]:
    """The cached trainer of ``[elastic]`` under ``hvd.elastic.run`` through
    ``start_elastic`` at ``--min-np 1 --max-np 1`` with ``HVD_AUTOSCALE=1``
    and an SLO below its step time (``AUTOSCALE_ENV``), uninterrupted
    (``--elastic-worker ... autoscale``); this process runs the driver and
    the policy, with one ``policy.eval`` fault. Requires: sensor blobs of
    the job's round; the breach streak past
    ``HVD_AUTOSCALE_BREACH_WINDOWS`` and no membership decision (the world
    is at its ceiling); the fault a counted ``hold``/``error`` and the job
    done; the observer's mean step time within ``OBSERVER_AGREEMENT`` of
    the worker's own; losses and parameters bitwise ``[elastic]``'s
    uninterrupted run with the policy off; K1-K3 ``num_layers`` launches
    each (the record's eager step). Prints the observer's cost a commit,
    on against off in turns."""
    import tempfile
    from horovod_tpu_torch.elastic import launch as elastic_launch
    from horovod_tpu_torch.elastic import policy
    from horovod_tpu_torch.elastic.driver import ROUND_KEY
    from horovod_tpu_torch.runner import launch as launch_mod
    from horovod_tpu_torch.utils import faults
    me = os.path.abspath(__file__)
    blobs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autoscale.json")
        os.environ["HVD_FAULT_SPEC"] = AUTOSCALE_FAULT
        faults.refresh()
        try:
            args = launch_mod.parse_args(
                ["--min-np", "1", "--max-np", "1", "-H", "localhost:1",
                 *[a for k, v in AUTOSCALE_ENV.items()
                   for a in ("--env", f"{k}={v}")],
                 "--", sys.executable, me, ELASTIC_WORKER_FLAG, path,
                 "autoscale"])
            job = elastic_launch.start_elastic(args, args.command[1:])
            try:
                require(job.policy is not None,
                        "autoscale: HVD_AUTOSCALE=1 started no policy")
                deadline = time.monotonic() + 600
                while not job.driver.finished():
                    require(time.monotonic() < deadline,
                            "autoscale: the job did not finish")
                    raw = job.infra.kv.get(policy.sensor_key(0))
                    if raw is not None:
                        blob = json.loads(raw.decode())
                        blobs[blob["seq"]] = blob
                    time.sleep(0.02)
                rounds = int(job.infra.kv.get(ROUND_KEY))
            finally:
                rc = job.wait()
        finally:
            del os.environ["HVD_FAULT_SPEC"]
            faults.refresh()
        require(rc == 0, f"autoscale: the launcher's job exited {rc}")
        with open(path) as f:
            run = json.load(f)
    stats = job.policy.policy_stats()
    decisions = [(d["action"], d["reason"]) for d in stats["decisions"]]
    obs = run["observer"]
    own = run["iteration_s"][1:]  # the first holds the record and capture
    own_mean = sum(own) / len(own)
    cost = {k: sorted(v)[len(v) // 2] for k, v in obs["note_cost_s"].items()}
    print(f"[autoscale] sensor blobs {len(blobs)} (seq {sorted(blobs)}), "
          f"rounds {sorted({b['round'] for b in blobs.values()})} of job "
          f"round {rounds}; policy: breach streak {stats['breach_streak']} "
          f"(windows needed {AUTOSCALE_ENV['HVD_AUTOSCALE_BREACH_WINDOWS']}"
          f"), world {stats['world']}, bounds {stats['bounds']}, decisions "
          f"{decisions}")
    print(f"[autoscale] step time: observer {obs['step_s_mean'] * 1e3:.1f} "
          f"ms over {obs['steps']} steps ({obs['slo_violations']:.0f} over "
          f"the SLO), the worker's own {own_mean * 1e3:.1f} ms; losses "
          f"bitwise the policy-off run "
          f"{run['losses'] == elastic['reference']['losses']}, parameters "
          f"bitwise "
          f"{run['params_sha256'] == elastic['reference']['params_sha256']}")
    print(f"[autoscale] observer's cost a commit (median of "
          f"{len(obs['note_cost_s']['on'])}, in turns): on "
          f"{cost['on'] * 1e6:.1f} us, off {cost['off'] * 1e6:.2f} us on "
          f"{nvidia_smi()}")
    print(f"[autoscale] K1-K3 in the record's eager run "
          f"{run['launches_eager']}")
    require(blobs and all(b["round"] == rounds for b in blobs.values()),
            f"autoscale: no sensor blob of round {rounds}: {blobs}")
    require(stats["breach_streak"]
            > int(AUTOSCALE_ENV["HVD_AUTOSCALE_BREACH_WINDOWS"])
            and stats["world"] == 1 and stats["bounds"] == (1, 1),
            f"autoscale: breach streak {stats['breach_streak']}")
    require(decisions == [("hold", "error")],
            f"autoscale: want one hold/error and no membership decision, "
            f"got {decisions}")
    require(abs(obs["step_s_mean"] - own_mean)
            <= OBSERVER_AGREEMENT * own_mean and obs["steps"] == len(own),
            f"autoscale: observer {obs['step_s_mean']} s against the "
            f"worker's {own_mean} s")
    require(run["losses"] == elastic["reference"]["losses"]
            and run["params_sha256"]
            == elastic["reference"]["params_sha256"],
            "autoscale: the run is not bitwise the policy-off run")
    require(all(v == run["layers"] for v in run["launches_eager"].values()),
            f"autoscale: K1-K3 launches {run['launches_eager']}")
    return {"blobs": len(blobs), "breach_streak": stats["breach_streak"],
            "decisions": decisions,
            "observer_step_ms": obs["step_s_mean"] * 1e3,
            "worker_step_ms": own_mean * 1e3,
            "note_cost_us": {k: v * 1e6 for k, v in cost.items()},
            "bitwise": True}, run["launches_eager"]


def returning_trainer_worker(out_path: str) -> dict:
    """:func:`trainer_worker` in an actor or task process; returns what it
    wrote."""
    trainer_worker(out_path)
    with open(out_path.format(rank=int(os.environ.get("RANK", "0")))) as f:
        return json.load(f)


def returning_elastic_worker(out_path: str, mode: str) -> dict:
    """:func:`elastic_worker` in an actor process; returns what it wrote."""
    elastic_worker(out_path, mode)
    with open(out_path) as f:
        return json.load(f)


def phase_ray(dev, launch, elastic) -> tuple[dict, dict]:
    """The Ray executors over ``testing.make_process_ray`` (an actor is a
    child process) on ``cuda:0`` at an NCCL world of 1, the stub's node
    offering Ray this machine's cards as GPUs, as a Ray node on it would:
    each actor asks for one and sees only that one.
    ``RayExecutor(num_workers=1)`` runs :func:`trainer_worker`, which must
    be bitwise ``[launch]``'s direct run with K1-K3 ``num_layers x STEPS``
    launches, on the card Ray gave the actor;
    ``ElasticRayExecutor(min_workers=1, max_workers=1)`` runs
    :func:`elastic_worker` uninterrupted, bitwise ``[elastic]``'s
    reference. Prints the executor's start-up against ``[launch]``'s."""
    import tempfile
    from horovod_tpu_torch import testing
    sys.modules["ray"] = ray = testing.make_process_ray(
        gpus=torch.cuda.device_count())
    try:
        from horovod_tpu_torch.ray import ElasticRayExecutor, RayExecutor
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            ex = RayExecutor(num_workers=1)
            ex.start()
            try:
                (static,) = ex.run(returning_trainer_worker, args=(
                    os.path.join(tmp, "static.{rank}.json"),))
            finally:
                ex.shutdown()
            t1 = time.time()
            ex = ElasticRayExecutor(min_workers=1, max_workers=1,
                                    elastic_timeout=600)
            ex.start()
            try:
                results = ex.run(returning_elastic_worker, args=(
                    os.path.join(tmp, "elastic.json"), "reference"))
            finally:
                ex.shutdown()
            t2 = time.time()
    finally:
        ray.shutdown()
        del sys.modules["ray"]
    require(len(results) == 1, f"ray: elastic results {len(results)}")
    el = results[0]
    direct = launch["direct"]
    startup = {"ray_s": static["t_init"] - t0,
               "launched_s": launch["startup"]["launched_s"],
               "direct_s": launch["startup"]["direct_s"]}
    print(f"[ray] RayExecutor's worker: world {static['world']} on "
          f"{static['device']} ({static['backend']}), env {static['env']}; "
          f"losses bitwise [launch]'s direct run "
          f"{static['losses'] == direct['losses']}, parameters bitwise "
          f"{static['params_sha256'] == direct['params_sha256']}; K1-K3 "
          f"{static['launches']}")
    print(f"[ray] ElasticRayExecutor: worlds {el['worlds']}; losses bitwise "
          f"[elastic]'s reference "
          f"{el['losses'] == elastic['reference']['losses']}"
          f", parameters bitwise "
          f"{el['params_sha256'] == elastic['reference']['params_sha256']}; "
          f"K1-K3 in the record's eager run {el['launches_eager']}")
    print(f"[ray] start-up, start() to init() done: RayExecutor "
          f"{startup['ray_s']:.2f} s, against [launch]'s launcher "
          f"{startup['launched_s']:.2f} s and direct {startup['direct_s']:.2f}"
          f" s; the static run {t1 - t0:.1f} s, the elastic {t2 - t1:.1f} s "
          f"on {nvidia_smi()}")
    want = static["layers"] * STEPS
    require(static["world"] == 1 and static["backend"] == "nccl"
            and static["env"]["HVD_CUDA_DEVICE"] == "0"
            and static["env"]["CUDA_VISIBLE_DEVICES"] == "0"
            and static["device"] == str(dev),
            f"ray: the actor's world {static}")
    require(static["losses"] == direct["losses"]
            and static["params_sha256"] == direct["params_sha256"],
            "ray: RayExecutor's trainer is not bitwise the direct one")
    require(all(v == want for v in static["launches"].values()),
            f"ray: K1-K3 launches {static['launches']}, want {want}")
    require(len(el["worlds"]) == 1 and el["worlds"][0]["backend"] == "nccl"
            and el["losses"] == elastic["reference"]["losses"]
            and el["params_sha256"] == elastic["reference"]["params_sha256"],
            "ray: ElasticRayExecutor's run is not bitwise [elastic]'s "
            "reference")
    require(el["launches_eager"] == elastic["reference"]["launches_eager"],
            f"ray: elastic K1-K3 launches {el['launches_eager']}")
    return {"losses": static["losses"], "startup": startup, "bitwise": True,
            "elastic_launches": el["launches_eager"]}, static["launches"]


# The spark phase's fit: FIT_SEQS seeded sequences of SEQ tokens, BATCH a
# step, Adam at 1e-3 (the estimator's default).
FIT_SEQS = 16


def fit_lm_init(generator, batch):
    """The estimator's recipe: the full-width TransformerLM (the trainer's
    configuration) on the batch's device, from ``generator``."""
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    model = TransformerLM(TransformerConfig(attn_mode="ulysses"),
                          device=batch[0].device)
    model.reset_parameters(generator)
    return model


def fit_lm_loss(model, batch):
    from horovod_tpu_torch.models import lm_loss
    (tokens,) = batch
    return lm_loss(model(tokens), tokens)


def _beside(fn, *args, **kwargs):
    """Start ``fn(*args, **kwargs)`` on a thread; returns a function that
    waits for it and returns its result or raises its error."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # raised by the caller's wait
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return wait


def phase_spark(dev, launch) -> tuple[dict, dict]:
    """Spark over ``testing.make_process_pyspark`` (a barrier task is a
    child process) on ``cuda:0``: ``spark.run(num_proc=1)`` of
    :func:`trainer_worker`, bitwise ``[launch]``'s direct run with K1-K3
    ``num_layers x STEPS`` launches; then ``spark.fit`` of the full-width
    TransformerLM from FIT_SEQS seeded sequences with a ``store_path``: 2
    epochs; a rerun at 2 epochs runs 0 and gives the same parameters; a
    3-epoch fit resumed from that Store must equal a 3-epoch fit from
    scratch bit for bit. Prints the per-epoch checkpoint's size, and its
    save and load times on this host (the Store's tree saved again)."""
    import tempfile
    from horovod_tpu_torch import checkpoint, testing
    sys.modules["pyspark"] = testing.make_process_pyspark()
    try:
        import horovod_tpu_torch.spark as spark
        from horovod_tpu_torch.spark import estimator
        with tempfile.TemporaryDirectory() as tmp:
            tokens = synthetic_tokens(FIT_SEQS, SEQ, 32000, seed=1)
            store = os.path.join(tmp, "store")
            fit = dict(batch_size=BATCH, num_proc=1, seed=0)
            # the trainer's task and the 3-epoch fit from scratch run beside
            # the Store's fits (task processes of their own on the same
            # card): they share nothing with them
            t0 = time.time()
            run_join = _beside(spark.run, returning_trainer_worker, args=(
                os.path.join(tmp, "run.{rank}.json"),), num_proc=1)
            scratch_join = _beside(
                spark.fit, (tokens,), fit_lm_init, fit_lm_loss, epochs=3,
                store_path=os.path.join(tmp, "scratch"), **fit)
            try:
                two = spark.fit((tokens,), fit_lm_init, fit_lm_loss,
                                epochs=2, store_path=store, **fit)
                t_fit = time.time() - t0
                (rerun,) = spark.run(estimator._fit_task, args=(
                    (tokens,), fit_lm_init, fit_lm_loss, None, 2, BATCH,
                    True, 0, store, None), num_proc=1)
                resumed = spark.fit((tokens,), fit_lm_init, fit_lm_loss,
                                    epochs=3, store_path=store, **fit)
            finally:
                (run,) = run_join()
                scratch = scratch_join()
            t_all = time.time() - t0
            ckpt_dir = os.path.join(store, "checkpoints")
            steps = checkpoint.Checkpointer(ckpt_dir).all_steps()
            mb = sum(os.path.getsize(os.path.join(ckpt_dir, "1", f))
                     for f in os.listdir(os.path.join(ckpt_dir, "1"))) / 1e6
            t0 = time.perf_counter()
            tree = checkpoint.Checkpointer(ckpt_dir).restore(step=1)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            checkpoint.Checkpointer(os.path.join(tmp, "again")).save(1, tree)
            save_s = time.perf_counter() - t0
    finally:
        del sys.modules["pyspark"]

    def same(a, b):
        return a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)

    direct = launch["direct"]
    finite = all(np.isfinite(v).all() for v in two.values())
    print(f"[spark] spark.run's task: world {run['world']} on "
          f"{run['device']} ({run['backend']}), env {run['env']}; losses "
          f"bitwise [launch]'s direct run {run['losses'] == direct['losses']}"
          f", parameters bitwise "
          f"{run['params_sha256'] == direct['params_sha256']}; K1-K3 "
          f"{run['launches']}")
    print(f"[spark] fit of the full-width TransformerLM ({FIT_SEQS} x {SEQ} "
          f"tokens, batch {BATCH}): 2 epochs in {t_fit:.1f} s (beside the "
          f"trainer's task and the 3-epoch fit from scratch; all five "
          f"tasks {t_all:.1f} s), finite "
          f"{finite}; the rerun ran {rerun['epochs_run']} epochs, same "
          f"parameters {same(rerun['params'], two)}; 3 epochs resumed "
          f"from the Store bitwise 3 from scratch {same(resumed, scratch)} "
          f"(and not the 2-epoch state: {not same(resumed, two)}); Store "
          f"steps {steps}")
    print(f"[spark] the per-epoch checkpoint: {mb:.1f} MB (parameters and "
          f"Adam's moments), saved again here in {save_s * 1e3:.1f} ms and "
          f"loaded in {load_s * 1e3:.1f} ms on {nvidia_smi()}")
    want = run["layers"] * STEPS
    require(run["world"] == 1 and run["backend"] == "nccl"
            and run["env"]["HVD_CUDA_DEVICE"] == "0"
            and run["device"] == str(dev), f"spark: the task's world {run}")
    require(run["losses"] == direct["losses"]
            and run["params_sha256"] == direct["params_sha256"],
            "spark: spark.run's trainer is not bitwise the direct one")
    require(all(v == want for v in run["launches"].values()),
            f"spark: K1-K3 launches {run['launches']}, want {want}")
    require(finite and rerun["epochs_run"] == 0
            and same(rerun["params"], two),
            "spark: the rerun at the Store's epochs did not run 0 epochs "
            "to the same parameters")
    require(same(resumed, scratch) and not same(resumed, two)
            and steps == [0, 1, 2],
            "spark: the fit resumed from the Store is not bitwise the fit "
            "from scratch")
    return {"losses": run["losses"], "fit_s": t_fit, "tasks_s": t_all,
            "checkpoint": {"mb": mb, "save_ms": save_s * 1e3,
                           "load_ms": load_s * 1e3},
            "bitwise": True}, run["launches"]


def phase_moe(dev):
    """The MoE TransformerLM at full width with one expert at NCCL world 1:
    ``TransformerConfig(attn_mode="ulysses", moe_experts=1)``, bf16, 8 x
    2048 tokens, ``DistributedOptimizer(Adam)`` with the reference trainer's
    ``0.01 * moe_aux_loss()``, STEPS steps. With one expert the gate is 1,
    the capacity (20480) drops nothing and the load-balance loss is 1."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from horovod_tpu_torch.ops import flash
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    cfg = TransformerConfig(attn_mode="ulysses", moe_experts=1)
    model = TransformerLM(cfg, device=dev, expert_group=dist.group.WORLD)
    model.reset_parameters(torch.Generator().manual_seed(0))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    tokens = torch.from_numpy(
        synthetic_tokens(BATCH, SEQ, cfg.vocab_size, 0)).to(dev)
    # the dense model on the same weights, expert 0 as its MLP
    dense = TransformerLM(TransformerConfig(attn_mode="ulysses"), device=dev)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("mlp.w_in"):
            sd[k.replace("w_in", "wi.weight")] = v[0].t()
        elif k.endswith("mlp.w_out"):
            sd[k.replace("w_out", "wo.weight")] = v[0].t()
        elif not k.endswith("mlp.router.weight"):
            sd[k] = v
    dense.load_state_dict(sd)
    with torch.no_grad():  # the first step's forward, on the same weights
        diff = (model(tokens) - dense(tokens)).abs()
    first = {"max_abs": diff.max().item(), "mean_abs": diff.mean().item()}
    del dense, sd, diff
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))
    n_params = sum(p.numel() for p in model.parameters())

    def step():
        opt.zero_grad()
        logits = model(tokens)
        aux = model.moe_aux_loss()
        loss = lm_loss(logits, tokens) + 0.01 * aux
        with torch.profiler.record_function("backward"):
            loss.backward()
        opt.step()
        return loss.item(), [b.mlp.aux.item() for b in model.blocks]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, auxes, step_s = [], [], []
    flash.reset_launch_counts()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss, aux = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        auxes.append(aux)
    launches = dict(flash.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _profile_step(step, kinds=MOE_PROFILE_KINDS)
    steady = sum(step_s[1:]) / (STEPS - 1)
    print(f"[moe] TransformerLM {n_params / 1e6:.1f} M params, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, 1 expert (capacity factor "
          f"{cfg.moe_capacity_factor}), bf16, ulysses; batch {BATCH} x "
          f"{SEQ} tokens; NCCL world 1")
    print(f"[moe] losses {['%.4f' % x for x in losses]}; load-balance "
          f"losses of the blocks, per step: {auxes}")
    print(f"[moe] step time {steady * 1e3:.1f} ms (mean of steps 2-{STEPS};"
          f" step 1 {step_s[0] * 1e3:.1f} ms), {BATCH * SEQ / steady:.0f} "
          f"tokens/s, peak memory {peak:.2f} GiB on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"[moe] first-step logits against the dense model on the same "
          f"weights: max abs {first['max_abs']:.4g}, mean abs "
          f"{first['mean_abs']:.4g} (limits {MOE_LOGITS_AGREEMENT})")
    print(f"[moe] kernel launches {launches}")
    require(all(math.isfinite(x) for x in losses), "moe: loss is not finite")
    require(losses[-1] < losses[0], "moe: loss did not fall")
    require(all(a == 1.0 for step_aux in auxes for a in step_aux),
            f"moe: load-balance losses {auxes}, want exactly 1 a block")
    want_launches = cfg.num_layers * STEPS
    require(all(v == want_launches for v in launches.values()),
            f"moe: launch counts {launches}, want {want_launches} each")
    require(all(first[k] <= v for k, v in MOE_LOGITS_AGREEMENT.items()),
            f"moe: first-step logits {first} against the dense model")
    del model, opt
    hvd.shutdown()
    torch.cuda.empty_cache()
    return {"step_ms": steady * 1e3, "tokens_per_s": BATCH * SEQ / steady,
            "peak_memory_gib": peak, "losses": losses, "aux": auxes,
            "step_s": step_s, "logits_vs_dense": first,
            "profile": profile}, launches


PIPELINE_ARGS = ["--model", "full", "--pp", "1", "--steps", str(STEPS)]


def phase_pipeline(dev):
    """The pipeline twin (``examples/pipeline_train.py --model full``: vocab
    32000, d_model 512, hidden 2048, 4 residual-MLP blocks, 8 x 2048 tokens,
    bf16) at pp 1 with 4 microbatches, NCCL world 1: its loss must fall."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import pipeline_train as pt
    from horovod_tpu_torch.ops import flash
    hvd.init(process_sets="dynamic")
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    res, _ = pt.train(pt.parse_args(PIPELINE_ARGS))
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(flash.launches)
    hvd.shutdown()
    torch.cuda.empty_cache()
    steady = sum(res["step_s"][1:]) / (len(res["step_s"]) - 1)
    tokens = res["tokens_per_replica"]
    print(f"[pipeline] twin --model full, pp {res['pp']} x dp {res['dp']}, "
          f"{res['n_micro']} microbatches, {tokens} tokens: losses "
          f"{['%.4f' % x for x in res['losses']]}")
    print(f"[pipeline] step time {steady * 1e3:.1f} ms (mean of steps 2-"
          f"{len(res['step_s'])}; step 1 {res['step_s'][0] * 1e3:.1f} ms), "
          f"{tokens / steady:.0f} tokens/s, peak memory {peak:.2f} GiB; "
          f"port kernel launches {launches} (the stages are GEMMs)")
    require(all(math.isfinite(x) for x in res["losses"]),
            "pipeline: loss is not finite")
    require(res["losses"][-1] < res["losses"][0],
            "pipeline: loss did not fall")
    return {"step_ms": steady * 1e3, "tokens_per_s": tokens / steady,
            "peak_memory_gib": peak, "losses": res["losses"],
            "step_s": res["step_s"]}


# The long-context phase's agreement of the three modes' first-step logits
# (float32 (1, 16384, 32000) from bf16 compute, on the same weights). At one
# rank ``ring`` and ``ulysses`` make the same kernel calls and agree
# bitwise; ``ring_zigzag`` sums the past half of each row's keys in another
# order, so its bf16 attention output may round to the neighbouring value
# (2^-8 relative) and the difference passes through the later layers.
# H100 80GB HBM3 at 700 W: zigzag against ring 0.0352 and 0.00178, Ulysses
# against ring 0 (bitwise).
LOGITS_AGREEMENT = {"max_abs": 0.25, "mean_abs": 1e-2}

# Each mode's blocks (sq, sk, qpos0, kpos0) at one rank, launched once a
# layer by each kernel: ring and Ulysses attend the whole block at (0, 0);
# the zigzag holds chunks 0 and 1 of the 2 and attends their diagonal
# halves and the past one.
_C = LC_SEQ // 2
LC_BLOCKS = {"ring": {(LC_SEQ, LC_SEQ, 0, 0)},
             "ulysses": {(LC_SEQ, LC_SEQ, 0, 0)},
             "ring_zigzag": {(_C, _C, 0, 0), (_C, _C, _C, 0),
                             (_C, _C, _C, _C)}}


@contextlib.contextmanager
def recorded_blocks():
    """Record the (sq, sk, qpos0, kpos0) of every kernel launch while the
    block runs, by kernel: a Counter each. The launch counters are the
    wrappers' own and stay as they are."""
    from horovod_tpu_torch.ops import flash
    seen = {n: collections.Counter() for n in flash.launches}
    originals = {n: getattr(flash, "_launch_" + n[len("flash_"):])
                 for n in seen}

    def recorder(name, launch):
        at = (3, 4) if name == "flash_fwd" else (6, 7)

        def run(*args):
            seen[name][(args[0].shape[1], args[1].shape[1],
                        int(args[at[0]]), int(args[at[1]]))] += 1
            return launch(*args)
        return run

    for n, launch in originals.items():
        setattr(flash, launch.__name__, recorder(n, launch))
    try:
        yield seen
    finally:
        for launch in originals.values():
            setattr(flash, launch.__name__, launch)


LONG_CONTEXT_FLAG = "--long-context"


def long_context(dev) -> dict:
    """The long-context twin's step at full width over LC_SEQ tokens in
    each mode (``LC_MODES``): per mode the step time (mean of the timed
    steps), tokens/s, peak memory and kernel launches a step, with the
    checks listed in the module docstring. It runs first thing in a process
    of its own (:func:`phase_long_context`), and the modes are all timed
    before any step runs under the profiler: a profiled step leaves the
    later steps of its process slower. Then, per mode, a fresh twin takes
    one step and profiles the next (no mode's model outlives its run, so
    each peak is its own). Returns the numbers by mode."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import long_context_lm as lc
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.ops import flash
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    out, first, failed = {}, None, []
    layers = TransformerConfig().num_layers
    argv = lambda mode, steps: lc.parse_args(
        ["--model", "full", "--attn", mode, "--seq-len", str(LC_SEQ),
         "--batch", "1", "--steps", str(steps)])
    for mode in LC_MODES:
        gc.collect()  # the last mode's model, optimizer and hooks
        torch.cuda.empty_cache()
        flash.reset_launch_counts()
        with recorded_blocks() as blocks:
            res = lc.train(argv(mode, LC_WARMUP + LC_TIMED),
                           keep_first_logits=True)[0]
        launches = dict(flash.launches)
        steps = len(res["losses"])
        logits = res.pop("first_logits")
        if first is None:
            first = (mode, logits)
        else:
            diff = (logits - first[1]).abs()
            agree = {"max_abs": diff.max().item(),
                     "mean_abs": diff.mean().item()}
            del diff
            res["logits_vs_" + first[0]] = agree
            print(f"[long-context] first-step logits {mode} vs {first[0]}: "
                  + ", ".join(f"{k} {v:.4g} (limit {LOGITS_AGREEMENT[k]:g})"
                              for k, v in agree.items()))
            failed += [f"{mode} logits {k}" for k, v in agree.items()
                       if not v <= LOGITS_AGREEMENT[k]]
        del logits
        step = sum(res["step_s"][LC_WARMUP:]) / LC_TIMED
        res.update(step_ms=step * 1e3, tokens_per_s=LC_SEQ / step,
                   launches=launches,
                   blocks={n: {str(b): c for b, c in cnt.items()}
                           for n, cnt in blocks.items()})
        out[mode] = res
        per_step = len(LC_BLOCKS[mode]) * layers
        print(f"[long-context] {mode}: TransformerLM "
              f"{res['num_params'] / 1e6:.1f} M params, bf16, 1 x {LC_SEQ} "
              f"tokens, NCCL world 1; step {step * 1e3:.1f} ms (mean of "
              f"steps {LC_WARMUP + 1}-{steps}; step 1 "
              f"{res['step_s'][0] * 1e3:.1f} ms), {LC_SEQ / step:.0f} "
              f"tokens/s, peak memory {res['peak_memory_gib']:.2f} GiB; "
              f"losses {['%.4f' % x for x in res['losses']]}; launches a "
              f"step {res['launches_per_step'][-1]} (want {per_step} each)")
        print(f"[long-context] {mode}: blocks launched "
              f"{ {n: dict(c) for n, c in blocks.items()} }")
        if not all(math.isfinite(x) for x in res["losses"]):
            failed.append(f"{mode}: loss is not finite")
        if not res["losses"][-1] < res["losses"][0]:
            failed.append(f"{mode}: loss did not fall")
        if any(v != per_step for d in res["launches_per_step"]
               for v in d.values()) or set(launches.values()) != {
                   per_step * steps}:
            failed.append(f"{mode}: launches {res['launches_per_step']}, "
                          f"{launches}")
        want_blocks = {b: layers * steps for b in LC_BLOCKS[mode]}
        if any(dict(cnt) != want_blocks for cnt in blocks.values()):
            failed.append(f"{mode}: blocks {blocks}, want {want_blocks}")
    del first
    require(not failed, f"long-context phase: {failed}")
    for mode in LC_MODES:  # where the time goes, after the timing
        print(f"[long-context] {mode}: one profiled step")
        gc.collect()
        torch.cuda.empty_cache()
        out[mode]["profile"] = _profile_step(lc.train(argv(mode, 1))[1])
    hvd.shutdown()
    return out


def phase_long_context() -> dict:
    """:func:`long_context` in a fresh process of its own."""
    return run_child(LONG_CONTEXT_FLAG, "long-context")


def ring_patterns() -> list:
    """``(where, sq, sk, qpos0, kpos0)`` of every block the long-context
    phase launches (``LC_BLOCKS``), and of every live block that rank
    RING_N - 1 of a contiguous causal ring of RING_N over RING_SEQ tokens
    and rank 0 of a zigzag ring of RING_N launch (the port's schedules)."""
    from horovod_tpu_torch.parallel import sequence
    blk, c = RING_SEQ // RING_N, RING_SEQ // (2 * RING_N)
    ring = [(qp, kp) for step in sequence.ring_schedule(RING_N - 1, RING_N,
                                                         blk, blk, True)
            for _, _, qp, kp in step]
    zig = [(qp, kp) for step in sequence.zigzag_schedule(0, RING_N, c)
           for _, _, qp, kp in step]
    path = sorted({b for blocks in LC_BLOCKS.values() for b in blocks},
                  reverse=True)
    return ([("long-context " + "/".join(m for m in LC_MODES
                                         if b in LC_BLOCKS[m]), *b)
             for b in path]
            + [(f"ring rank {RING_N - 1}", blk, blk, *b) for b in ring]
            + [("zigzag rank 0", c, c, *b) for b in zig])


def _scaled_limits(rows: int) -> dict:
    """``TRAINING_LIMITS`` with the counts of dq and dk rows over 1e-3
    scaled from the training shape's rows to ``rows`` (rounded up)."""
    train_rows = BATCH * 8 * SEQ
    return {n: {k: (math.ceil(v * rows / train_rows)
                    if k.endswith("_rows_over_1e-3") else v)
                for k, v in lim.items()} for n, lim in TRAINING_LIMITS.items()}


def _work(bh, sq, sk, d, pairs, itemsize) -> dict:
    """(flops, bytes) of each kernel on one block: each input read and each
    output written once, ``pairs`` live (query, key) pairs."""
    qkv = bh * (sq + 2 * sk) * d * itemsize
    carry = bh * sq * (d + 2) * 4
    grad_in = qkv + bh * sq * (d + 2) * 4  # + dout, lse, D (fp32)
    return {"flash_fwd": (4 * d * pairs, qkv + 2 * carry),
            "flash_bwd_dq": (6 * d * pairs, grad_in + bh * sq * d * 4),
            "flash_bwd_dkv": (8 * d * pairs, grad_in + 2 * bh * sk * d * 4)}


def phase_ring_patterns(dev) -> dict:
    """K1, K2 and K3 against their plain versions at every block of
    :func:`ring_patterns` (bh RING_BH, d 64, bf16, causal; the plain
    versions one bh slice at a time, :func:`by_slice`), then each timed
    on the fully-past block of RING_SEQ / RING_N square, every pair live,
    beside its plain version, the library (``scaled_dot_product_attention``
    without masking, forward; its backward for K2 and K3) and its bound.
    Returns the worst readings and the times."""
    from horovod_tpu_torch.ops import flash
    g = torch.Generator(device=dev).manual_seed(4)
    worst, failed, d = {n: {} for n in TRAINING_LIMITS}, [], 64
    for where, sq, sk, qpos0, kpos0 in ring_patterns():
        q, k, v, carries, lse, dout, D = _block_inputs(
            g, dev, torch.bfloat16, RING_BH, sq, sk, d, qpos0, kpos0, True)
        args = (q, k, v, qpos0, kpos0, True, *carries)
        errs = {"flash_fwd": _fwd_errs(flash._launch_fwd(*args),
                                       by_slice(flash.attend_plain, *args))}
        args = (q, k, v, lse, dout, D, qpos0, kpos0, True)
        errs["flash_bwd_dq"] = _dq_errs(
            flash._launch_bwd_dq(*args), by_slice(flash.plain_bwd_dq, *args),
            sq, sk, qpos0, kpos0, True)
        errs["flash_bwd_dkv"] = _dkv_errs(
            flash._launch_bwd_dkv(*args), by_slice(flash.plain_bwd_dkv, *args))
        del q, k, v, carries, lse, dout, D, args
        torch.cuda.synchronize()
        at = (f"ring-pattern {where} bh={RING_BH} sq={sq} sk={sk} "
              f"qpos0={qpos0} kpos0={kpos0} d={d} bf16 causal")
        limits = _scaled_limits(RING_BH * max(sq, sk))
        for n, e in errs.items():
            failed += [f"{at}: {f}" for f in _failures(n, e, at,
                                                       limits=limits)]
            for key, x in e.items():
                worst[n][key] = max(worst[n].get(key, 0), x)
    print(f"[ring-pattern] worst readings {worst}")
    require(not failed, f"ring patterns disagree with their plain versions: "
            f"{failed}")

    blk = RING_SEQ // RING_N
    qpos0, kpos0 = (RING_N - 1) * blk, 0  # rank 3's oldest block: all past
    q, k, v, carries, lse, dout, D = _block_inputs(
        g, dev, torch.bfloat16, RING_BH, blk, blk, d, qpos0, kpos0, True)
    args = (q, k, v, lse, dout, D, qpos0, kpos0, True)
    runs = {
        "flash_fwd": (lambda: flash._launch_fwd(q, k, v, qpos0, kpos0, True,
                                                *carries),
                      lambda: flash.attend_plain(q, k, v, qpos0, kpos0, True,
                                                 *carries)),
        "flash_bwd_dq": (lambda: flash._launch_bwd_dq(*args),
                         lambda: flash.plain_bwd_dq(*args)),
        "flash_bwd_dkv": (lambda: flash._launch_bwd_dkv(*args),
                          lambda: flash.plain_bwd_dkv(*args)),
    }
    F = torch.nn.functional
    q4, k4, v4 = (t.view(1, RING_BH, blk, d).detach().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, scale=1.0), 10)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    dout4 = dout.view(1, RING_BH, blk, d).to(torch.bfloat16)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), dout4, retain_graph=True), 10)
    pairs = RING_BH * unmasked_pairs(blk, blk, qpos0, kpos0, True)
    require(pairs == RING_BH * blk * blk, "the timed block is not all past")
    work = _work(RING_BH, blk, blk, d, pairs, q.element_size())
    times = {}
    for n, (kern, plain) in runs.items():
        flops, nbytes = work[n]
        bound_ms, bound_by = bound(flops, nbytes, torch.bfloat16)
        times[n] = {"ms": time_ms(kern, 10), "plain_ms": time_ms(plain, 3),
                    "library_ms": lib_fwd if n == "flash_fwd" else lib_bwd,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "flops": flops, "bytes": nbytes,
                    "shape": f"bh={RING_BH} sq=sk={blk} qpos0={qpos0} "
                             f"kpos0={kpos0} d={d} bf16 causal, every pair "
                             "live"}
        print(f"[ring-pattern] {n} on the fully-past block: "
              f"{times[n]['ms']:.3f} ms (plain {times[n]['plain_ms']:.3f} "
              f"ms, library {times[n]['library_ms']:.3f} ms, bound "
              f"{bound_ms:.3f} ms by {bound_by})")
    return {"errors": worst, "fully_past_block": times}


# The card-against-CPU cases: (model, image size, the card's compute dtype,
# train), each held against the same step in float64 on the CPU. ResNet-18
# trains in float32 with TF32 off. Inception V3's training-mode float32
# gradients are ill-conditioned, as the JAX model's are (flax's E[x^2] -
# E[x]^2 variance cancels where a channel's mean is large against its
# spread, and no residual path damps it: at 75x75 the CPU's float32
# gradients differ from its float64 ones by 16 %,
# ``tests/test_torch_vgg_inception.py``), so it trains in float64 on the
# card, and its float32 convolutions, pooling and their backward are held
# in eval mode, where no batch moments enter.
CONVNET_REFERENCE_CASES = (("ResNet18", 224, torch.float32, True),
                           ("InceptionV3", 299, torch.float64, True),
                           ("InceptionV3", 299, torch.float32, False))
# The card's float32 training-mode gradients are within the reference limit
# of the CPU's float64 ones or, where float32 itself is that far off, no
# further than this many times the CPU's own float32 gradients are
# (Inception V3's float64 route stands only while this holds).
FLOAT32_CONDITIONING_RATIO = 2.0
CONDITIONING_CASES = (("ResNet18", 224), ("InceptionV3", 299))
POOLING_LIMIT = 1e-5  # relative norm error of dx, float32


def phase_convnet_reference(dev) -> None:
    """The port's average pool's backward on a channels-last float32 tensor
    (torch's own is wrong on the card, ``testing.pooling_errors``), then
    ``CONVNET_REFERENCE_CASES`` held to ``testing.REFERENCE_LIMITS``; then,
    for ``CONDITIONING_CASES``, the float32 training-mode gradients on the
    card and on the CPU, each against the CPU's float64 ones, the card's
    gap held to the larger of the reference limit and
    ``FLOAT32_CONDITIONING_RATIO`` times the CPU's."""
    from horovod_tpu_torch import testing
    limits, failed = testing.REFERENCE_LIMITS, []
    show = lambda errs, lim=True: ", ".join(
        f"{k} {v:.3g}" + (f" (limit {limits[k]:g})" if lim else "")
        for k, v in errs.items())
    pool = testing.pooling_errors(dev)
    print(f"[convnets] 3x3 average pool with counted padding, backward on a "
          f"channels-last float32 tensor on the card vs float64: torch's "
          f"avg_pool2d dx {pool['avg_pool2d']:.3g}; the port's avg_pool_same "
          f"(pools a contiguous copy) {pool['avg_pool_same']:.3g} (limit "
          f"{POOLING_LIMIT:g})")
    if not pool["avg_pool_same"] <= POOLING_LIMIT:
        failed.append("avg_pool_same backward")
    for name, size, dtype, train in CONVNET_REFERENCE_CASES:
        errs = testing.convnet_reference_errors(name, size, dev, dtype,
                                                train)
        print(f"[convnets] reference {name} {size}x{size} batch 2 "
              f"{'train' if train else 'eval'} mode (TF32 off), card "
              f"{str(dtype)[6:]} vs CPU float64: {show(errs)}")
        failed += [f"{name} {str(dtype)[6:]} {k}" for k, v in errs.items()
                   if not v <= limits[k]]
    for name, size in CONDITIONING_CASES:
        cpu64, cpu32, card32 = testing.convnet_steps(
            name, size, [("cpu", torch.float64, True),
                         ("cpu", torch.float32, True),
                         (dev, torch.float32, True)])
        gaps = {"CPU float32": testing.step_errors(cpu32, cpu64),
                "card float32": testing.step_errors(card32, cpu64)}
        for who, errs in gaps.items():
            print(f"[convnets] conditioning {name} {size}x{size} batch 2 "
                  f"train mode: {who} vs CPU float64: {show(errs, False)}")
        gap, cpu_gap = (gaps[w]["grads_rel"]
                        for w in ("card float32", "CPU float32"))
        allowed = max(limits["grads_rel"],
                      FLOAT32_CONDITIONING_RATIO * cpu_gap)
        print(f"[convnets] conditioning {name}: the card's float32 gradient "
              f"gap is {gap / max(cpu_gap, 1e-30):.3g} times the CPU's "
              f"(limit: {allowed:.3g}, the larger of "
              f"{limits['grads_rel']:g} and {FLOAT32_CONDITIONING_RATIO:g} "
              f"times the CPU's)")
        if not gap <= allowed:
            failed.append(f"{name} float32 training gradients: the card's "
                          f"are {gap:.3g} from float64, the CPU's "
                          f"{cpu_gap:.3g}")
    require(not failed, f"convnets on the card disagree with the CPU: "
            f"{failed}")


def _check_run(res: dict, what: str = "") -> None:
    losses = res["losses"]
    print(f"[convnets] {res['model']} {res['image_size']}x"
          f"{res['image_size']} batch {res['batch_size']}{what}: "
          f"{res['img_sec']:.1f} images/s, step "
          f"{res['step_ms']:.2f} ms, peak memory "
          f"{res['peak_memory_gib']:.2f} GiB, {res['num_param_tensors']} "
          f"parameter tensors ({res['num_params'] / 1e6:.1f} M), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps "
          f"on {res['device']}")
    require(all(math.isfinite(v) for v in losses),
            f"{res['model']}{what}: loss is not finite")


# The synthetic-benchmark twin's runs: (key, flags).
CONVNET_TWIN_RUNS = (
    ("ResNet50/none", []),
    ("ResNet50/fp16", ["--fp16-allreduce"]),
    ("VGG16", ["--model", "VGG16", "--num-warmup", "1", "--num-iters", "3"]),
    ("InceptionV3", ["--model", "InceptionV3", "--image-size", "299",
                     "--num-warmup", "1", "--num-iters", "3"]),
)
CONVNET_TWINS_FLAG = "--convnet-twins"


def convnet_twins(dev) -> dict:
    """The synthetic-benchmark twin's timed runs (``CONVNET_TWIN_RUNS``) in
    one NCCL world of one card, first thing in a process of its own: work
    on the host before them (a CPU reference step, a profiled step, the
    earlier phases) leaves the host slower and the host-bound steps with
    it. Then, each on the ResNet-50 runs' own ``DistributedOptimizer``, the
    sync layer alone (``synchronize()``: pack, allreduce, unpack) and the
    SGD-momentum update alone, by :func:`time_ms`; last, one profiled step
    each, whose busy time is set against the timed step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    from horovod_tpu_torch.ops import flash
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    out, kept = {}, {}
    flash.reset_launch_counts()
    sbn.reset_launch_counts()
    for key, flags in CONVNET_TWIN_RUNS:
        res, step, opt = sb.train(sb.parse_args(flags))
        wire = key.partition("/")[2]  # the ResNet-50 runs name theirs
        _check_run(res, f", {wire} on the wire" if wire else "")
        out[key] = res
        if wire:
            require(res["losses"][-1] < res["losses"][0],
                    f"{key}: loss did not fall")
            kept[key] = step, opt
    launches = dict(flash.launches)
    batch_norm_launches = dict(sbn.launches)
    for key, (_, opt) in kept.items():
        res = out[key]
        res["sync_ms"] = time_ms(lambda: _sync_again(opt), 20)
        res["sgd_ms"] = time_ms(opt.optimizer.step, 20)
        print(f"[convnets] {key}: the sync layer alone (DistributedOptimizer."
              f"synchronize, {res['num_param_tensors']} gradients, world 1) "
              f"{res['sync_ms']:.3f} ms; the SGD-momentum update alone "
              f"{res['sgd_ms']:.3f} ms")
    for key, (step, _) in kept.items():
        res = out[key]
        res["profile"] = _profile_step(step)
        res["busy_share"] = res["profile"]["busy_ms"] / res["step_ms"]
        print(f"[convnets] {key}: device busy {res['profile']['busy_ms']:.1f}"
              f" ms of the timed {res['step_ms']:.2f} ms step "
              f"({100 * res['busy_share']:.1f} %)")
    hvd.shutdown()
    return {"runs": out, "launches": launches,
            "batch_norm_launches": batch_norm_launches}


def _sync_again(opt) -> None:
    """The optimizer's whole reduction once more: ``synchronize()`` does
    nothing a second time before ``step()``, so clear its mark before, and
    after, so that the next backward pass's hooks start buckets again."""
    opt._synced = False
    opt.synchronize()
    opt._synced = False


def run_child(flag: str, what: str) -> dict:
    """This script with ``flag`` in a child process, its output relayed;
    returns the JSON object of its last line."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          stdout=subprocess.PIPE, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    for line in lines[:-1] if proc.returncode == 0 else lines:
        print(line)
    require(proc.returncode == 0,
            f"the {what} process exited {proc.returncode}")
    return json.loads(lines[-1])


def phase_convnets(dev) -> dict:
    """The convnet path through its entry points: the synthetic-benchmark
    twin's runs in a fresh process (:func:`convnet_twins`), then the
    card-against-CPU reference and the MNIST twin's smoke epoch here."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import mnist
    from horovod_tpu_torch.ops import flash
    twins = run_child(CONVNET_TWINS_FLAG, "convnet twins'")
    phase_convnet_reference(dev)
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    flash.reset_launch_counts()
    res = mnist.train(mnist.parse_args(["--smoke"]))
    launches = {n: twins["launches"][n] + flash.launches[n]
                for n in flash.launches}
    hvd.shutdown()
    steps = res["step_losses"]
    print(f"[convnets] MNIST twin smoke epoch: {res['epochs']} "
          f"({res['steps_per_epoch']} steps of {res['global_batch']}); step "
          f"losses {['%.4f' % v for v in steps]}")
    require(all(math.isfinite(v) for v in steps) and steps[-1] < steps[0],
            "MNIST twin: the loss did not fall over its smoke epoch")
    print(f"[convnets] flash kernel launches on this path: {launches} (it "
          "has none); BatchNorm kernel launches in the twins' runs: "
          f"{twins['batch_norm_launches']} (convolutions and pooling are "
          "cuDNN and torch ops)")
    return twins["runs"]


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: no CUDA device is visible")
    import horovod_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    children = {CONVNET_TWINS_FLAG: convnet_twins,
                LONG_CONTEXT_FLAG: long_context,
                BATCH_NORM_FLAG: phase_batch_norm,
                MLA_KERNELS_FLAG: phase_mla_kernels}
    if len(argv) == 1 and argv[0] in children:  # a child of run_child
        print(json.dumps(children[argv[0]](dev)))
        return 0
    workers = {TRAINER_WORKER_FLAG: trainer_worker,
               ELASTIC_WORKER_FLAG: elastic_worker}
    if argv and argv[0] in workers:  # a worker of [launch] or [elastic]
        workers[argv[0]](*argv[1:])
        return 0
    card = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    start = time.perf_counter()

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"[timing] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("build", phase_build)
    edges = timed("tile edges", phase_tile_edges, dev)
    rows = timed("kernels", phase_kernels, dev)
    mla = timed("mla kernels", phase_mla_kernels, dev)
    batch_norm = timed("batch norm", phase_batch_norm, dev)
    timed("reference", phase_reference, dev)
    launches, k2_launches, trainer = timed("trainer", phase_trainer, dev)
    ada, ada_launches = timed("adasum", phase_adasum, dev)
    neg, neg_launches = timed("negotiation", phase_negotiation, dev)
    fusion, fusion_launches = timed("fusion", phase_fusion, dev)
    cached, cached_launches = timed("cached step", phase_cached_step, dev)
    ckpt = timed("checkpoint", phase_checkpoint, dev)
    launch, launch_launches = timed("launch", phase_launch, dev)
    elastic, elastic_launches = timed("elastic", phase_elastic, dev)
    autoscale, autoscale_launches = timed("autoscale", phase_autoscale, dev,
                                          elastic)
    ray, ray_launches = timed("ray", phase_ray, dev, launch, elastic)
    spark, spark_launches = timed("spark", phase_spark, dev, launch)
    moe, moe_launches = timed("moe", phase_moe, dev)
    pipeline = timed("pipeline", phase_pipeline, dev)
    long_ctx = timed("long context", phase_long_context)
    patterns = timed("ring patterns", phase_ring_patterns, dev)
    convnets = timed("convnets", phase_convnets, dev)
    print(f"[timing] all phases: {time.perf_counter() - start:.1f} s")
    for row in rows:
        name = row["name"]
        row["launches"] = launches[name]
        row["launches_k2_sparse"] = k2_launches[name]
        row["launches_moe"] = moe_launches[name]
        row["launches_adasum"] = ada_launches[name]
        row["launches_negotiation"] = neg_launches[name]
        row["launches_fusion"] = fusion_launches[name]
        row["launches_cached_step"] = cached_launches[name]
        row["launches_launch"] = launch_launches[name]
        row["launches_elastic"] = elastic_launches[name]
        row["launches_autoscale"] = autoscale_launches[name]
        row["launches_ray"] = ray_launches[name]
        row["launches_spark"] = spark_launches[name]
        row["launches_long_context"] = {
            mode: res["launches_per_step"][-1][name]
            for mode, res in long_ctx.items()}
        row["tile_edge_errors"] = edges[name]  # worst readings
        row["ring_pattern_errors"] = patterns["errors"][name]
        row["fully_past_block"] = patterns["fully_past_block"][name]
    print(json.dumps({"long_context": {mode: {key: res[key] for key in (
        "step_ms", "tokens_per_s", "peak_memory_gib", "losses", "step_s",
        "launches_per_step", "blocks", "logits_vs_ring", "profile")
        if key in res}
        for mode, res in long_ctx.items()}}))
    print(json.dumps({"convnets": {k: {key: v[key] for key in (
        "img_sec", "step_ms", "peak_memory_gib", "losses", "profile",
        "busy_share", "sync_ms", "sgd_ms")
        if key in v} for k, v in convnets.items()}}))
    print(json.dumps({"trainer": trainer}))
    print(json.dumps({"moe": moe, "pipeline": pipeline}))
    print(json.dumps({"adasum": ada}))
    print(json.dumps({"negotiation": neg}))
    print(json.dumps({"fusion": fusion}))
    print(json.dumps({"cached_step": cached, "checkpoint": ckpt}))
    print(json.dumps({"launch": launch, "elastic": elastic}))
    print(json.dumps({"autoscale": autoscale, "ray": ray, "spark": spark}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"mla_kernels": mla}))
    print(json.dumps(batch_norm))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
