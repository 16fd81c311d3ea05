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
7. long context, in a fresh process of its own: the long-context twin
   (``horovod_tpu_torch.examples.long_context_lm --model full``) at the full
   width of the repo's ``TransformerConfig`` defaults over 1 x 16384
   tokens, bf16 compute, NCCL world 1, for each of ``ring``,
   ``ring_zigzag`` and ``ulysses``: 2 warm-up and 3 timed steps each; the
   loss must be finite and fall, each kernel must be launched
   ``num_layers`` times a step (3 times that for the zigzag, which halves
   the block even at one rank) at the offsets the schedule gives, and the
   modes' first-step logits on the same weights must agree within
   ``LOGITS_AGREEMENT``; once all three are timed, one profiled step each;
8. ring patterns: K1, K2 and K3 at bh 8, d 64, bf16 against their plain
   versions (computed one bh slice at a time) under the kernels phase's
   per-row limits, at every block (sq, sk, qpos0, kpos0) the long-context
   phase launches (16384 x 16384 at (0, 0); 8192 x 8192 at (0, 0), (8192,
   0) and (8192, 8192)) and every live block that rank 3 of a contiguous
   causal ring of 4 over 16384 tokens and rank 0 of a zigzag ring of 4
   launch; each kernel timed on the fully-past 4096 x 4096 block, where
   every pair is live;
9. convnets: the data-parallel convnet path, which runs no kernel of the
   port (convolutions, pooling and BatchNorm are cuDNN and torch ops, as
   they are XLA's in the JAX package). First, in a fresh process of its
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
with the per-step count of buckets started during the backward pass), one
``{"kernels": [...]}`` JSON object, the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
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


def _block_inputs(g, dev, dtype, bh, sq, sk, d, qpos0, kpos0, causal):
    """Seeded (q, k, v) with q pre-scaled, the forward's lse and out, and a
    random float32 dout with D = rowsum(dout * out)."""
    from horovod_tpu_torch.ops import flash
    q = (torch.randn((bh, sq, d), generator=g, device=dev)
         / math.sqrt(d)).to(dtype)
    k = torch.randn((bh, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((bh, sk, d), generator=g, device=dev).to(dtype)
    carries = (torch.full((bh, sq, 1), flash.NEG_INF, device=dev),
               torch.zeros((bh, sq, 1), device=dev),
               torch.zeros((bh, sq, d), device=dev))
    m, l, acc = by_slice(flash.attend_plain, q, k, v, qpos0, kpos0, causal,
                         *carries)
    l_safe = l.clamp_min(1e-30)
    lse = m + torch.log(l_safe)
    dout = torch.randn((bh, sq, d), generator=g, device=dev)
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
    where = f"kernels bh={bh} s={s} d={d} bf16 causal"
    failed = [f for n, e in errs.items() for f in _failures(n, e, where)]
    require(not failed, f"kernels disagree with their plain versions: "
            f"{failed}")

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


def _profile_step(step, overlap: bool = False) -> dict:
    """One more training step under ``torch.profiler``: device time by
    kernel, by kind of work (``PROFILE_KINDS``), and the device's busy
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
    kinds: dict = {}
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, words in PROFILE_KINDS
                     if any(w in name for w in words)), "other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] by kind: {ms:8.3f} ms x{n:<5d} "
              f"({100 * ms / busy_ms:.1f} % of busy) {kind}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "overlap": found,
            "kinds": {k: ms for k, (ms, _) in kinds.items()}}


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
    from horovod_tpu_torch.ops import flash
    hvd.init()
    require(hvd.size() == 1 and hvd.device() == dev, "init(): not world 1")
    out, kept = {}, {}
    flash.reset_launch_counts()
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
    return {"runs": out, "launches": launches}


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
    print(f"[convnets] port kernel launches on this path: {launches} (it "
          "has none: convolutions, pooling and BatchNorm are cuDNN and "
          "torch ops)")
    return twins["runs"]


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: no CUDA device is visible")
    import horovod_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    children = {CONVNET_TWINS_FLAG: convnet_twins,
                LONG_CONTEXT_FLAG: long_context}
    if len(argv) == 1 and argv[0] in children:  # a child of run_child
        print(json.dumps(children[argv[0]](dev)))
        return 0
    card = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    edges = phase_tile_edges(dev)
    rows = phase_kernels(dev)
    phase_reference(dev)
    launches, k2_launches, trainer = phase_trainer(dev)
    long_ctx = phase_long_context()
    patterns = phase_ring_patterns(dev)
    convnets = phase_convnets(dev)
    for row in rows:
        name = row["name"]
        row["launches"] = launches[name]
        row["launches_k2_sparse"] = k2_launches[name]
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
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
