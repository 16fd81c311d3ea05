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
   ``DistributedOptimizer(Adam)``, for 5 steps on 8 x 2048 tokens; the loss
   must be finite and fall, and every kernel must have been launched
   ``num_layers x steps`` times. One more step then runs under
   ``torch.profiler``, which prints its device time by kernel.

The last lines are one ``{"kernels": [...]}`` JSON object, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import math
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
    m, l, acc = flash.attend_plain(q, k, v, qpos0, kpos0, causal, *carries)
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


def _failures(name, errs, where, skip=()) -> list:
    """Print one kernel's errors beside their limits in ``TRAINING_LIMITS``
    (but those in ``skip``) and return the keys that exceed them."""
    lim = {k: x for k, x in TRAINING_LIMITS[name].items() if k not in skip}
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
    loss.backward()
    opt.step()
    return loss.item()


def _profile_step(step) -> None:
    """One more training step under ``torch.profiler``: device time by
    kernel, and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    _profile_step(lambda: _train_step(model, opt, tokens))
    hvd.shutdown()
    steady = sum(step_s[1:]) / (STEPS - 1)
    print(f"[trainer] TransformerLM {n_params / 1e6:.1f} M params, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads, vocab {cfg.vocab_size}, bf16, ulysses; batch {BATCH} x "
          f"{SEQ} tokens; NCCL world 1")
    print(f"[trainer] losses {['%.4f' % x for x in losses]}")
    print(f"[trainer] step time {steady * 1e3:.1f} ms (mean of steps 2-"
          f"{STEPS}; step 1 {step_s[0] * 1e3:.1f} ms), "
          f"{BATCH * SEQ / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"[trainer] kernel launches {launches}")
    require(all(math.isfinite(x) for x in losses), "loss is not finite")
    require(losses[-1] < losses[0], "loss did not fall")
    want = cfg.num_layers * STEPS
    require(all(v == want for v in launches.values()),
            f"launch counts {launches}, want {want} each")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: no CUDA device is visible")
    import horovod_tpu_torch  # noqa: F401  (fails outside the repository)

    card = nvidia_smi()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    edges = phase_tile_edges(dev)
    rows = phase_kernels(dev)
    phase_reference(dev)
    launches = phase_trainer(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["name"] in edges:  # the tile-edge phase's worst readings
            row["tile_edge_errors"] = edges[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
