#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the repository root, on a host with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the three flash-attention kernels from ``horovod_tpu_torch/csrc``
   for ``sm_90a``, one ``nvcc`` per source in parallel, with each kernel's
   registers, shared memory and spills as ``-Xptxas -v`` reports them;
3. kernels: each kernel against its plain PyTorch version at the training
   shape (bh 64, s 2048, d 64, bf16, causal) and at an awkward one (sq 13,
   sk 11, q offset 3, d 64, float32, causal and not), timed with CUDA events
   beside its plain version, ``scaled_dot_product_attention`` (the
   library's yardstick; the port never calls it) and its roofline bound;
4. reference: the model's flash path against its plain attention path on a
   small float32 input;
5. trainer: data-parallel TransformerLM training at the full width of the
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

import json
import math
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
    if not causal:
        return sq * sk
    rows = qpos0 + np.arange(sq) - kpos0 + 1
    return int(np.clip(rows, 0, sk).sum())


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def phase_build():
    from horovod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.KERNEL_SOURCES)} kernels for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in _build.KERNEL_SOURCES:
        for line in _build.build_logs.get(name, "(cached)").splitlines():
            if ("entry function" in line or "Used" in line
                    or "spill" in line or "cached" in line):
                print(f"[build] {name}: {line.strip()}")
        smem = getattr(_build.load(name), f"hvd_{name}_smem_bytes")
        print(f"[build] {name}: dynamic shared memory per block "
              f"{smem(64)} B at d=64, {smem(128)} B at d=128 (256 threads)")


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


def _row_rel_err(got, want) -> float:
    """Largest error of one row (a query's or a key's d-vector) relative to
    that row's norm in the plain result, so that a tile of the grid whose
    values are small cannot be wrong unseen."""
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    return (diff / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
            ).max().item()


def _fwd_errs(got, want) -> dict:
    """Errors of the values the model consumes: the normalized output
    acc / l (max abs and per row relative) and lse = m + log l (max abs)."""
    (m1, l1, a1), (m2, l2, a2) = got, want
    o1, o2 = a1 / l1.clamp_min(1e-30), a2 / l2.clamp_min(1e-30)
    lse1 = m1 + torch.log(l1.clamp_min(1e-30))
    lse2 = m2 + torch.log(l2.clamp_min(1e-30))
    return {"out_abs": (o1 - o2).abs().max().item(),
            "out_row_rel": _row_rel_err(o1, o2),
            "lse_abs": (lse1 - lse2).abs().max().item()}


def _grad_errs(got, want) -> dict:
    return {"abs": max((x - y).abs().max().item()
                       for x, y in zip(got, want)),
            "row_rel": max(_row_rel_err(x, y) for x, y in zip(got, want))}


def _max_err(got, want):
    return max((x - y).abs().max().item() for x, y in zip(got, want))


# Limits at the training shape (bh 64, s 2048, d 64, bf16, causal), each set
# from the error an H100 run of the kernels showed (chip_smoke.py, H100 80GB
# HBM3 at 700 W): K1 rounds p to bf16 against its running row max and the
# plain version against the block's max, so the two differ by bf16 rounding
# of p; K2 and K3 round ds at the same point as their plain versions and
# came out bitwise equal. The row limits are relative to each query's or
# key's own row, so a kernel wrong on any tile fails however small that
# tile's values are.
TRAINING_LIMITS = {
    "flash_fwd": {"out_abs": 5e-3,       # measured 1.57e-3
                  "out_row_rel": 1e-2,   # measured 3.45e-3
                  "lse_abs": 1e-4},      # measured 9.5e-7
    "flash_bwd_dq": {"row_rel": 1e-3},   # measured 0 (bitwise)
    "flash_bwd_dkv": {"row_rel": 1e-3},  # measured 0 (bitwise)
}


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
    errs["flash_bwd_dq"] = _grad_errs([flash._launch_bwd_dq(*args)],
                                      [flash.plain_bwd_dq(*args)])
    errs["flash_bwd_dkv"] = _grad_errs(flash._launch_bwd_dkv(*args),
                                       flash.plain_bwd_dkv(*args))
    torch.cuda.synchronize()
    failed = []
    for n, e in errs.items():
        lim = TRAINING_LIMITS[n]
        print(f"[kernels] {n} bh={bh} s={s} d={d} bf16 causal: " + ", ".join(
            f"{key} {e[key]:.4g}" + (f" (limit {lim[key]:g})" if key in lim
                                     else "") for key in e))
        failed += [f"{n} {key}" for key in lim if not e[key] <= lim[key]]
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
            "errors": errs[n], "limits": TRAINING_LIMITS[n],
            "awkward_max_abs_err": awkward_err[
                "fwd" if n == "flash_fwd" else "bwd"],
            "awkward_tolerance": awkward_tol,
            "ms": ms[n][0], "plain_ms": ms[n][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "library_ms": lib_ms, "library_call": lib_call,
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
    rows = phase_kernels(dev)
    phase_reference(dev)
    launches = phase_trainer(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
