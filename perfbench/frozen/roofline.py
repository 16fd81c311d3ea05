"""Published peaks of one NVIDIA H100 SXM and the flash kernels' bound
arithmetic.

Copied at commit 3ba40e6 from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``PEAK_FLOPS``, ``bound``, ``_work``). ``unmasked_pairs`` there called the
program's ``flash.live_keys``; here it is the same count in closed form,
so that the yardstick imports nothing of the program.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": 67e12}  # dense, no sparsity


def unmasked_pairs(sq: int, sk: int, qpos0: int, kpos0: int,
                   causal: bool) -> int:
    """(query, key) pairs that take part: the work this data needs. Query
    i sits at ``qpos0 + i``, key j at ``kpos0 + j``; a causal query sees
    the keys at or before its own position."""
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        total += min(max(qpos0 + i - kpos0 + 1, 0), sk)
    return total


def bound_ms(flops: float, nbytes: float, dtype: str = "bfloat16"
             ) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth, in ms, and
    which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def flash_work(bh: int, sq: int, sk: int, d: int, pairs: int,
               itemsize: int) -> dict:
    """(flops, bytes) of each flash kernel on one block: each input read
    and each output written once, ``pairs`` live (query, key) pairs. The
    forward reads and writes float32 carries (m, l, acc); the backward
    reads dout, lse and D in float32 and writes float32 gradients."""
    qkv = bh * (sq + 2 * sk) * d * itemsize
    carry = bh * sq * (d + 2) * 4
    grad_in = qkv + bh * sq * (d + 2) * 4
    return {"flash_fwd": (4 * d * pairs, qkv + 2 * carry),
            "flash_bwd_dq": (6 * d * pairs, grad_in + bh * sq * d * 4),
            "flash_bwd_dkv": (8 * d * pairs, grad_in + 2 * bh * sk * d * 4)}
