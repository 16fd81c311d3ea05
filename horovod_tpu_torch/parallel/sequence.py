"""Sequence-parallel attention over the flash kernels (port of
``horovod_tpu/parallel/sequence.py``).

A sequence group is a ``torch.distributed`` process group whose ranks each
hold one block of the sequence; ``group=None`` is this rank alone. Tensors
use the (batch, seq, heads, head_dim) layout of the models.

* **Ring attention** (:func:`ring_attention`): Q stays home while the K/V
  blocks rotate around the group, one ``batch_isend_irecv`` per step posted
  before the step's block update so that the rotation overlaps the kernel.
  Each step runs the forward kernel (``flash_fwd``) at the block's global
  offsets; a causal block that lies wholly in the future of the local
  queries is skipped (the rotation still runs, so the ring stays aligned).
  The backward (:class:`_RingCore`) re-rotates from the home blocks and
  carries float32 dK/dV accumulators around with them, one extra rotation
  taking each home; it saves only ``(qf, kf, vf, out, lse)``, so training
  memory stays O(block) as the ring grows. ``schedule="zigzag"`` hands rank
  r the chunks (r, 2n-1-r) of 2n (:func:`zigzag_shard`), which balances the
  causal work over the ranks: the same core over each block's two halves
  (:func:`zigzag_schedule`).
* **Ulysses** (:func:`ulysses_attention`): an all-to-all per tensor trades
  the sequence split for a head split (:func:`seq_to_heads`), exact local
  attention runs over the whole sequence on the local heads
  (:func:`_local_flash`), and the output is traded back.

Every block update and block gradient goes through ``ops/flash.py``: the
kernels for CUDA tensors, their plain versions for CPU tensors. The
collectives are ``torch.distributed``'s (NCCL on the card, gloo on the
host); a group of one rank moves nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import flash
from ..ops.flash import NEG_INF


def group_size(group) -> int:
    """The size of sequence group ``group``: 1 for None (this rank alone),
    else that of the ``torch.distributed`` group."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in sequence group ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


# --------------------------------------------------------------------------
# point-to-point exchanges
# --------------------------------------------------------------------------


def _wait(works) -> None:
    for w in works:
        w.wait()


def _route(sends, recvs, group) -> list:
    """One exchange of pieces between the ranks of ``group``, every send and
    receive posted in one ``batch_isend_irecv``. ``sends`` holds ``(tensor,
    dst, tag)`` and ``recvs`` ``(like, src, tag)``, ranks in the group, with
    ``like`` a tensor of the piece's shape and dtype. Between two ranks the
    pieces are posted in the order of their tags on both sides, which NCCL
    (it matches in posting order) and gloo (it matches by tag) both need. A
    piece this rank sends itself is taken as it is. Returns the received
    pieces in the order of ``recvs``."""
    me = group_rank(group)
    own = {tag: t for t, dst, tag in sends if dst == me}
    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      dist.get_global_rank(group, dst), group, tag)
           for t, dst, tag in sorted(sends, key=lambda s: s[2]) if dst != me]
    outs = {}
    for like, src, tag in sorted(recvs, key=lambda r: r[2]):
        if src == me:
            outs[tag] = own[tag]
        else:
            outs[tag] = torch.empty_like(
                like, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, outs[tag],
                                  dist.get_global_rank(group, src), group,
                                  tag))
    if ops:
        _wait(dist.batch_isend_irecv(ops))
    return [outs[tag] for _, _, tag in recvs]


def _ring_pass_start(tensors, group, first_tag: int = 0):
    """Start one rotation of the ring: each tensor goes to rank ``(r + 1) %
    n`` of the group and its counterpart comes from rank ``(r - 1) % n``,
    all in one ``batch_isend_irecv`` (at n = 2 both peers are one rank; the
    operations still pair, by tag and order). Returns ``(received,
    works)``: the received tensors are complete once every work has been
    waited on. A group of one rank has no peer, and its rotation is the
    identity: the JAX ring permutes a block to itself there."""
    n = group_size(group)
    if n == 1:
        return list(tensors), []
    me = group_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, outs), start=first_tag):
        ops += [dist.P2POp(dist.isend, t, nxt, group, tag),
                dist.P2POp(dist.irecv, o, prv, group, tag)]
    return outs, dist.batch_isend_irecv(ops)


# --------------------------------------------------------------------------
# schedules: which blocks a rank computes at which step
# --------------------------------------------------------------------------


def ring_schedule(rank: int, n: int, sq: int, sk: int, causal: bool) -> list:
    """The contiguous ring's blocks for ``rank`` of ``n``: for each step, the
    live ``(0, 0, qpos0, kpos0)`` (the format of :func:`zigzag_schedule`,
    one part a block), ``qpos0``/``kpos0`` the global offsets of the local
    queries and of the K/V block held then (block ``(rank - step) % n``);
    none where causal masking hides the whole block (it lies in the
    queries' future)."""
    steps = []
    for step in range(n):
        qpos0, kpos0 = rank * sq, ((rank - step) % n) * sk
        live = not (causal and kpos0 > qpos0 + sq - 1)
        steps.append([(0, 0, qpos0, kpos0)] if live else [])
    return steps


def zigzag_schedule(rank: int, n: int, c: int) -> list:
    """The zigzag ring's causal sub-blocks for ``rank`` of ``n`` with chunks
    of ``c`` tokens: for each step, the live ``(qi, ki, qpos0, kpos0)`` in
    the JAX loop's order, ``qi``/``ki`` the half (0 low, 1 high) of the
    local queries and of the K/V block held then (that of rank ``(rank -
    step) % n``). Rank r holds chunks r and 2n-1-r (``_zig_positions`` of
    the JAX package); a sub-block whose keys all lie in its queries' future
    is left out."""
    def chunk(r, half):
        return r if half == 0 else 2 * n - 1 - r

    steps = []
    for step in range(n):
        kv_rank = (rank - step) % n
        blocks = []
        for qi in range(2):
            for ki in range(2):
                qpos0 = chunk(rank, qi) * c
                kpos0 = chunk(kv_rank, ki) * c
                if not kpos0 > qpos0 + c - 1:
                    blocks.append((qi, ki, qpos0, kpos0))
        steps.append(blocks)
    return steps


# --------------------------------------------------------------------------
# Ulysses all-to-alls
# --------------------------------------------------------------------------


def _all_to_all(buf, group):
    """Chunk j of ``buf`` (its dim 0 is the group size) goes to rank j; the
    result holds in chunk j what rank j sent. ``all_to_all_single`` is the
    form both NCCL and gloo implement."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out


def _seq_to_heads(x, group):
    n = group_size(group)
    b, s, h, d = x.shape
    buf = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    out = _all_to_all(buf, group)  # out[j]: rank j's block, my heads
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x, group):
    n = group_size(group)
    b, seq, hl, d = x.shape
    s = seq // n
    buf = x.reshape(b, n, s, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    out = _all_to_all(buf, group)  # out[j]: my block, rank j's heads
    return out.permute(1, 2, 0, 3, 4).reshape(b, s, n * hl, d)


class _Exchange(torch.autograd.Function):
    """A movement of data between the ranks of ``group``, ``move(x,
    group)``, whose gradient is the inverse movement ``inverse(g, group)``
    (the all-to-alls, the zigzag layout)."""

    @staticmethod
    def forward(ctx, x, group, move, inverse):
        ctx.group, ctx.inverse = group, inverse
        return move(x, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.inverse(g, ctx.group), None, None, None


def seq_to_heads(x, group=None):
    """All-to-all reshard (batch, seq/n, heads, d) -> (batch, seq, heads/n,
    d), as ``lax.all_to_all(split_axis=2, concat_axis=1, tiled=True)``: head
    chunk j goes to rank j, and the chunks received are concatenated along
    the sequence in rank order. The identity for a group of one rank."""
    n = group_size(group)
    if x.shape[2] % n:
        raise ValueError(
            f"num_heads {x.shape[2]} must divide by the sequence-parallel "
            f"axis size {n} for the Ulysses all-to-all")
    return x if n == 1 else _Exchange.apply(x, group, _seq_to_heads,
                                            _heads_to_seq)


def heads_to_seq(x, group=None):
    """Inverse of :func:`seq_to_heads`: (batch, seq, heads/n, d) ->
    (batch, seq/n, heads, d)."""
    n = group_size(group)
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} must divide by the "
                         f"sequence-parallel axis size {n}")
    return x if n == 1 else _Exchange.apply(x, group, _heads_to_seq,
                                            _seq_to_heads)


# --------------------------------------------------------------------------
# cores: autograd Functions over the kernels
# --------------------------------------------------------------------------


def _carries(shape, device):
    """Fresh ``(m, l, acc)`` float32 carries for ``shape`` = (..., s, d)."""
    rows = (*shape[:-1], 1)
    return [torch.full(rows, NEG_INF, dtype=torch.float32, device=device),
            torch.zeros(rows, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device)]


def _normalize(m, l, acc):
    """``(out, lse)`` from the carries; a row that saw no key keeps 0."""
    l_safe = torch.clamp_min(l, 1e-30)
    return acc / l_safe, m + torch.log(l_safe)


class _RingCore(torch.autograd.Function):
    """Blockwise attention around the ring of ``group`` (twin of the JAX
    ``_ring_core`` and ``_zigzag_core``): forward as ``_ring_fwd_loop``,
    backward as ``_ring_core_bwd``. Blocks are kept as H parts of (bh, c,
    d), half first (H = 1 for the contiguous ring and local attention, 2
    for the zigzag's halves), so that every sub-block the kernels take is
    contiguous; ``steps`` lists, for each ring step, the live ``(qi, ki,
    qpos0, kpos0)`` (:func:`ring_schedule`, :func:`zigzag_schedule`). K and
    V travel as one stacked buffer, dK and dV as one float32 buffer that the
    n-th rotation takes home. Saves only ``(qh, kh, vh, out, lse)``.
    Returns ``(out, lse)`` in float32, parts first; ``lse`` takes no
    gradient."""

    @staticmethod
    def forward(ctx, qh, kh, vh, group, causal: bool, steps):
        carries = [_carries(qh.shape[1:], qh.device)
                   for _ in range(qh.shape[0])]
        kv = torch.stack((kh, vh))  # (k|v, part, bh, c, d)
        for step, blocks in enumerate(steps):
            last = step == len(steps) - 1
            nxt, works = ([kv], []) if last else _ring_pass_start([kv], group)
            for qi, ki, qpos0, kpos0 in blocks:
                carries[qi] = flash.block_attend(
                    qh[qi], kv[0, ki], kv[1, ki], qpos0, kpos0, causal,
                    *carries[qi])
            _wait(works)
            kv = nxt[0]
        parts = [_normalize(*c) for c in carries]
        out = torch.stack([o for o, _ in parts])
        lse = torch.stack([s for _, s in parts])
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.group, ctx.causal, ctx.steps = group, causal, steps
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        qh, kh, vh, out, lse = ctx.saved_tensors
        group, steps = ctx.group, ctx.steps
        dout = dout.float().contiguous()
        D = (dout * out).sum(-1, keepdim=True)
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=qh.device)
        dkv = torch.zeros((2, *kh.shape), dtype=torch.float32,
                          device=kh.device)
        kv = torch.stack((kh, vh))
        for step, blocks in enumerate(steps):
            last = step == len(steps) - 1
            nxt, works = ([kv], []) if last else _ring_pass_start([kv], group)
            for qi, ki, qpos0, kpos0 in blocks:
                dq_b, dk_b, dv_b = flash.flash_block_grads(
                    qh[qi], kv[0, ki], kv[1, ki], lse[qi], dout[qi], D[qi],
                    qpos0, kpos0, ctx.causal)
                dq[qi] += dq_b
                dkv[0, ki] += dk_b
                dkv[1, ki] += dv_b
            # dK/dV travel with their block; the n-th rotation takes each
            # accumulator home
            (dkv,), dkv_works = _ring_pass_start([dkv], group, first_tag=1)
            _wait(works + dkv_works)
            kv = nxt[0]
        return (dq.to(qh.dtype), dkv[0].to(kh.dtype), dkv[1].to(vh.dtype),
                None, None, None)


# --------------------------------------------------------------------------
# zigzag layout
# --------------------------------------------------------------------------


def _zig_owner(chunk: int, n: int) -> int:
    """Which rank holds global chunk ``chunk`` of 2n in the zigzag layout."""
    return chunk if chunk < n else 2 * n - 1 - chunk


def _zigzag_shard(x, group):
    n, r = group_size(group), group_rank(group)
    c = x.shape[1] // 2
    hi = 2 * n - 1 - r
    # rank r holds the contiguous chunks (2r, 2r+1); each goes to its owner,
    # tagged by the parity of its chunk id
    low, high = _route(
        [(x[:, :c], _zig_owner(2 * r, n), 0),
         (x[:, c:], _zig_owner(2 * r + 1, n), 1)],
        [(x[:, :c], r // 2, r % 2), (x[:, c:], hi // 2, hi % 2)], group)
    return torch.cat([low, high], dim=1)


def _zigzag_unshard(x, group):
    n, r = group_size(group), group_rank(group)
    c = x.shape[1] // 2
    hi = 2 * n - 1 - r
    first, second = _route(
        [(x[:, :c], r // 2, r % 2), (x[:, c:], hi // 2, hi % 2)],
        [(x[:, :c], _zig_owner(2 * r, n), 0),
         (x[:, c:], _zig_owner(2 * r + 1, n), 1)], group)
    return torch.cat([first, second], dim=1)


def zigzag_shard(x, group=None):
    """Convert a contiguous sequence block (dim 1) to the zigzag layout:
    rank r's halves become global chunks (r, 2n-1-r). Differentiable (its
    gradient is :func:`zigzag_unshard`); the identity for one rank."""
    if group_size(group) == 1:
        return x
    return _Exchange.apply(x, group, _zigzag_shard, _zigzag_unshard)


def zigzag_unshard(x, group=None):
    """Inverse of :func:`zigzag_shard`."""
    if group_size(group) == 1:
        return x
    return _Exchange.apply(x, group, _zigzag_unshard, _zigzag_shard)


# --------------------------------------------------------------------------
# public attention functions
# --------------------------------------------------------------------------


def _rows(x):
    """(b, s, h, d) -> contiguous (b*h, s, d), as the kernels take."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).contiguous().view(b * h, s, d)


def ring_attention(q, k, v, group=None, causal: bool = True,
                   schedule: str = "contiguous"):
    """Blockwise ring attention over the sequence group ``group``: ``q``,
    ``k``, ``v`` are this rank's (batch, seq_block, heads, head_dim) blocks,
    rank r holding block r of the sequence. Returns this rank's output
    block, shape and dtype of ``q``/``v``. ``schedule="zigzag"`` (causal,
    equal and even block lengths) balances the causal work: the blocks move
    to the zigzag layout and back around the core."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if schedule == "zigzag":
        if not causal:
            raise ValueError("schedule='zigzag' is a causal load-balance; "
                             "use the contiguous schedule for non-causal")
        if sq != sk or sq % 2:
            raise ValueError(
                f"zigzag needs equal, even per-chip q/kv block lengths; "
                f"got sq={sq}, sk={sk}")
    elif schedule != "contiguous":
        raise ValueError(f"unknown ring schedule {schedule!r}; valid: "
                         "'contiguous', 'zigzag'")
    n, me = group_size(group), group_rank(group)
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = _rows(q * scale), _rows(k), _rows(v)
    if schedule == "zigzag":
        c = sq // 2

        def halves(x):  # zigzag block (bh, s, d) -> (2, bh, c, d)
            x = zigzag_shard(x, group)
            return torch.stack((x[:, :c], x[:, c:]))

        out, _lse = _RingCore.apply(halves(qf), halves(kf), halves(vf),
                                    group, True, zigzag_schedule(me, n, c))
        out = zigzag_unshard(torch.cat((out[0], out[1]), dim=1), group)
    else:
        causal = bool(causal)
        out, _lse = _RingCore.apply(qf[None], kf[None], vf[None], group,
                                    causal, ring_schedule(me, n, sq, sk,
                                                          causal))
    return out.reshape(b, h, sq, d).transpose(1, 2).to(v.dtype)


def _local_flash(q, k, v, causal: bool):
    """Exact local attention in flash form: (b, s, h, d) in and out, q
    scaled by 1/sqrt(d); the logits are never materialized at O(s^2). It is
    a ring of this rank alone: one block at offsets (0, 0), whose backward
    saves only ``(qf, kf, vf, out, lse)`` (twin of the JAX
    ``_local_flash_core``)."""
    b, s, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    out, _lse = _RingCore.apply(_rows(q * scale)[None], _rows(k)[None],
                                _rows(v)[None], None, bool(causal),
                                [[(0, 0, 0, 0)]])
    return out.reshape(b, h, s, d).transpose(1, 2).to(v.dtype)


def ulysses_attention(q, k, v, group=None, causal: bool = True):
    """Ulysses sequence parallelism: reshard to head-parallel, run exact
    full-sequence attention on the local heads through the flash kernels,
    reshard back. ``group`` is the sequence group (None: this rank
    alone)."""
    q = seq_to_heads(q, group)
    k = seq_to_heads(k, group)
    v = seq_to_heads(v, group)
    return heads_to_seq(_local_flash(q, k, v, causal), group)
