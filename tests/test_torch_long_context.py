"""The port's long-context path without JAX: the ring and zigzag schedules,
the sequence-parallel functions at a group of one rank, and the
long-context twin (``horovod_tpu_torch.examples.long_context_lm``) at world
1 and in a spawned gloo world of two.

It also holds the rank side of ``test_torch_sequence_parallel.py``, whose
reference side needs JAX: :func:`_sequence_rank` runs in every rank of a
gloo world of 2 or 4 (:func:`test_torch_world2.run_world`) and saves what
the ranks computed on the same seeded numpy inputs (:func:`sp_inputs`).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.parallel import sequence
from horovod_tpu_torch.parallel.sequence import (heads_to_seq,
                                                 ring_attention, ring_schedule,
                                                 seq_to_heads,
                                                 ulysses_attention,
                                                 zigzag_schedule,
                                                 zigzag_shard, zigzag_unshard)
from test_torch_world2 import spawn_world

# Attention inputs: (batch, seq, heads, head_dim), BLOCK tokens a rank.
SP_B, SP_H, SP_D, BLOCK = 2, 8, 4, 4
# The model of the sequence-parallel parity: 2 layers, d_model 32, 8 heads
# of 4, float32; positions up to 4 ranks x BLOCK tokens.
SP_MODEL = dict(vocab_size=64, num_layers=2, num_heads=8, d_model=32,
                d_ff=64, max_seq_len=4 * BLOCK)
SP_MODES = ("ring", "ring_zigzag", "ulysses")
# (name, function, keywords) of the attention cases, the same on both sides.
ATTENTION_CASES = (
    ("ring_causal", "ring", dict(causal=True)),
    ("ring_full", "ring", dict(causal=False)),
    ("zigzag", "ring", dict(causal=True, schedule="zigzag")),
    ("ulysses_causal", "ulysses", dict(causal=True)),
    ("ulysses_full", "ulysses", dict(causal=False)),
)
ZIGZAG_CHUNK = 3


def sp_inputs(n: int) -> dict:
    """Seeded float32 q, k, v and a target of the output, over the whole
    sequence of n blocks; the tokens of the model's parity."""
    rng = np.random.default_rng(11 + n)
    shape = (SP_B, BLOCK * n, SP_H, SP_D)
    out = {name: rng.standard_normal(shape).astype(np.float32)
           for name in ("q", "k", "v", "tgt")}
    out["tokens"] = rng.integers(0, SP_MODEL["vocab_size"],
                                 (2, BLOCK * n)).astype(np.int64)
    return out


def layout_input(n: int) -> np.ndarray:
    """A (batch, seq, heads, d) array whose every entry is its own index."""
    shape = (SP_B, BLOCK * n, SP_H, SP_D)
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


def _block(x, rank, block=BLOCK):
    return x[:, rank * block:(rank + 1) * block]


def _attention_case(fn, inp, rank, group, kw, device="cpu",
                    block=BLOCK) -> dict:
    """This rank's output block and its q, k, v gradients of the loss
    sum((out - tgt)^2) over the whole sequence."""
    mine = {x: torch.from_numpy(_block(inp[x], rank, block).copy()).to(device)
            for x in ("q", "k", "v", "tgt")}
    q, k, v = (mine[x].requires_grad_() for x in "qkv")
    out = fn(q, k, v, group, **kw)
    ((out - mine["tgt"]) ** 2).sum().backward()
    return {"out": out.detach().cpu().numpy(), "dq": q.grad.cpu().numpy(),
            "dk": k.grad.cpu().numpy(), "dv": v.grad.cpu().numpy()}


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _saved_bytes(fn) -> int:
    """Bytes of every tensor autograd saves while ``fn`` runs."""
    total = []

    def pack(t):
        total.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(total)


def _ring_core_node(out):
    """The ``_RingCore`` node of the graph that made ``out``."""
    todo, seen = [out.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if "_RingCore" in type(node).__name__:
            return node
        todo += [nxt for nxt, _ in node.next_functions]
    raise AssertionError("no _RingCore node in the graph")


def _sequence_rank(out_path: str) -> None:
    """One rank of the sequence-parallel parity: the attention cases, the
    layout functions, the errors, the ring's saved tensors and the model in
    each mode (weights and tokens from ``model.npz`` beside ``out_path``)."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)

    hvd.init(device="cpu")
    try:
        n, rank, group = hvd.size(), hvd.rank(), dist.group.WORLD
        inp, out = sp_inputs(n), {}
        fns = {"ring": ring_attention, "ulysses": ulysses_attention}
        for name, fn, kw in ATTENTION_CASES:
            res = _attention_case(fns[fn], inp, rank, group, kw)
            out.update({f"{name}_{k}": v for k, v in res.items()})
        x = torch.from_numpy(_block(layout_input(n), rank).copy())
        out["s2h"] = seq_to_heads(x, group).numpy()
        out["s2h_back"] = heads_to_seq(seq_to_heads(x, group), group).numpy()
        out.update(_zigzag_layout(n, rank, group))
        odd = torch.zeros((1, BLOCK, 3, SP_D))
        out["err_heads"] = np.asarray(_error(lambda: seq_to_heads(odd,
                                                                  group)))
        # the ring's residuals: the five tensors _RingCore saves, and every
        # byte autograd saves through ring_attention
        q, k, v = (torch.from_numpy(_block(inp[x], rank).copy())
                   .requires_grad_() for x in "qkv")
        ring_out = ring_attention(q, k, v, group)
        saved = _ring_core_node(ring_out).saved_tensors
        out["ring_saved_shapes"] = np.asarray([t.shape for t in saved])
        out["ring_saved_bytes"] = np.asarray(_saved_bytes(
            lambda: ring_attention(q, k, v, group)))
        model_npz = np.load(Path(out_path).parent / "model.npz")
        tokens = torch.from_numpy(_block(inp["tokens"], rank).copy())
        for mode in SP_MODES:
            model = TransformerLM(TransformerConfig(
                dtype=torch.float32, attn_mode=mode, **SP_MODEL),
                device="cpu", seq_group=group)
            model.load_state_dict({k: torch.from_numpy(model_npz[k])
                                   for k in model.state_dict()})
            logits = model(tokens)
            lm_loss(logits, tokens).backward()
            out[f"{mode}_logits"] = logits.detach().numpy()
            out.update({f"{mode}_grad_{k}": p.grad.numpy()
                        for k, p in model.named_parameters()})
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


def _ring_rank(out_path: str) -> None:
    """One rank of a world of odd size (3: no head count of the models
    divides by it): the ring cases and the zigzag layout, where two pieces
    go between one pair of ranks in one direction."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        n, rank, group = hvd.size(), hvd.rank(), dist.group.WORLD
        inp, out = sp_inputs(n), {}
        for name, fn, kw in ATTENTION_CASES:
            if fn == "ring":
                res = _attention_case(ring_attention, inp, rank, group, kw)
                out.update({f"{name}_{k}": v for k, v in res.items()})
        out.update(_zigzag_layout(n, rank, group))
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


def _zigzag_layout(n, rank, group) -> dict:
    """This rank's block of 0, 1, ..., 2n * ZIGZAG_CHUNK - 1 in the zigzag
    layout, and back."""
    seq = np.arange(2 * n * ZIGZAG_CHUNK, dtype=np.float32).reshape(1, -1, 1)
    block = 2 * ZIGZAG_CHUNK
    mine = torch.from_numpy(seq[:, rank * block:(rank + 1) * block].copy())
    zz = zigzag_shard(mine, group)
    return {"zz": zz.numpy(), "zz_back": zigzag_unshard(zz, group).numpy()}


# The same cases on four cards (an NCCL world, one card a rank): float32 at
# the kernels' head dim 64, CARD_BLOCK tokens a rank.
CARD_BLOCK, CARD_H, CARD_D = 256, 8, 64


def card_inputs(n: int) -> dict:
    rng = np.random.default_rng(17 + n)
    shape = (1, CARD_BLOCK * n, CARD_H, CARD_D)
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name in ("q", "k", "v", "tgt")}


def _sequence_rank_on_card(out_path: str) -> None:
    """One rank of the attention cases on the card: outputs, gradients and
    this rank's kernel launches in each case."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash

    hvd.init()
    try:
        n, rank, group = hvd.size(), hvd.rank(), dist.group.WORLD
        inp, out = card_inputs(n), {}
        fns = {"ring": ring_attention, "ulysses": ulysses_attention}
        for name, fn, kw in ATTENTION_CASES:
            before = dict(flash.launches)
            res = _attention_case(fns[fn], inp, rank, group, kw,
                                  hvd.device(), CARD_BLOCK)
            out.update({f"{name}_{k}": v for k, v in res.items()})
            out[f"{name}_launches"] = np.asarray(
                [flash.launches[k] - before[k] for k in before])
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_contiguous_causal_ring_launches_rank_plus_one_blocks(n):
    """Rank r of a causal contiguous ring computes blocks r, r-1, ..., 0
    (steps 0..r) and skips the rest; without causal masking, every block."""
    s = 16
    for r in range(n):
        steps = ring_schedule(r, n, s, s, True)
        assert [len(b) for b in steps] == [int(i <= r) for i in range(n)]
        assert [b for step in steps for b in step] == [
            (0, 0, r * s, (r - i) * s) for i in range(r + 1)]
        assert all(len(b) == 1 for b in ring_schedule(r, n, s, s, False))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_zigzag_schedule_gives_every_rank_the_same_work(n):
    """Every rank of a zigzag ring computes 2n + 1 sub-blocks: its low chunk
    r sees chunks 0..r, its high chunk 2n-1-r sees chunks 0..2n-1-r, and
    each (q chunk, kv chunk) pair of the causal triangle is computed once
    over the ranks."""
    c = 5
    pairs = []
    for r in range(n):
        blocks = [b for step in zigzag_schedule(r, n, c) for b in step]
        assert len(blocks) == 2 * n + 1
        pairs += [(qp // c, kp // c) for _, _, qp, kp in blocks]
    assert sorted(pairs) == sorted((i, j) for i in range(2 * n)
                                   for j in range(i + 1))


def test_zigzag_at_one_rank_launches_three_sub_blocks():
    """At n = 1 the zigzag still halves the block: the diagonal halves and
    the fully-past (high q, low kv) one, at offsets (0, 0), (c, 0), (c, c)."""
    assert zigzag_schedule(0, 1, 8) == [[(0, 0, 0, 0), (1, 0, 8, 0),
                                         (1, 1, 8, 8)]]


# --------------------------------------------------------------------------
# a group of one rank
# --------------------------------------------------------------------------


def _qkv(seed=0, s=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((SP_B, s, SP_H, SP_D), generator=g, dtype=dtype)
            .requires_grad_() for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_one_rank_ring_is_local_flash_bitwise(causal):
    """A ring of one rank runs one block at offsets (0, 0): the same calls
    as the local flash path, so output and gradients agree bitwise."""
    q, k, v = _qkv()
    out = ring_attention(q, k, v, None, causal=causal)
    out.square().sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = sequence._local_flash(q2, k2, v2, causal)
    ref.square().sum().backward()
    assert torch.equal(out, ref)
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a.grad, b.grad)


def test_one_rank_zigzag_matches_the_contiguous_ring():
    """At one rank the zigzag splits the block in halves and sums the
    diagonal and past halves in another order: float32, rtol 1e-5, atol
    1e-6 for the output and the gradients."""
    q, k, v = _qkv(1)
    out = ring_attention(q, k, v, schedule="zigzag")
    out.square().sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = ring_attention(q2, k2, v2)
    ref.square().sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    for a, b in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_one_rank_layout_functions_are_the_identity():
    x = torch.randn(2, 6, 4, 3)
    for fn in (seq_to_heads, heads_to_seq, zigzag_shard, zigzag_unshard):
        assert fn(x) is x


@pytest.mark.parametrize("kw,match", [
    (dict(causal=False, schedule="zigzag"), "causal load-balance"),
    (dict(schedule="zagzig"), "unknown ring schedule 'zagzig'"),
])
def test_ring_rejects_bad_schedules(kw, match):
    q, k, v = _qkv()
    with pytest.raises(ValueError, match=match):
        ring_attention(q, k, v, **kw)


@pytest.mark.parametrize("sq,sk", [(7, 7), (8, 6)])
def test_zigzag_rejects_odd_or_unequal_blocks(sq, sk):
    q, _, _ = _qkv(s=sq)
    k, v, _ = _qkv(s=sk)
    with pytest.raises(ValueError, match=f"sq={sq}, sk={sk}"):
        ring_attention(q, k, v, schedule="zigzag")


def test_cpu_ring_launches_no_kernel():
    """On CPU tensors every block runs the plain versions: the launch
    counters stay 0 through a zigzag forward and backward."""
    from horovod_tpu_torch.ops import flash
    flash.reset_launch_counts()
    q, k, v = _qkv()
    ring_attention(q, k, v, schedule="zigzag").sum().backward()
    assert set(flash.launches.values()) == {0}


# --------------------------------------------------------------------------
# the long-context twin
# --------------------------------------------------------------------------


def twin(size: int, argv: list) -> list:
    """``python -m horovod_tpu_torch.examples.long_context_lm *argv`` in
    each rank of a world of ``size``; the outputs."""
    return spawn_world(lambda rank: [
        sys.executable, "-m", "horovod_tpu_torch.examples.long_context_lm",
        *argv], size)


@pytest.mark.parametrize("attn", ["ring", "ring_zigzag", "ulysses"])
def test_long_context_twin_smoke_world1(attn):
    """The twin in-process at world 1 with its default model, the one the
    card trains (the repo's full-width ``TransformerConfig`` defaults, bf16
    compute, Adam at 3e-4), over 16 tokens: the loss falls, and on the CPU
    no kernel is launched."""
    from horovod_tpu_torch.examples import long_context_lm
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    res = long_context_lm.main(["--smoke", "--device", "cpu", "--attn",
                                attn])
    full = TransformerLM(TransformerConfig(max_seq_len=16), device="cpu")
    assert res["model"] == "full" and res["lr"] == 3e-4
    assert res["num_params"] == sum(p.numel() for p in full.parameters())
    assert res["world_size"] == 1
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
    assert all(set(step.values()) == {0}
               for step in res["launches_per_step"])


@pytest.mark.parametrize("attn", ["ring", "ring_zigzag", "ulysses"])
def test_long_context_twin_small_model_world1(attn):
    """``--model small``, the reference example's model (vocab 64, head dim
    8, float32, Adam at 1e-2), which only the plain versions take: the loss
    falls."""
    from horovod_tpu_torch.examples import long_context_lm
    res = long_context_lm.main(["--smoke", "--device", "cpu", "--model",
                                "small", "--attn", attn])
    assert res["model"] == "small" and res["lr"] == 1e-2
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]


@pytest.mark.parametrize("size,attn", [(1, "ring"), (2, "ring_zigzag"),
                                       (2, "ulysses")])
def test_long_context_twin_smoke_spawned(size, attn):
    """``python -m horovod_tpu_torch.examples.long_context_lm --smoke
    --device cpu`` alone and in a gloo world of two: every rank exits 0
    (the twin raises where the loss does not fall), and rank 0 reports the
    loss over ``size`` x 16 tokens."""
    logs = twin(size, ["--smoke", "--device", "cpu", "--attn", attn])
    assert (f"attention over {size} ranks, seq={16 * size} (16 tokens/rank)"
            in logs[0])
    assert "OK" in logs[0]
