"""Expert parallelism of the PyTorch port against the JAX package's:
``moe_alltoall``, the MoE TransformerLM and the twin of ``examples/moe.py``.

The port side runs in spawned gloo worlds of 2 and 4 (one per size, started
once for the module), each rank :func:`_moe_rank` of this file, which
imports no JAX. The reference side runs under ``jax.shard_map`` over a
sub-mesh of 2 or 4 of the conftest's 8 CPU devices, one expert a device,
as ``tests/test_moe.py`` runs it. Inputs are numpy draws from fixed seeds:
continuous random floats, so that ``lax.top_k`` and ``torch.topk`` meet no
tie (they may order equal values differently).

Tolerances (float32 on both sides, which differ in summation order only):
outputs and the load-balance loss rtol 1e-5 atol 1e-5 (as
``tests/test_moe.py``); gradients rtol 1e-4; the model's first-step logits
and loss rtol 1e-5, and its parameters after three Adam steps rtol 1e-4
atol 2e-6 (torch's and optax's Adam round their float32 bias correction
differently, ROADMAP's intended differences).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world, spawn_world

TOKENS, D = 12, 6
KS = (1, 2)
# "full": capacity k * TOKENS, nothing drops; "low": capacity 2, most drop
CAPACITIES = ("full", "low")
MODEL = dict(vocab_size=32, num_layers=2, num_heads=2, d_model=16, d_ff=32,
             max_seq_len=8)
MODEL_LR, MODEL_STEPS = 5e-3, 3


def moe_inputs(n: int, rank: int) -> dict:
    rng = np.random.default_rng(1000 * n + rank)
    return {"x": rng.standard_normal((TOKENS, D)).astype(np.float32),
            "logits": rng.standard_normal((TOKENS, n)).astype(np.float32),
            "ct": rng.standard_normal((TOKENS, D)).astype(np.float32)}


def expert_weight(n: int, e: int) -> np.ndarray:
    rng = np.random.default_rng(500 + 10 * n + e)
    return (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)


def capacity_of(case: str, k: int) -> int:
    return k * TOKENS if case == "full" else 2


def model_tokens(n: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, MODEL["vocab_size"],
                                             (2 * n, MODEL["max_seq_len"]))


def boost_inputs(n: int, rank: int) -> dict:
    rng = np.random.default_rng(70 + rank)
    return {"x": rng.standard_normal((2, 4, 16)).astype(np.float32),
            "ct": rng.standard_normal((2, 4, 16)).astype(np.float32),
            "w": {k: np.random.default_rng(80 + i).standard_normal(s).astype(
                np.float32) * 0.3 for i, (k, s) in enumerate(
                (("router", (n, 16)), ("w_in", (n, 16, 32)),
                 ("w_out", (n, 32, 16))))}}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v, np.float32)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _ce(logits, tokens):
    """The reference trainer's loss (``tests/test_moe.py``): next-token
    cross-entropy over every position, the target rolled."""
    tgt = torch.roll(tokens, -1, dims=1)
    return -torch.log_softmax(logits, -1).gather(-1, tgt[..., None]).mean()


def alltoall_cases(hvd) -> dict:
    """This rank's ``moe_alltoall`` outputs and gradients of ``sum(y * ct)
    + 0.5 * aux`` over the world, for every k and capacity, on the
    world's device."""
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import moe_alltoall
    n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    inp = {k: torch.from_numpy(v).to(dev)
           for k, v in moe_inputs(n, rank).items()}
    out = {}
    for k in KS:
        for case in CAPACITIES:
            x = inp["x"].clone().requires_grad_()
            logits = inp["logits"].clone().requires_grad_()
            w = torch.from_numpy(expert_weight(n, rank)).to(
                dev).requires_grad_()
            y, aux = moe_alltoall(x, logits, lambda t: torch.tanh(t @ w),
                                  dist.group.WORLD, k=k,
                                  capacity=capacity_of(case, k))
            loss = (y * inp["ct"]).sum() + 0.5 * aux
            grads = torch.autograd.grad(loss, (x, logits, w))
            for name, v in zip(("y", "aux", "gx", "glogits", "gw"),
                               (y, aux, *grads)):
                out[f"k{k}_{case}_{name}"] = v.detach().cpu().numpy()
    return out


def _alltoall_rank(out_path: str, device: str | None = "cpu") -> None:
    """One rank of a world: :func:`alltoall_cases`, saved."""
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    try:
        np.savez(out_path, **alltoall_cases(hvd))
    finally:
        hvd.shutdown()


def _alltoall_rank_on_card(out_path: str) -> None:
    _alltoall_rank(out_path, device=None)


def _moe_rank(out_path: str) -> None:
    """One rank of a gloo world: every ``moe_alltoall`` case, the
    grad-boost check and three steps of the MoE TransformerLM, saved."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          from_flax_params)
    from horovod_tpu_torch.models.transformer import MoeMLP
    from horovod_tpu_torch.parallel import moe_alltoall

    hvd.init(device="cpu")
    try:
        n, rank, world = hvd.size(), hvd.rank(), dist.group.WORLD
        out = alltoall_cases(hvd)
        # grad_boost: MoeMLP against moe_alltoall on the plain weights
        b = boost_inputs(n, rank)
        cfg = TransformerConfig(d_model=16, d_ff=32, dtype=torch.float32,
                                moe_experts=n)
        mlp = MoeMLP(cfg, "cpu", world)
        with torch.no_grad():
            mlp.router.weight.copy_(torch.from_numpy(b["w"]["router"]))
            mlp.w_in.copy_(torch.from_numpy(b["w"]["w_in"]))
            mlp.w_out.copy_(torch.from_numpy(b["w"]["w_out"]))
        x, ct = torch.from_numpy(b["x"]), torch.from_numpy(b["ct"])
        y = mlp(x)
        (y * ct).sum().backward()
        wi, wo = (mlp.w_in[rank].detach().clone().requires_grad_(),
                  mlp.w_out[rank].detach().clone().requires_grad_())
        flat = x.reshape(-1, 16)
        y_plain, _ = moe_alltoall(
            flat, mlp.router(flat).detach(),
            lambda t: torch.nn.functional.gelu(
                t @ wi, approximate="tanh") @ wo, world)
        (y_plain.reshape(x.shape) * ct).sum().backward()
        out.update({"boost_y": y.detach().numpy(),
                    "plain_y": y_plain.detach().reshape(x.shape).numpy(),
                    "boost_gw_in": mlp.w_in.grad.numpy(),
                    "boost_gw_out": mlp.w_out.grad.numpy(),
                    "plain_gw_in": wi.grad.numpy(),
                    "plain_gw_out": wo.grad.numpy()})
        # the MoE TransformerLM from the JAX model's weights
        params = _unflat(dict(np.load(Path(out_path).parent /
                                      "jax_params.npz")))
        cfg = TransformerConfig(dtype=torch.float32, moe_experts=n, **MODEL)
        model = TransformerLM(cfg, device="cpu", expert_group=world)
        model.load_state_dict(from_flax_params(params))
        before = model.blocks[0].mlp.w_in.detach().clone()
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=MODEL_LR))
        t = torch.from_numpy(model_tokens(n)[2 * rank:2 * rank + 2])
        losses = []
        for step in range(MODEL_STEPS):
            opt.zero_grad()
            logits = model(t)
            loss = _ce(logits, t) + 0.01 * model.moe_aux_loss()
            loss.backward()
            opt.step()
            losses.append(loss.item())
            if step == 0:
                out["model_logits0"] = logits.detach().numpy()
                out["model_aux0"] = model.moe_aux_loss().detach().numpy()
        out["model_losses"] = np.asarray(losses)
        out.update({"model_p_" + k: v.numpy()
                    for k, v in model.state_dict().items()})
        out["model_w_in_moved"] = (model.blocks[0].mlp.w_in.detach()
                                   - before).abs().reshape(n, -1).sum(
                                       1).numpy()
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


# dp 2 x ep 2 in a world of four: two nodes of two, the expert axis within
# the node (dcn 2 x ici_dp 1 x expert 2), SGD as the reference's composed
# step (``tests/test_composed_mesh.py``)
DPEP_LR, DPEP_STEPS = 0.1, 3


def dpep_tokens() -> np.ndarray:
    """Two sequences a rank of the world of four, in rank order."""
    return np.random.default_rng(5).integers(
        0, MODEL["vocab_size"], (8, MODEL["max_seq_len"]))


def _dpep_rank(out_path: str) -> None:
    """One rank of dp 2 x ep 2: the MoE TransformerLM over the layout's
    expert group, from the JAX model's weights, ``DPEP_STEPS`` SGD steps
    through ``DistributedOptimizer(mesh_spec=)``; also the port's own
    initialization of the expert weights."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          from_flax_params)
    from horovod_tpu_torch.parallel import mesh as composed

    hvd.init(device="cpu")
    try:
        rank = hvd.rank()
        lay = composed.layout((("expert", 2),), ici_size=2)
        cfg = TransformerConfig(dtype=torch.float32, moe_experts=2, **MODEL)
        model = TransformerLM(cfg, device="cpu",
                              expert_group=composed.composed_mesh(lay)[
                                  "expert"])
        model.reset_parameters(torch.Generator().manual_seed(0))
        mlp = model.blocks[0].mlp
        out = {"layout": np.asarray(lay.shape),
               "init_std": np.asarray([mlp.w_in.std().item(),
                                       mlp.w_out.std().item()])}
        model.load_state_dict(from_flax_params(_unflat(dict(np.load(
            Path(out_path).parent / "jax_params.npz")))))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=DPEP_LR), mesh_spec=lay)
        t = torch.from_numpy(dpep_tokens()[2 * rank:2 * rank + 2])
        losses = []
        for _ in range(DPEP_STEPS):
            opt.zero_grad()
            loss = _ce(model(t), t) + 0.01 * model.moe_aux_loss()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        out["losses"] = np.asarray(losses)
        out.update({"p_" + k: v.numpy()
                    for k, v in model.state_dict().items()})
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# on four cards (``tests/test_torch_cuda.py``): the full-width MoE
# TransformerLM over an NCCL world of 4, one expert a card
# --------------------------------------------------------------------------

CARD_BATCH, CARD_SEQ, CARD_STEPS = 2, 2048, 4
# capacity = a rank's tokens: nothing drops, so one card can run the same
# function (DenseMoE) on the four ranks' batches at once
CARD_CAPACITY_FACTOR = 4.0
CARD_POSITIONS = slice(None, None, 64)  # the logits kept for the check


def card_tokens(rank: int, vocab: int = 32000) -> np.ndarray:
    """Rank ``rank``'s batch: arithmetic progressions mod vocab."""
    rng = np.random.default_rng(rank)
    start = rng.integers(0, vocab, size=(CARD_BATCH, 1))
    step = rng.integers(1, 7, size=(CARD_BATCH, 1))
    return ((start + step * np.arange(CARD_SEQ)[None]) % vocab).astype(
        np.int64)


class DenseMoE(torch.nn.Module):
    """The MoE FFN on one card: every token through its top-1 expert,
    gate-weighted, nothing dropped and nothing exchanged: the function the
    expert-parallel FFN computes when no bucket overflows."""

    def __init__(self, router, w_in, w_out, dtype):
        super().__init__()
        self.router, self.w_in, self.w_out = router, w_in, w_out
        self.dtype = dtype

    def forward(self, x):
        from horovod_tpu_torch.parallel.moe import route_top_k
        b, s, d = x.shape
        flat = x.reshape(-1, d).to(self.dtype)
        idx, gates = route_top_k(flat.float() @ self.router.t(), 1)
        y = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
        for e in range(self.w_in.shape[0]):
            sel = idx[:, 0] == e
            h = torch.nn.functional.gelu(
                flat[sel] @ self.w_in[e].to(self.dtype), approximate="tanh")
            y[sel] = (h @ self.w_out[e].to(self.dtype)) * gates[sel]
        return y.reshape(b, s, d).to(self.dtype)


def one_card_moe_logits(state: dict, tokens, device) -> torch.Tensor:
    """The logits of the full-width MoE TransformerLM with the weights
    ``state`` on one card: the dense model's layers, each block's FFN a
    :class:`DenseMoE`."""
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    model = TransformerLM(TransformerConfig(attn_mode="ulysses"),
                          device=device)
    dense = {k: v for k, v in state.items() if ".mlp." not in k}
    missing = model.load_state_dict(dense, strict=False).missing_keys
    assert all(".mlp." in k for k in missing), missing
    for i, blk in enumerate(model.blocks):
        pre = f"blocks.{i}.mlp."
        blk.mlp = DenseMoE(*(state[pre + k].to(device) for k in
                             ("router.weight", "w_in", "w_out")),
                           torch.bfloat16)
    with torch.no_grad():
        return model(tokens)


def _moe_full_rank_on_card(out_path: str) -> None:
    """One rank of an NCCL world, one card a rank: the full-width MoE
    TransformerLM (``moe_experts`` = the world, ``"ulysses"`` attention on
    this rank's own sequences), ``CARD_STEPS`` Adam steps; rank 0 saves
    the initial weights and profiles one more step (the all-to-all's share
    of the device time)."""
    import time
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from horovod_tpu_torch.ops import flash

    hvd.init()
    try:
        n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
        cfg = TransformerConfig(attn_mode="ulysses", moe_experts=n,
                                moe_capacity_factor=CARD_CAPACITY_FACTOR)
        model = TransformerLM(cfg, expert_group=dist.group.WORLD)
        model.reset_parameters(torch.Generator().manual_seed(0))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       Path(out_path).parent / "moe_weights.pt")
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3))
        t = torch.from_numpy(card_tokens(rank, cfg.vocab_size)).to(dev)
        out = {}

        def step():
            opt.zero_grad()
            logits = model(t)
            loss = lm_loss(logits, t) + 0.01 * model.moe_aux_loss()
            loss.backward()
            opt.step()
            return logits.detach(), loss.detach()

        losses, step_s = [], []
        flash.reset_launch_counts()
        for i in range(CARD_STEPS):
            t0 = time.perf_counter()
            logits, loss = step()
            losses.append(hvd.allreduce(loss).item())
            step_s.append(time.perf_counter() - t0)
            if i == 0:
                out["logits0"] = logits[:, CARD_POSITIONS].cpu().numpy()
            del logits
        out.update(losses=losses, step_s=step_s,
                   launches=[flash.launches[k] for k in sorted(
                       flash.launches)])
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if "CUDA" in str(getattr(e, "device_type", ""))
                  and not getattr(e, "is_user_annotation", False)]
        out["profile_ms"] = [wall * 1e3, sum(
            e.self_device_time_total for e in events) / 1e3, sum(
            e.self_device_time_total for e in events
            if "nccl" in e.key.lower()) / 1e3]
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# the reference side (JAX imported inside the functions: the card's machine
# imports this file for nothing but its rank sides)
# --------------------------------------------------------------------------


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("e",))


def _jax_moe(n, k, case):
    """The reference's outputs and gradients of every device, stacked."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import moe_alltoall
    inp = [moe_inputs(n, r) for r in range(n)]
    stack = lambda key: np.stack([i[key] for i in inp])  # noqa: E731
    w = np.stack([expert_weight(n, e) for e in range(n)])

    def body(x, logits, ct, w):
        def local(x, logits, w):
            y, aux = moe_alltoall(x, logits, lambda t: jnp.tanh(t @ w), "e",
                                  k=k, capacity=capacity_of(case, k))
            return jnp.sum(y * ct[0]) + 0.5 * aux, (y, aux)
        (_, (y, aux)), grads = jax.value_and_grad(
            local, argnums=(0, 1, 2), has_aux=True)(x[0], logits[0], w[0])
        return tuple(v[None] for v in (y, aux, *grads))

    spec = P("e")
    fn = jax.jit(jax.shard_map(body, mesh=_mesh(n), in_specs=(spec,) * 4,
                               out_specs=(spec,) * 5, check_vma=False))
    outs = fn(stack("x"), stack("logits"), stack("ct"), w)
    return dict(zip(("y", "aux", "gx", "glogits", "gw"),
                    (np.asarray(o) for o in outs)))


def _jax_model(n, tmp):
    """The reference MoE TransformerLM (``attn_mode="full"``) and its
    trainer (``tests/test_moe.py``): its weights saved for the ranks, the
    first step's logits and losses of each device, and the weights after
    ``MODEL_STEPS`` Adam steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.models import TransformerConfig, TransformerLM
    cfg = TransformerConfig(dtype=jnp.float32, moe_experts=n, moe_axis="e",
                            **MODEL)
    model = TransformerLM(cfg)
    tokens = model_tokens(n)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    np.savez(tmp / "jax_params.npz", **_flat(params))
    tx = optax.adam(MODEL_LR)

    def loss_fn(p, t):
        logits, inter = model.apply({"params": p}, t,
                                    mutable=["intermediates"])
        tgt = jnp.roll(t, -1, axis=1)
        ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                           tgt[..., None], -1))
        aux = sum(jnp.sum(a) for a in
                  jax.tree_util.tree_leaves(inter["intermediates"]))
        return ce + 0.01 * aux, (logits, aux)

    def step(p, o, t):
        (loss, (logits, aux)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(p, t)
        g = jax.tree.map(lambda x: lax.pmean(x, "e"), g)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss[None], logits, aux[None]

    fn = jax.jit(jax.shard_map(
        step, mesh=_mesh(n), in_specs=(P(), P(), P("e")),
        out_specs=(P(), P(), P("e"), P("e"), P("e")), check_vma=False))
    opt = tx.init(params)
    losses, first = [], None
    for _ in range(MODEL_STEPS):
        params, opt, loss, logits, aux = fn(params, opt, tokens)
        losses.append(np.asarray(loss))
        if first is None:
            first = (np.asarray(logits), np.asarray(aux))
    return {"losses": np.stack(losses, 1),
            "logits0": first[0].reshape((n, -1) + first[0].shape[1:]),
            "aux0": first[1], "params": params}


def _jax_dpep(tmp):
    """The reference's composed dp x ep step on 4 of the CPU devices laid
    out as the port's ranks: ``pmean`` of the gradients over ``expert``,
    then ``parallel.sync_gradients`` over the data axes, ``optax.sgd``;
    its weights saved for the ranks, each device's losses and the weights
    after ``DPEP_STEPS`` steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from horovod_tpu import parallel
    from horovod_tpu.models import TransformerConfig, TransformerLM
    lay = parallel.layout((("expert", 2),), ici_size=2, world=4)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(lay.shape),
                lay.axis_names)
    cfg = TransformerConfig(dtype=jnp.float32, moe_experts=2,
                            moe_axis="expert", **MODEL)
    model = TransformerLM(cfg)
    tokens = dpep_tokens()
    params = model.init(jax.random.PRNGKey(1),
                        jnp.asarray(tokens[:2]))["params"]
    np.savez(tmp / "jax_params.npz", **_flat(params))
    tx = optax.sgd(DPEP_LR)

    def loss_fn(p, t):
        logits, inter = model.apply({"params": p}, t,
                                    mutable=["intermediates"])
        tgt = jnp.roll(t, -1, axis=1)
        ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                           tgt[..., None], -1))
        return ce + 0.01 * sum(jnp.sum(a) for a in jax.tree_util.tree_leaves(
            inter["intermediates"]))

    def step(p, o, t):
        loss, g = jax.value_and_grad(loss_fn)(p, t)
        g = jax.tree.map(lambda x: lax.pmean(x, "expert"), g)
        g = parallel.sync_gradients(g, lay)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss[None]

    spec = P(lay.axis_names)  # the batch over every axis: rank order
    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P(), spec),
                               out_specs=(P(), P(), spec), check_vma=False))
    opt = tx.init(params)
    losses = []
    for _ in range(DPEP_STEPS):
        params, opt, loss = fn(params, opt, tokens)
        losses.append(np.asarray(loss))
    return {"losses": np.stack(losses, 1), "params": params}


@pytest.fixture(scope="module")
def dpep_world(tmp_path_factory):
    """The reference's composed step and the port's ranks at dp 2 x ep
    2."""
    tmp = tmp_path_factory.mktemp("dpep")
    ref = _jax_dpep(tmp)
    return run_world("_dpep_rank", tmp, size=4, module="test_torch_moe"), ref


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def moe_world(request, tmp_path_factory):
    """Both sides at a world of ``n``: the port's ranks, the reference's
    model run."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"moe{n}")
    ref = _jax_model(n, tmp)
    return n, run_world("_moe_rank", tmp, size=n, module="test_torch_moe"), \
        ref


@pytest.mark.parametrize("case", CAPACITIES)
@pytest.mark.parametrize("k", KS)
def test_moe_alltoall_matches_jax(moe_world, k, case):
    """Outputs and the load-balance loss (rtol 1e-5, atol 1e-5), and the
    gradients of ``sum(y * ct) + 0.5 * aux`` with respect to x, the router
    logits and this rank's expert weights (rtol 1e-4, atol 1e-6), with
    nothing dropped and with the capacity forced to 2 so that tokens
    drop."""
    n, ranks, _ = moe_world
    want = _jax_moe(n, k, case)
    for r, res in enumerate(ranks):
        for name in ("y", "aux"):
            np.testing.assert_allclose(res[f"k{k}_{case}_{name}"],
                                       want[name][r], rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {name}")
        for name in ("gx", "glogits", "gw"):
            np.testing.assert_allclose(res[f"k{k}_{case}_{name}"],
                                       want[name][r], rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {name}")
    if case == "low":  # capacity 2 of 12 tokens: most contribute nothing
        dropped = [int((np.abs(res[f"k{k}_low_y"]).sum(-1) == 0).sum())
                   for res in ranks]
        assert min(dropped) > 0, dropped


def test_moe_grad_boost(moe_world):
    """The MoE FFN's ``w * n - w.detach() * (n - 1)``: its forward equals
    the plain weights' within float32 rounding (rtol 1e-5), and its
    gradient is n times theirs on this rank's expert (rtol 1e-5, atol 1e-5
    of the largest entry: the forward's rounding step moves an entry near
    zero by as much as a large one) and zero on the others."""
    n, ranks, _ = moe_world
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["boost_y"], res["plain_y"],
                                   rtol=1e-5, atol=1e-6)
        for w in ("w_in", "w_out"):
            g = res[f"boost_g{w}"]
            want = n * res[f"plain_g{w}"]
            np.testing.assert_allclose(g[r], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
            others = np.delete(g, r, axis=0)
            assert not others.any(), f"rank {r} {w}"


def test_moe_transformer_first_step_matches_jax(moe_world):
    """``TransformerLM(moe_experts=n, expert_group=world)`` with the JAX
    model's weights (``from_flax_params``): each rank's first-step logits
    (rtol 1e-5, atol 1e-5) and loss (rtol 1e-5)."""
    n, ranks, ref = moe_world
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["model_logits0"], ref["logits0"][r],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["model_losses"][0],
                                   ref["losses"][r, 0], rtol=1e-5)


def test_moe_transformer_adam_steps_match_jax(moe_world):
    """Three Adam steps of the reference trainer (cross-entropy plus 0.01
    times the summed load-balance losses, the gradients averaged): every
    rank's losses (rtol 1e-4) and every parameter afterwards (rtol 1e-4,
    atol 2e-6; the float32 bias correction, see the module's docstring);
    every expert's weights moved."""
    from horovod_tpu_torch.models import from_flax_params
    n, ranks, ref = moe_world
    want = from_flax_params(ref["params"])
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["model_losses"], ref["losses"][r],
                                   rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(res["model_p_" + k], v.numpy(),
                                       rtol=1e-4, atol=2e-6,
                                       err_msg=f"rank {r} {k}")
        assert (res["model_w_in_moved"] > 0).all(), res["model_w_in_moved"]


def test_moe_transformer_dp_ep_mesh_spec_matches_jax_composed_step(
        dpep_world):
    """The MoE TransformerLM at dp 2 x ep 2 (two nodes of two, the expert
    pair within the node), ``DistributedOptimizer(mesh_spec=)`` and SGD,
    against the reference's composed step (its ``pmean`` over ``expert``,
    then ``sync_gradients`` over the data axes) from the same weights:
    each rank's losses (rtol 1e-5) and the parameters after three steps
    (rtol 1e-4, atol 1e-6)."""
    from horovod_tpu_torch.models import from_flax_params
    ranks, ref = dpep_world
    want = from_flax_params(ref["params"])
    for r, res in enumerate(ranks):
        assert res["layout"].tolist() == [2, 1, 2]
        np.testing.assert_allclose(res["losses"], ref["losses"][r],
                                   rtol=1e-5, err_msg=f"rank {r}")
        for k, v in want.items():
            np.testing.assert_allclose(res["p_" + k], v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {r} {k}")


def test_moe_transformer_dp_ep_ranks_hold_one_model(dpep_world):
    """Under dp x ep each rank's gradient of a replicated weight (the
    attention, the embeddings, the router) covers its own tokens alone;
    the step's mean over the expert axis makes every rank's parameters
    the same, bitwise, after three steps."""
    ranks, _ = dpep_world
    keys = [k for k in ranks[0] if k.startswith("p_")]
    assert any("mlp.router" in k for k in keys)
    for r, res in enumerate(ranks[1:], 1):
        for k in keys:
            np.testing.assert_array_equal(res[k], ranks[0][k],
                                          err_msg=f"rank {r} {k}")


def test_moe_expert_init_matches_flax_fan_in(dpep_world):
    """``reset_parameters`` draws a (n_experts, fan, out) expert weight
    with std 1/sqrt(n_experts * fan), as flax's ``lecun_normal`` counts the
    leading dim (rtol 0.1: 1024 draws a weight)."""
    ranks, _ = dpep_world
    n, d, d_ff = 2, MODEL["d_model"], MODEL["d_ff"]
    for res in ranks:
        np.testing.assert_allclose(
            res["init_std"], [1 / np.sqrt(n * d), 1 / np.sqrt(n * d_ff)],
            rtol=0.1)


def test_moe_twin_smoke_world2(tmp_path):
    """``python -m horovod_tpu_torch.examples.moe --smoke --device cpu
    --model small`` in a gloo world of two: both ranks exit 0, so the loss
    fell (the twin raises where it does not)."""
    logs = spawn_world(lambda rank: [
        sys.executable, "-m",
        "horovod_tpu_torch.examples.moe", "--smoke", "--device", "cpu",
        "--model", "small"], 2, trace_dir=tmp_path)
    assert "MoE: 2 experts over 2 ranks" in logs[0], logs[0]
    assert "OK" in logs[0], logs[0]


def test_moe_rejects_a_wrong_group():
    """The router's width must be the expert group's size (the reference's
    shape check), and the model's ``moe_experts`` the group's size."""
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    from horovod_tpu_torch.parallel import moe_alltoall
    with pytest.raises(ValueError, match="axis size 1"):
        moe_alltoall(torch.zeros(4, 3), torch.zeros(4, 2), lambda t: t)
    with pytest.raises(ValueError, match="expert group of that size"):
        TransformerLM(TransformerConfig(moe_experts=2, **MODEL),
                      device="cpu")
