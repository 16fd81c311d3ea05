"""``hvd.cached_step`` of the port (``horovod_tpu_torch/ops/gspmd_cache.py``)
against the JAX package's (``horovod_tpu/ops/gspmd_cache.py``).

The cases of ``tests/test_gspmd_cache.py``, each run as the same script on
both sides, the JAX side on the conftest's CPU devices, the port at a gloo
world of one in this process: a re-created closure replays (one build), two
structurally identical argument trees share one plan, shape and dtype drift
are misses whose plans coexist, a knob override's epoch flushes the plans,
``HVD_GSPMD_CACHE=0`` and ``HVD_CACHE_CAPACITY=0`` bypass, a plan whose
executable rejects its inputs (the port: whose tensors moved) is dropped and
recorded again, and the optimizer's sync counts in ``passthrough_syncs`` at
the record only. After each script both sides' ``gspmd_cache_stats()``
(builds, hits, events, passthrough syncs) and ``traces`` are equal, and the
results agree (rtol 1e-6: float32 on both sides; on the host a hit runs the
step as a plain call).

The port's own cases, which the JAX package has no counterpart for (its
hyperparameters live in the traced optimizer state, and its steps read no
hidden tensors): an LR scheduler between calls drops and re-records, one
inside the step makes the signature UNPLANNABLE, numpy arguments are
signed by shape and dtype (against the JAX package's stats), the reach
follows attributes and module globals, ``_OutsideReads`` names a tensor
the plan cannot track, and ``TorchState.restore`` in place keeps the plan
unless it restores another ``lr``. Each cached run's parameters are its
eager run's bit for bit.

Then the small TransformerLM trained 3 steps under ``cached_step`` with a
fresh closure each step, at a gloo world of 2 (rank side
:func:`_gspmd_rank`, which imports no JAX): bitwise the port's eager run of
the same steps, and within rtol 1e-5 (losses) and rtol 1e-4, atol 1e-6
(parameters) of the JAX package's ``cached_step`` over ``jax.shard_map``
on 2 devices from the same weights, with SGD (the tolerances of
``tests/test_torch_adasum.py``'s trainer).
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.ops import dispatch_cache as jdc
from horovod_tpu.ops import gspmd_cache as jgc
from horovod_tpu.utils import envs as jenvs
from horovod_tpu_torch.ops import dispatch_cache as tdc
from horovod_tpu_torch.ops import gspmd_cache as tgc
from horovod_tpu_torch.utils import envs as tenvs
from test_torch_world2 import run_world

MODEL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
             max_seq_len=32)
LR, STEPS = 0.5, 3


@pytest.fixture(scope="module")
def torch_world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


_RESETS = (jdc.reset, tdc.reset, jgc.reset_stats, tgc.reset_stats)


@pytest.fixture(autouse=True)
def _fresh(torch_world1):
    for reset in _RESETS:
        reset()
    yield
    for reset in _RESETS:
        reset()


def _stats(gc) -> dict:
    s = gc.stats()
    return {k: s[k] for k in ("hits", "builds", "events",
                              "passthrough_syncs")}


# the step functions: re-executed per wrapper, one code constant each
def _jax_step():
    def train_step(params, x):
        return jax.tree.map(lambda p: p - 0.1 * x.mean(), params)
    return train_step


def _torch_step():
    def train_step(params, x):
        return {k: p - 0.1 * x.float().mean() for k, p in params.items()}
    return train_step


def _jparams(scale=1.0):
    return {"w": jnp.full((4, 4), scale), "b": jnp.zeros((4,))}


def _tparams(scale=1.0):
    return {"w": torch.full((4, 4), scale), "b": torch.zeros(4)}


def _both(jfn, tfn):
    """Run the same script on both sides; returns each side's results and
    stats."""
    jout = jfn()
    tout = tfn()
    return jout, tout, _stats(jgc), _stats(tgc)


def _close(jout, tout):
    for a, b in zip(jax.tree.leaves(jout), _leaves(tout)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def _leaves(tree):
    from horovod_tpu_torch.utils.tree import flatten
    return flatten(tree)[0]


def test_recreated_closure_replays_without_retrace():
    def jax_script():
        x = jnp.arange(8.0)
        s1 = jgc.cached_step(_jax_step())
        out1 = s1(_jparams(), x)
        s2 = jgc.cached_step(_jax_step())
        out2 = s2(_jparams(), x)
        return [out1, out2, s1.traces, s2.traces]

    def torch_script():
        x = torch.arange(8.0)
        s1 = tgc.cached_step(_torch_step())
        out1 = s1(_tparams(), x)
        s2 = tgc.cached_step(_torch_step())
        out2 = s2(_tparams(), x)
        return [out1, out2, s1.traces, s2.traces]

    jout, tout, js, ts = _both(jax_script, torch_script)
    assert ts == js and ts["builds"] == 1 and ts["hits"] == 1
    assert tout[2:] == jout[2:] == [1, 0]
    _close(jout[:2], tout[:2])


def test_structurally_identical_pytrees_share_one_program():
    def jax_script():
        step = jgc.cached_step(_jax_step())
        x = jnp.arange(8.0)
        return [step(_jparams(1.0), x), step(_jparams(3.0), x), step.traces]

    def torch_script():
        step = tgc.cached_step(_torch_step())
        x = torch.arange(8.0)
        return [step(_tparams(1.0), x), step(_tparams(3.0), x), step.traces]

    jout, tout, js, ts = _both(jax_script, torch_script)
    assert ts == js and ts["hits"] == 1 and tout[2] == jout[2] == 1
    _close(jout[:2], tout[:2])


@pytest.mark.parametrize("drift", ["shape", "dtype"])
def test_drift_is_a_miss_and_signatures_coexist(drift):
    def xs(lib):
        if drift == "shape":
            return [lib.arange(8.0), lib.arange(4.0)]
        return [lib.arange(8.0), lib.arange(8.0).astype(jnp.float16)
                if lib is jnp else torch.arange(8.0).half()]

    def jax_script():
        step = jgc.cached_step(_jax_step())
        a, b = xs(jnp)
        out = [step(_jparams(), a), step(_jparams(), b)]
        out += [step(_jparams(), a), step(_jparams(), b), step.traces]
        return out

    def torch_script():
        step = tgc.cached_step(_torch_step())
        a, b = xs(torch)
        out = [step(_tparams(), a), step(_tparams(), b)]
        out += [step(_tparams(), a), step(_tparams(), b), step.traces]
        return out

    jout, tout, js, ts = _both(jax_script, torch_script)
    assert ts == js and ts["builds"] == 2 and ts["hits"] == 2
    assert tout[4] == jout[4] == 2
    for j, t in zip(jout[:4], tout[:4]):
        for a, b in zip(jax.tree.leaves(j), _leaves(t)):
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32), rtol=1e-3)


def test_knob_epoch_flushes_cached_programs():
    def script(gc, envs, params, x, step_fn):
        step = gc.cached_step(step_fn())
        step(params(), x)
        envs.set_override(envs.FUSION_THRESHOLD, 123456)
        try:
            out = step(params(), x)
        finally:
            envs.clear_override(envs.FUSION_THRESHOLD)
        return out

    jout, tout, js, ts = _both(
        lambda: script(jgc, jenvs, _jparams, jnp.arange(8.0), _jax_step),
        lambda: script(tgc, tenvs, _tparams, torch.arange(8.0), _torch_step))
    assert ts == js and ts["builds"] == 2 and ts["hits"] == 0
    assert ts["events"]["recorded"] == 2
    _close(jout, tout)


@pytest.mark.parametrize("knob", ["HVD_GSPMD_CACHE", "HVD_CACHE_CAPACITY"])
def test_disabled_knob_bypasses_cache(knob, monkeypatch):
    monkeypatch.setenv(knob, "0")

    def script(gc, params, x, step_fn):
        step = gc.cached_step(step_fn())
        return [step(params(), x), step(params(), x)]

    jout, tout, js, ts = _both(
        lambda: script(jgc, _jparams, jnp.arange(8.0), _jax_step),
        lambda: script(tgc, _tparams, torch.arange(8.0), _torch_step))
    assert ts == js and ts["builds"] == 0 and ts["hits"] == 0
    assert tdc.stats()["gspmd_builds"] == 0
    assert ts["events"]["bypass"] == 2
    _close(jout, tout)


def _torch_model_step(model, opt):
    def train_step(x):
        opt.zero_grad()
        loss = (model(x) ** 2).mean()
        loss.backward()
        opt.step()
        return loss.detach()
    return train_step


@pytest.mark.parametrize("move", ["parameter", "optimizer"])
def test_moved_tensor_is_a_rejection_that_rerecords(move):
    """The JAX package's executable that rejects its inputs, forced; the
    port's plan whose tensors moved: a parameter given new storage, or the
    optimizer re-created. Either way the call runs plain, the plan is
    dropped and counted as invalidated and a fallback, no hit is counted,
    and the next call records again and the one after replays."""
    x = jnp.arange(8.0)
    step = jgc.cached_step(_jax_step())
    jref = step(_jparams(), x)
    plan = jdc.lookup(step._store_key((_jparams(), x)), record_stats=False)

    def rejecting_execute(*args):
        raise TypeError("Argument types differ from the types for which "
                        "this computation was compiled (forced)")

    plan.execute = rejecting_execute
    jout = step(_jparams(), x)
    step(_jparams(), x)
    step(_jparams(), x)
    for k in jref:
        np.testing.assert_allclose(np.asarray(jout[k]), np.asarray(jref[k]))
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    # momentum: the optimizer has state tensors a graph reads
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    tx = torch.randn(5, 4)
    tgc.cached_step(_torch_model_step(model, opt))(tx)
    key = tgc.cached_step(_torch_model_step(model, opt))._store_key((tx,))
    assert tdc.lookup(key, record_stats=False) is not None
    if move == "parameter":
        model.weight.data = model.weight.data.clone()
    else:
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    tgc.cached_step(_torch_model_step(model, opt))(tx)
    assert tdc.lookup(key, record_stats=False) is None
    for _ in range(2):
        tgc.cached_step(_torch_model_step(model, opt))(tx)
    js, ts = _stats(jgc), _stats(tgc)
    assert ts == js
    assert ts["builds"] == 2 and ts["hits"] == 1
    assert ts["events"]["invalidated"] == 1 and ts["events"]["fallback"] == 1


class _Trainer:
    def __init__(self):
        torch.manual_seed(1)
        self.model = torch.nn.Linear(4, 3)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=0.1,
                                   momentum=0.9)

    def step(self, x):
        self.opt.zero_grad()
        (self.model(x) ** 2).mean().backward()
        self.opt.step()


def test_a_bound_method_step_tracks_its_objects():
    """A step that is a method reaches its modules and optimizers through
    its object: moving one of its parameters is a rejection there too."""
    trainer = _Trainer()
    x = torch.randn(5, 4)
    for _ in range(2):
        tgc.cached_step(trainer.step)(x)
    trainer.model.bias.data = trainer.model.bias.data.clone()
    tgc.cached_step(trainer.step)(x)
    st = _stats(tgc)
    assert st["builds"] == 1 and st["hits"] == 1
    assert st["events"]["invalidated"] == 1


def test_a_dropped_plan_is_freed_at_once():
    """A plan holds no reference to itself: dropped from the cache it is
    freed without the cyclic collector, as its CUDA Graph must be before
    ``shutdown()`` destroys the communicator whose work the graph holds."""
    import gc
    import weakref
    step = tgc.cached_step(_torch_step())
    x = torch.arange(8.0)
    step(_tparams(), x)
    plan = tdc.lookup(step._store_key((_tparams(), x)), record_stats=False)
    held = plan.static_out = torch.zeros(1)  # stands for the graph's tensors
    alive = weakref.ref(held)
    del plan, held
    gc.disable()
    try:
        assert alive() is not None
        tdc.invalidate("test")
        assert alive() is None
    finally:
        gc.enable()


def test_passthrough_syncs_frozen_while_warm():
    """``DistributedOptimizer``'s sync counts once, at the record (the JAX
    package's trace of its GSPMD passthrough); the replays hold it."""
    import horovod_tpu as jhvd
    tx = jhvd.DistributedOptimizer(optax.sgd(0.1))

    def make_jax():
        def step(p, o, x):
            g = jax.grad(lambda q: jnp.sum((q["w"] * x) ** 2))(p)
            u, o = tx.update(g, o, p)
            return optax.apply_updates(p, u), o
        return step

    p = {"w": jnp.ones(4)}
    o = tx.init(p)
    x = jnp.arange(4.0)
    for _ in range(4):
        p, o = jgc.cached_step(make_jax())(p, o, x)
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                    lr=0.1))
    tx_in = torch.randn(5, 4)
    counts = []
    for _ in range(4):
        tgc.cached_step(_torch_model_step(model, opt))(tx_in)
        counts.append(tgc.stats()["passthrough_syncs"])
    assert counts == [1, 1, 1, 1]
    assert _stats(tgc) == _stats(jgc)


def test_cuda_only_refusals_do_not_touch_the_host():
    """A non-capturable optimizer is refused on the card only; on the host
    the step is the plain version and records as usual."""
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    assert opt.param_groups[0]["capturable"] is False
    tgc.cached_step(_torch_model_step(model, opt))(torch.randn(5, 4))
    assert tgc.stats()["builds"] == 1


def _sgd_model(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    return model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)


@pytest.mark.parametrize("cached", [False, True])
def test_an_lr_scheduler_between_calls_rerecords(cached):
    """An LR scheduler stepped between calls changes ``lr``, a constant a
    graph freezes: the call after each change finds the plan's
    hyperparameters changed, drops it and runs plain, and the next call
    records again. The parameters are the eager run's bit for bit."""
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(2))
    out = {}
    for mode in (False, cached):
        model, opt = _sgd_model()
        sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones=[2, 5],
                                                     gamma=0.5)
        for _ in range(7):
            fn = _torch_model_step(model, opt)
            (tgc.cached_step(fn) if mode else fn)(x)
            sched.step()
        out[mode] = [p.detach().clone() for p in model.parameters()]
    for a, b in zip(out[False], out[cached]):
        assert torch.equal(a, b)
    st = _stats(tgc)
    if cached:
        # calls 1 record, 2 hit; lr changes; 3 drops, 4 records, 5 hits;
        # lr changes; 6 drops, 7 records
        assert st["builds"] == 3 and st["hits"] == 2
        assert st["events"]["invalidated"] == 2
        assert st["events"]["fallback"] == 2
    else:
        assert st["builds"] == 0


def test_a_step_that_changes_its_hyperparameters_is_unplannable():
    """A scheduler stepped inside the step changes ``lr`` in the step's
    own run: a graph would freeze it, so the signature is UNPLANNABLE and
    every call runs plain (one fallback, no hit)."""
    model, opt = _sgd_model()
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    x = torch.randn(5, 4)

    def make_step():
        def train_step(t):
            opt.zero_grad()
            (model(t) ** 2).mean().backward()
            opt.step()
            sched.step()
        return train_step

    for _ in range(3):
        tgc.cached_step(make_step())(x)
    st = _stats(tgc)
    assert st["builds"] == 0 and st["hits"] == 0
    assert st["events"] == {"fallback": 1}
    assert opt.param_groups[0]["lr"] == 0.1 * 0.5 ** 3


def test_numpy_arguments_are_signed_by_shape_and_dtype():
    """A numpy argument is signed by its shape and dtype, as the JAX
    package signs its aval: a new batch of the same shape is a hit, not a
    new plan; another shape is a miss."""
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal(8).astype(np.float32) for _ in range(3)]
    batches.append(rng.standard_normal(4).astype(np.float32))

    def torch_step():
        def train_step(params, x):
            return {k: p - 0.1 * torch.from_numpy(x).mean()
                    for k, p in params.items()}
        return train_step

    jout = [jgc.cached_step(_jax_step())(_jparams(), b) for b in batches]
    tout = [tgc.cached_step(torch_step())(_tparams(), b) for b in batches]
    js, ts = _stats(jgc), _stats(tgc)
    assert ts == js and ts["builds"] == 2 and ts["hits"] == 2
    _close(jout, tout)


class _Holder:
    """A plain object holding the trainer: reached through its
    attributes."""

    def __init__(self):
        self.model, self.opt = _sgd_model(3)


_HOLDER = {}


def _holder_step(x):
    h = _HOLDER["h"]
    h.opt.zero_grad()
    (h.model(x) ** 2).mean().backward()
    h.opt.step()


@pytest.mark.parametrize("path", ["attribute", "global"])
def test_the_reach_follows_attributes_and_globals(path):
    """A model reached through a plain object's attribute, or through a
    global dict of the step's module, is in the plan's layout: moving its
    parameter drops the plan."""
    holder = _Holder()
    x = torch.randn(5, 4)
    if path == "attribute":
        def make_step():
            def train_step(t):
                holder.opt.zero_grad()
                (holder.model(t) ** 2).mean().backward()
                holder.opt.step()
            return train_step
    else:
        _HOLDER["h"] = holder

        def make_step():
            return _holder_step
    try:
        reach = tgc._step_objects(make_step())
        assert holder.model in reach.modules and holder.opt in reach.optimizers
        for _ in range(2):
            tgc.cached_step(make_step())(x)
        holder.model.weight.data = holder.model.weight.data.clone()
        tgc.cached_step(make_step())(x)
    finally:
        _HOLDER.clear()
    st = _stats(tgc)
    assert st["builds"] == 1 and st["hits"] == 1
    assert st["events"]["invalidated"] == 1


class _Hidden:
    w = torch.ones(3)  # a class attribute: the reach does not walk classes


def test_outside_reads_name_what_the_plan_cannot_track():
    """The card's capture runs under ``_OutsideReads``: a tensor the step
    reads that is neither an argument nor reached is named (and the
    signature becomes UNPLANNABLE there), while a step over its own model,
    optimizer state and arguments reads nothing untracked. Driven here on
    the host, on the op stream the capture sees."""
    model, opt = _sgd_model()
    x = torch.randn(5, 4)
    plain = _torch_model_step(model, opt)
    plain(x)  # momentum buffers exist, as after a record's eager run

    def hidden(t):
        opt.zero_grad()
        ((model(t) + _Hidden.w) ** 2).mean().backward()
        opt.step()

    for fn, want in ((plain, []), (hidden, [((3,), torch.float32)])):
        with tgc._OutsideReads() as reads:
            fn(x)
        known = tgc._read_tensors(tgc._step_objects(fn)) + [x]
        assert [v[1:] for v in reads.untracked(known)] == want


def test_torch_state_restore_in_place_keeps_the_plan():
    """``TorchState.restore`` writes the committed values into the live
    tensors and sets the hyperparameters back: with the same ``lr`` the
    plan survives (no invalidation), and with another ``lr`` restored it
    is dropped and recorded again. The parameters are the eager run's."""
    import horovod_tpu_torch as hvd
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(4))
    out = {}
    for cached in (False, True):
        tdc.reset()
        tgc.reset_stats()
        model, opt = _sgd_model()

        def run():
            fn = _torch_model_step(model, opt)
            (tgc.cached_step(fn) if cached else fn)(x)

        state = hvd.elastic.TorchState(model=model, optimizer=opt)
        for _ in range(2):
            run()
        state.commit()
        run()
        state.restore()  # the same lr: the plan stays
        run()
        opt.param_groups[0]["lr"] = 0.05
        state.commit()
        opt.param_groups[0]["lr"] = 0.2
        run()  # another lr: dropped, plain
        run()  # recorded
        state.restore()  # lr 0.05 again: dropped at the next call
        run()
        run()
        out[cached] = ([p.detach().clone() for p in model.parameters()],
                       _stats(tgc))
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    st = out[True][1]
    assert st["events"]["invalidated"] == 2 and st["builds"] == 3
    assert st["hits"] == 3


# --------------------------------------------------------------------------
# the TransformerLM under cached_step at a gloo world of 2
# --------------------------------------------------------------------------

def model_tokens(rank: int) -> np.ndarray:
    return np.random.default_rng(900 + rank).integers(
        0, MODEL["vocab_size"], (2, MODEL["max_seq_len"]))


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _flat_params(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v, np.float32)
    return out


def _gspmd_rank(out_path: str) -> None:
    """One rank: the same weights trained STEPS steps eagerly and under
    ``cached_step`` with a fresh closure each step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          from_flax_params, lm_loss)
    hvd.init(device="cpu")
    try:
        os.environ["HVD_BUCKET_BYTES"] = "65536"
        flat = dict(np.load(Path(out_path).parent / "jax_params.npz"))
        tokens = torch.from_numpy(model_tokens(hvd.rank()))
        out = {}
        for mode in ("eager", "cached"):
            model = TransformerLM(TransformerConfig(dtype=torch.float32,
                                                    **MODEL), device="cpu")
            model.load_state_dict(from_flax_params(_unflat(flat)))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=LR))

            def make_step():
                def train_step(t):
                    opt.zero_grad()
                    loss = lm_loss(model(t), t)
                    loss.backward()
                    opt.step()
                    return loss.detach()
                return train_step

            losses = []
            for _ in range(STEPS):
                step = (make_step() if mode == "eager"
                        else hvd.cached_step(make_step()))
                losses.append(step(tokens).item())
            out[f"{mode}_losses"] = np.asarray(losses)
            out.update({f"{mode}/{k}": v.numpy()
                        for k, v in model.state_dict().items()})
        st = hvd.gspmd_cache_stats()
        out.update(builds=st["builds"], hits=st["hits"],
                   passthrough=st["passthrough_syncs"])
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


def _jax_trainer(tmp):
    """The reference's ``DistributedOptimizer(optax.sgd)`` step under
    ``jax.shard_map`` over 2 devices, through ``cached_step`` with a fresh
    closure each step: its weights saved for the ranks, each device's
    losses, the weights after STEPS steps and the cache's stats."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import horovod_tpu as jhvd
    from horovod_tpu.models import TransformerConfig, TransformerLM
    model = TransformerLM(TransformerConfig(dtype=jnp.float32, **MODEL))
    tokens = np.concatenate([model_tokens(r) for r in range(2)])
    params = model.init(jax.random.PRNGKey(5),
                        jnp.asarray(tokens[:2]))["params"]
    np.savez(tmp / "jax_params.npz", **_flat_params(params))
    tx = jhvd.DistributedOptimizer(optax.sgd(LR))
    mesh = Mesh(np.array(jax.devices()[:2]), (jhvd.axis_name(),))
    spec = P(jhvd.axis_name())

    def make_step():
        def loss_fn(p, t):
            logits = model.apply({"params": p}, t)
            tgt = jnp.roll(t, -1, axis=1)
            return -jnp.mean(jnp.take_along_axis(
                jax.nn.log_softmax(logits), tgt[..., None], -1)[:, :-1])

        def step(p, o, t):
            loss, g = jax.value_and_grad(loss_fn)(p, t)
            u, o = tx.update(g, o, p)
            return optax.apply_updates(p, u), o, loss[None]

        return jax.shard_map(step, mesh=mesh, in_specs=(P(), P(), spec),
                             out_specs=(P(), P(), spec), check_vma=False)

    # placed on the mesh as the step's outputs are, so that step 2's
    # arguments have step 1's signature
    repl = NamedSharding(mesh, P())
    params = jax.device_put(params, repl)
    opt = jax.device_put(tx.init(params), repl)
    toks = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, spec))
    losses = []
    jdc.reset()
    jgc.reset_stats()
    for _ in range(STEPS):
        params, opt, loss = jgc.cached_step(make_step())(params, opt, toks)
        losses.append(np.asarray(loss))
    return {"losses": np.stack(losses, 1), "params": params,
            "stats": _stats(jgc)}


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd2")
    ref = _jax_trainer(tmp)
    return run_world("_gspmd_rank", tmp, size=2,
                     module="test_torch_gspmd_cache"), ref


def test_cached_trainer_is_bitwise_eager(trainer_world):
    """Every rank's losses and parameters under ``cached_step`` equal its
    eager run's bit for bit; one build, STEPS - 1 replays, one sync
    counted at the record."""
    res, _ = trainer_world
    for got in res:
        assert int(got["builds"]) == 1 and int(got["hits"]) == STEPS - 1
        assert int(got["passthrough"]) == 1
        np.testing.assert_array_equal(got["cached_losses"],
                                      got["eager_losses"])
        for k in got:
            if k.startswith("cached/"):
                np.testing.assert_array_equal(
                    got[k], got["eager/" + k[len("cached/"):]], err_msg=k)


def test_cached_trainer_matches_jax_cached_step(trainer_world):
    """The port's cached trainer against the JAX package's ``cached_step``
    over the same weights: losses rtol 1e-5, parameters rtol 1e-4 atol
    1e-6; the same plan accounting (one build, STEPS - 1 hits)."""
    from horovod_tpu_torch.models import from_flax_params
    res, ref = trainer_world
    assert ref["stats"]["builds"] == 1
    assert ref["stats"]["hits"] == STEPS - 1
    want = {k: v.numpy() for k, v in from_flax_params(
        _unflat({k: np.asarray(v) for k, v in _flat_params(
            ref["params"]).items()})).items()}
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["cached_losses"], ref["losses"][r],
                                   rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got[f"cached/{k}"], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
