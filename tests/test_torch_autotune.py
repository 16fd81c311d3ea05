"""The port's autotuner (``horovod_tpu_torch/autotune.py``,
``horovod_tpu_torch/optim/bayes.py``) against the JAX package's: from the
same scores and seed, the same proposals, the same decisions after every
sample, the same converged configuration, the same KV decision protocol;
and ``record`` at the collectives' call sites counts the same payload
bytes for the same allreduces (the port at a gloo world of one, the JAX
side on the 8-device CPU mesh: both count one rank's bytes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import horovod_tpu_torch as thvd
from horovod_tpu import autotune as jat
from horovod_tpu.optim import bayes as jbayes
from horovod_tpu.utils import envs as jenvs
from horovod_tpu_torch import autotune as tat
from horovod_tpu_torch.optim import bayes as tbayes
from horovod_tpu_torch.utils import envs as tenvs


@pytest.fixture(autouse=True)
def _clean():
    yield
    for e in (jenvs, tenvs):
        e.clear_overrides()
    jat.reset()
    tat.reset()


def _score_fn(seed: int):
    """A fixed random landscape over two knobs, with a noise draw a call
    from ``seed`` (the same sequence for both packages)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(4, 3)) * 10 + 100
    noise = np.random.default_rng(seed + 1)

    def score(cfg):
        return float(table[[1, 2, 4, 8].index(cfg["A"]),
                           [0, 1, 2].index(cfg["B"])]
                     + noise.normal() * 0.1)

    return score


def _drive(at, seed: int, strategy: str, monkeypatch) -> list:
    monkeypatch.setenv("HVD_AUTOTUNE_STRATEGY", strategy)
    tun = [at.Tunable("A", [1, 2, 4, 8]), at.Tunable("B", [0, 1, 2])]
    mgr = at.ParameterManager(tunables=tun, warmup_samples=1,
                              steps_per_sample=1, max_samples=14)
    score = _score_fn(seed)
    trace = []
    for _ in range(40):
        if mgr.converged:
            break
        mgr._end_sample(score(mgr.current_config()))
        trace.append((dict(mgr.current_config()), mgr.converged))
    return trace


@pytest.mark.parametrize("strategy", ["coordinate", "bayesian"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_equal_jax(monkeypatch, strategy, seed):
    want = _drive(jat, seed, strategy, monkeypatch)
    got = _drive(tat, seed, strategy, monkeypatch)
    assert got == want
    assert got[-1][1]


@pytest.mark.parametrize("seed", [0, 3])
def test_bayesian_proposals_equal_jax(seed):
    """``BayesianOptimization`` from the same samples and seed: the same
    proposal and expected improvement at every step."""
    rng = np.random.default_rng(seed)
    jb = jbayes.BayesianOptimization([(0.0, 3.0), (0.0, 2.0)], alpha=0.8,
                                     seed=seed)
    tb = tbayes.BayesianOptimization([(0.0, 3.0), (0.0, 2.0)], alpha=0.8,
                                     seed=seed)
    x = [1.0, 1.0]
    for _ in range(10):
        y = float(rng.normal())
        jb.add_sample(x, y)
        tb.add_sample(x, y)
        (jx, jei), (tx, tei) = jb.next_sample(), tb.next_sample()
        np.testing.assert_array_equal(tx, jx)
        assert tei == jei or (np.isinf(tei) and np.isinf(jei))
        x = list(tx)


def test_default_tunables_are_jax_minus_gspmd():
    """The port tunes the JAX package's knobs that have a consumer in it:
    all but ``GSPMD_CACHE``, with the same grids."""
    j = {t.knob: t.candidates for t in jat._default_tunables()}
    t = {t.knob: t.candidates for t in tat._default_tunables()}
    assert set(j) - set(t) == {"GSPMD_CACHE"}
    assert all(t[k] == j[k] for k in t)


def test_env_fixed_knob_untuned_like_jax(monkeypatch):
    monkeypatch.setenv("HVD_A", "2")
    assert tat.Tunable("A", [1, 2]).fixed == jat.Tunable("A", [1, 2]).fixed
    assert tat.Tunable("A", [1, 2]).fixed


def test_kv_score_sync_protocol_equals_jax():
    """Rank 0 decides from the mean score and publishes; a follower reads
    the decision: the same keys and payloads on both."""

    class FakeKV(dict):
        def put(self, k, v):
            self[k] = v

        def wait(self, k, timeout=0):
            return self[k]

        def delete(self, k):
            self.pop(k, None)

    outs = []
    for at in (jat, tat):
        kv = FakeKV()
        seen = {}

        def decide(score):
            seen["score"] = score
            return {"state": [1, 0], "converged": False}

        kv.put("autotune/score/0/1", b"3.0")
        d0 = at.KVScoreSync(kv, 2, 0)(0, 1.0, decide)
        d1 = at.KVScoreSync(kv, 2, 1)(0, 3.0, lambda s: pytest.fail("x"))
        outs.append((d0, d1, seen["score"], sorted(kv)))
    assert outs[1] == outs[0]


def test_record_counts_the_bytes_jax_counts(hvd, monkeypatch):
    """The same allreduces, through the plan and the fusion cycle: the
    managers' byte counts agree (one rank's payload on each)."""
    monkeypatch.setenv("HVD_AUTOTUNE", "1")
    monkeypatch.setenv("HVD_AUTOTUNE_STEPS_PER_SAMPLE", "1000")
    thvd.init(device="cpu")
    try:
        counts = []
        for at, hv, to in ((jat, hvd, jnp.asarray),
                           (tat, thvd, torch.from_numpy)):
            at.reset()
            mgr = at.get_manager()
            hv.allreduce(to(np.ones(6, np.float32)), op=hv.Sum)
            hv.grouped_allreduce([to(np.ones(3, np.float32)),
                                  to(np.ones(5, np.float32))], op=hv.Sum)
            counts.append((mgr._bytes, mgr._steps))
        assert counts[1] == counts[0]
    finally:
        thvd.shutdown()
        jenvs.clear_overrides()
        tenvs.clear_overrides()
