"""The port's QoS engine (``horovod_tpu_torch/qos.py``) against the JAX
package's: the class grammar, the admission gate's grant order and the
scheduler's admission decisions, from the same streams.

* The ``HVD_QOS_CLASSES`` grammar and ``set_qos``: the same classes from
  the same specs, the same refusals of bad ones.
* The gate alone: both packages' ``QosGate`` fed the same stream of
  batches (tenants, tiers, weights, sizes, negotiated or not, made from a
  numpy seed) with the same knobs grant in the same order (their
  ``grant_history``), with the same per-tenant stats.
* The scheduler: at the JAX package's single controller and at the
  port's world of one, the same submissions to a tenant with a ``shed``
  quota are shed (``QosAdmissionError``) or admitted alike, and the
  ``qos`` block of ``fusion_stats()`` agrees.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import horovod_tpu_torch as thvd
from horovod_tpu import qos as jqos
from horovod_tpu.exceptions import QosAdmissionError as JQosError
from horovod_tpu.ops import fusion_cycle as jfc
from horovod_tpu.utils import invariants as jinv
from horovod_tpu_torch import qos as tqos
from horovod_tpu_torch.exceptions import QosAdmissionError as TQosError
from horovod_tpu_torch.ops import fusion_cycle as tfc
from horovod_tpu_torch.utils import invariants as tinv


@pytest.fixture(scope="module")
def torch_world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("HVD_CYCLE_TIME", "2000")
    monkeypatch.setenv("HVD_PENDING_CYCLE_TIME", "2000")
    for m in (jqos, tqos, jfc, tfc):
        m.reset()
    yield
    for m in (jqos, tqos, jfc, tfc):
        m.reset()


# -- the class grammar -------------------------------------------------------

SPECS = [
    "A:priority=2,weight=3;B:quota=1000,policy=shed",
    " lat : priority=5 ; bulk:weight=0.5,quota=64 ",
    "x:weight=2",
]
BAD = ["A:priority", ":weight=1", "A:speed=3", "A:policy=drop",
       "A:weight=0"]


@pytest.mark.parametrize("spec", SPECS)
def test_classes_from_the_environment_equal_jax(monkeypatch, spec):
    monkeypatch.setenv("HVD_QOS_CLASSES", spec)
    assert tqos.classes() == jqos.classes()
    for label in ("A", "B", "lat", "bulk", "x", "other"):
        assert repr(tqos.get_class(label)) == repr(jqos.get_class(label))


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_refused_like_jax(monkeypatch, spec):
    monkeypatch.setenv("HVD_QOS_CLASSES", spec)
    with pytest.raises(ValueError) as jerr:
        jqos.get_class("A")
    with pytest.raises(ValueError) as terr:
        tqos.get_class("A")
    assert str(terr.value) == str(jerr.value)


def test_set_qos_merges_like_jax(hvd):
    for m, ps in ((jqos, None), (tqos, None)):
        m.set_qos(ps, priority=2, weight=3.0)
        m.set_qos(ps, pending_bytes_quota=512, policy="shed")
    assert tqos.classes() == jqos.classes()
    assert tqos.tenant_label(None) == jqos.tenant_label(None) == "global"


# -- the gate alone ----------------------------------------------------------

class _Spec:
    def __init__(self, negotiated):
        self.svc = object() if negotiated else None
        self.single = not negotiated


class _Ent:
    def __init__(self, nbytes, name):
        self.nbytes = nbytes
        self.names = (name,)
        self.qos_tenant = None
        self.qos_inflight = False


class _Batch:
    def __init__(self, nbytes, name, negotiated):
        self.spec = _Spec(negotiated)
        self.entries = [_Ent(nbytes, name)]


def gate_stream(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    return [(f"t{int(rng.integers(4))}", int(rng.integers(1, 9)) * 100,
             bool(rng.random() < 0.5), str(rng.choice(
                 ["none", "none", "release", "pull"])))
            for _ in range(n)]


def run_gate(m, inv, stream):
    emitted = []
    gate = m.QosGate(inv.make_condition("test.qos.gate"),
                     lambda b: emitted.append(b.entries[0].names[0]))
    for i, (tenant, nbytes, negotiated, act) in enumerate(stream):
        batch = _Batch(nbytes, f"n{i}", negotiated)
        gate.submit(batch, tenant, m.get_class(tenant))
        if act == "release":
            gate.release_entry(batch.entries[0])
        elif act == "pull":
            with gate._cv:
                gate.demand_pull_locked()
    gate.release_all()
    with gate._cv:
        stats = gate.stats_locked()
    return list(gate.grant_history), emitted, stats


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gate_grant_order_equals_jax(monkeypatch, seed):
    """Tiers, weights, the window, the quantum and the starvation valve:
    the same grants in the same order."""
    monkeypatch.setenv("HVD_QOS", "1")
    monkeypatch.setenv("HVD_QOS_WINDOW", str(2 + seed))
    monkeypatch.setenv("HVD_QOS_QUANTUM", "300")
    monkeypatch.setenv("HVD_QOS_STARVE_LIMIT", str(4 * seed))
    for m in (jqos, tqos):
        m.configure_label("t0", priority=1, weight=3.0)
        m.configure_label("t1", weight=2.0)
        m.configure_label("t3", priority=1)
    stream = gate_stream(seed)
    want = run_gate(jqos, jinv, stream)
    got = run_gate(tqos, tinv, stream)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


# -- the scheduler's admission decisions -------------------------------------

def _admissions(hvd, to, err, sizes):
    """Submit one async allreduce a size; which ones were shed."""
    shed, handles = [], []
    for n in sizes:
        handles.append(hvd.allreduce_async(to(np.ones(n, np.float32)),
                                           op=hvd.Sum))
    for h in handles:
        try:
            hvd.synchronize(h)
            shed.append(False)
        except err:
            shed.append(True)
    return shed


@pytest.mark.parametrize("seed", [0, 1])
def test_shed_decisions_equal_jax(hvd, torch_world1, monkeypatch, seed):
    """A ``shed`` quota on the global tenant: the same submissions are
    shed (their handles raise ``QosAdmissionError``) and the shed count in
    ``fusion_stats()["qos"]`` agrees."""
    monkeypatch.setenv("HVD_QOS", "1")
    sizes = [int(s) for s in np.random.default_rng(seed).integers(
        8, 200, size=12)]
    got = []
    for m, hv, to, err, fc in ((jqos, hvd, jnp.asarray, JQosError, jfc),
                               (tqos, thvd, torch.from_numpy, TQosError,
                                tfc)):
        m.set_qos(None, pending_bytes_quota=1200, policy="shed")
        shed = _admissions(hv, to, err, sizes)
        q = fc.scheduler().stats()["qos"]
        got.append((shed, q["shed"], q["quota_blocks"]))
    assert got[1] == got[0]
    assert any(got[1][0])


def test_results_equal_with_qos_on_and_off(torch_world1, monkeypatch):
    xs = [np.full(k, k, np.float32) for k in (3, 5, 7)]

    def run():
        hs = [thvd.allreduce_async(torch.from_numpy(x), op=thvd.Average)
              for x in xs]
        return [h.synchronize().numpy() for h in hs]

    off = run()
    monkeypatch.setenv("HVD_QOS", "1")
    tfc.reset()
    on = run()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert thvd.qos_stats()["enabled"]
    assert set(thvd.qos_stats()) >= {"window", "quantum_bytes",
                                     "starve_limit", "classes"}
