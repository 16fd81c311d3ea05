"""State and checkpoint of the port (``horovod_tpu_torch/checkpoint.py``,
``elastic/state.py``, ``elastic/sampler.py``, ``data/loader.py``) against the
JAX package's.

In this process, each against the JAX function on the same inputs:
``Checkpointer`` round trips, retention and one-shot saves (the same arrays
back as the JAX package's orbax checkpoints give); ``leaf_range``,
``make_restore_plan`` (its fields and ``transfers``), ``shard_digest`` of
the same pickled leaves and the shard verification verdicts, all equal;
the snapshot writer (round trip, interval, latest wins, a torn write, a
corrupt shard, stop); the peer transfers over an in-memory KV store with
threads for ranks (the same results and verdicts as the JAX package's
under the same schedule, faults and corruption); cross-reads of a step
sealed by either package's ``StatePlane``; ``run_fn`` with one injected
``HorovodInternalError`` over an ``ObjectState``; ``ElasticSampler``'s
indices over worlds 1-4; the two loaders. Every comparison is exact.

In gloo worlds of 2 and 4 (rank side :func:`_state_rank`, which imports no
JAX), with the port's ``KVServer``: ``TorchState`` commit and restore in
place, and ``sync()`` with the last rank needy (other weights, fewer
commits) pulling its shards from the survivors, bitwise, and again by
rank 0's broadcast with ``HVD_CKPT_PEER_RESTORE=0``.
"""

import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as jck
from horovod_tpu.data import loader as jloader
from horovod_tpu.elastic import sampler as jsampler
from horovod_tpu.elastic import state as jstate
from horovod_tpu.utils import faults as jfaults
from horovod_tpu_torch import checkpoint as tck
from horovod_tpu_torch.data import loader as tloader
from horovod_tpu_torch.elastic import sampler as tsampler
from horovod_tpu_torch.elastic import state as tstate
from horovod_tpu_torch.exceptions import HorovodInternalError
from horovod_tpu_torch.utils import faults as tfaults
from horovod_tpu_torch.utils.tree import flatten
from test_torch_world2 import run_world


@pytest.fixture
def fault_spec():
    """Install an HVD_FAULT_SPEC in both packages and always clear it."""
    def install(spec):
        os.environ["HVD_FAULT_SPEC"] = spec
        jfaults.refresh()
        tfaults.refresh()

    yield install
    os.environ.pop("HVD_FAULT_SPEC", None)
    jfaults.refresh()
    tfaults.refresh()


# ---------------------------------------------------------------------------
# Checkpointer (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _np_state(scale):
    return {"params": {"w": np.arange(16, dtype=np.float32).reshape(-1, 1)
                       * scale,
                       "b": np.full((3,), 2.0 * scale, np.float32)},
            "step": np.int32(int(scale))}


def _torch_state(scale):
    s = _np_state(scale)
    return {"params": {k: torch.from_numpy(v.copy())
                       for k, v in s["params"].items()},
            "step": torch.tensor(s["step"])}


def _jax_state(scale):
    return jax.tree.map(jnp.asarray, _np_state(scale))


def _equal_trees(got, want):
    gl, wl = flatten(got)[0], flatten(want)[0]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_checkpointer_round_trip_matches_jax(tmp_path):
    with jck.Checkpointer(str(tmp_path / "j")) as mgr:
        mgr.save(7, _jax_state(3.0), wait=True)
        jout = mgr.restore(target=_jax_state(0.0))
    with tck.Checkpointer(str(tmp_path / "t")) as mgr:
        mgr.save(7, _torch_state(3.0), wait=True)
        assert mgr.latest_step() == 7
        tout = mgr.restore(target=_torch_state(0.0))
    _equal_trees({k: jax.tree.map(np.asarray, v) for k, v in jout.items()},
                 tout)
    # the template's dtypes and devices
    assert tout["step"].dtype == torch.int32
    assert tout["params"]["w"].device.type == "cpu"


def test_checkpointer_retention_and_specific_step(tmp_path):
    got = {}
    for name, ck, lib in (("j", jck, jnp), ("t", tck, torch)):
        with ck.Checkpointer(str(tmp_path / name), max_to_keep=2) as mgr:
            for step in (1, 2, 3):
                mgr.save(step, {"x": lib.full((2,), float(step))},
                         wait=True)
            got[name] = (mgr.latest_step(), mgr.all_steps(),
                         np.asarray(mgr.restore()["x"]),
                         np.asarray(mgr.restore(step=2)["x"]))
    assert got["t"][:2] == got["j"][:2] == (3, [2, 3])
    np.testing.assert_array_equal(got["t"][2], got["j"][2])
    np.testing.assert_array_equal(got["t"][3], got["j"][3])


def test_restore_or_none_and_empty_dir(tmp_path):
    for ck, lib, d in ((jck, jnp, tmp_path / "j"), (tck, torch,
                                                     tmp_path / "t")):
        assert ck.restore_or_none(str(d / "missing")) is None
        ck.save(str(d / "ck2"), 0, {"y": lib.zeros((1,))})
        out = ck.restore_or_none(str(d / "ck2"))
        assert out is not None and "y" in out
        (d / "empty").mkdir()
        with ck.Checkpointer(str(d / "empty")) as mgr:
            with pytest.raises(FileNotFoundError):
                mgr.restore()


def test_elastic_resume_idiom(tmp_path):
    """Save at an epoch's end; a restarted job resumes if present."""
    tck.save(str(tmp_path / "run"), 4, _torch_state(5.0))
    resumed = tck.restore_or_none(str(tmp_path / "run"),
                                  target=_torch_state(0.0))
    assert int(resumed["step"]) == 5
    np.testing.assert_array_equal(resumed["params"]["b"].numpy(),
                                  np.full(3, 10.0, np.float32))


# ---------------------------------------------------------------------------
# the plan algebra (TestLeafRange, TestRestorePlan)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_leaf_range_matches_jax(n):
    for total in (0, 1, 7, 16, 37):
        ranges = [tck.leaf_range(i, n, total) for i in range(n)]
        assert ranges == [jck.leaf_range(i, n, total) for i in range(n)]
        assert ranges[0][0] == 0 and ranges[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def _blob(rank, commits, n_leaves=10, struct=7):
    return {"rank": rank, "commits": commits, "n_leaves": n_leaves,
            "struct": struct, "manifest": -1}


PLAN_CASES = {
    "all_agree": ([_blob(0, 5), _blob(1, 5), _blob(2, 5)], 3, None),
    "fresh": ([_blob(0, 0), _blob(1, 0)], 2, None),
    "joiner": ([_blob(0, 5), _blob(1, 5), _blob(2, 0)], 3, None),
    "quorum": ([_blob(0, 5), _blob(1, 0)], 2, 2),
    "split_brain": ([_blob(0, 5, struct=1), _blob(1, 5, struct=2)], 2,
                    None),
    "structure": ([_blob(0, 5), _blob(1, 5), _blob(2, 2, n_leaves=9)], 3,
                  None),
    "two_joiners": ([_blob(0, 5), _blob(1, 5), _blob(2, 0), _blob(3, 0)],
                    4, None),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_restore_plan_matches_jax(case):
    blobs, world, quorum = PLAN_CASES[case]
    kw = {} if quorum is None else {"quorum": quorum}
    tp = tck.make_restore_plan(blobs, world=world, **kw)
    jp = jck.make_restore_plan(blobs, world=world, **kw)
    for f in tp.__slots__:
        assert getattr(tp, f) == getattr(jp, f), f
    if tp.needy and tp.degraded_reason is None:
        assert tp.transfers(0) == jp.transfers(0)
        failed = [(d, k) for d in tp.needy
                  for k in range(len(tp.survivors))][::2]
        assert tp.transfers(1, failed) == jp.transfers(1, failed)


def test_transfer_schedule_and_failover():
    plan = tck.make_restore_plan(PLAN_CASES["two_joiners"][0], world=4)
    assert plan.transfers(0) == [(2, 0, 0, 0, 5), (2, 1, 1, 5, 10),
                                 (3, 0, 0, 0, 5), (3, 1, 1, 5, 10)]
    assert plan.transfers(1, [(2, 0), (3, 1)]) == [(2, 1, 0, 0, 5),
                                                   (3, 0, 1, 5, 10)]


# ---------------------------------------------------------------------------
# the snapshot writer (TestSnapshotPlane)
# ---------------------------------------------------------------------------

def _tree(v):
    return {"w": np.full((3, 2), float(v)),
            "opt": {"m": np.arange(4.0) * v, "count": np.int64(v)}}


class _FakeState:
    def __init__(self):
        self._commits = 0
        self._saved_state = {}

    def commit_tree(self, plane, v):
        self._commits += 1
        self._saved_state = _tree(v)
        plane.note_commit(self)


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _plane(ck, path, interval=1, rank=0, world=1):
    return ck.StatePlane(str(path), rank=rank, world=world,
                         interval=interval)


class TestSnapshotPlane:
    def test_snapshot_round_trip(self, tmp_path):
        plane = _plane(tck, tmp_path)
        st = _FakeState()
        try:
            st.commit_tree(plane, 1)
            assert _wait_for(lambda: plane.last_manifest_step == 1)
        finally:
            plane.stop()
        with open(tck.latest_path(str(tmp_path))) as f:
            assert int(f.read()) == 1
        _equal_trees(tck.restore_or_none(str(tmp_path), target=_tree(0)),
                     _tree(1))

    def test_interval_and_latest_wins(self, tmp_path):
        plane = _plane(tck, tmp_path, interval=2)
        st = _FakeState()
        try:
            for v in range(1, 7):
                st.commit_tree(plane, v)
            assert _wait_for(lambda: plane.last_manifest_step == 6)
        finally:
            plane.stop()
        steps = sorted(int(n.split("-")[1].split(".")[0])
                       for n in os.listdir(str(tmp_path))
                       if n.startswith("manifest-"))
        assert all(s % 2 == 0 for s in steps), steps
        _equal_trees(tck.sharded_restore_or_none(str(tmp_path),
                                                 target=_tree(0)), _tree(6))

    def test_torn_write_restores_previous_step(self, tmp_path, fault_spec):
        """A snapshot killed at ``ckpt.write`` (the second) leaves no
        manifest; the restore takes the previous complete step, never the
        torn one."""
        fault_spec("ckpt.write:error:after=1:times=1")
        plane = _plane(tck, tmp_path)
        st = _FakeState()
        try:
            st.commit_tree(plane, 1)
            assert _wait_for(lambda: plane.last_manifest_step == 1)
            st.commit_tree(plane, 2)  # this snapshot is killed
            assert plane.flush(20.0)
            st.commit_tree(plane, 3)
            assert _wait_for(lambda: plane.last_manifest_step == 3)
        finally:
            plane.stop()
        assert not os.path.exists(tck.manifest_path(str(tmp_path), 2))
        assert tck.sharded_restore_or_none(str(tmp_path), step=2,
                                           target=_tree(0)) is None
        _equal_trees(tck.restore_or_none(str(tmp_path), target=_tree(0)),
                     _tree(3))

    def test_corrupt_shard_falls_back_to_older_manifest(self, tmp_path):
        plane = _plane(tck, tmp_path)
        st = _FakeState()
        try:
            for v in (1, 2):
                st.commit_tree(plane, v)
                assert _wait_for(lambda: plane.last_manifest_step == v)
        finally:
            plane.stop()
        sdir = tck.step_dir(str(tmp_path), 2)
        shard = [n for n in os.listdir(sdir) if n.endswith(".bin")][0]
        with open(os.path.join(sdir, shard), "r+b") as f:
            f.write(b"\xff\xff\xff\xff")
        _equal_trees(tck.restore_or_none(str(tmp_path), target=_tree(0)),
                     _tree(1))

    def test_restore_or_none_empty_dir(self, tmp_path):
        assert tck.restore_or_none(str(tmp_path)) is None
        assert tck.restore_or_none(str(tmp_path / "never-created")) is None

    def test_stop_is_idempotent_and_joins(self, tmp_path):
        plane = _plane(tck, tmp_path)
        st = _FakeState()
        st.commit_tree(plane, 1)
        plane.stop()
        plane.stop()
        st.commit_tree(plane, 2)  # a commit after stop is dropped
        assert plane._thread is None


def test_shard_digest_of_the_same_leaves_matches_jax():
    leaves = flatten(_tree(2))[0]
    assert [repr(type(x)) for x in leaves] == [
        repr(type(x)) for x in jax.tree_util.tree_leaves(_tree(2))]
    data = pickle.dumps(leaves, protocol=pickle.HIGHEST_PROTOCOL)
    jdata = pickle.dumps(jax.tree_util.tree_leaves(_tree(2)),
                         protocol=pickle.HIGHEST_PROTOCOL)
    assert data == jdata
    assert tck.shard_digest(data) == jck.shard_digest(jdata)


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_cross_read_of_a_sealed_step(tmp_path, sealer):
    """A step sealed by one package's ``StatePlane`` restores in the
    other's ``sharded_restore_or_none`` to equal arrays (float32 leaves;
    two ranks' shards)."""
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.linspace(-1, 1, 5).astype(np.float32),
            "opt": {"m": np.full((2, 2), 0.5, np.float32), "count": 3}}
    ck_w, ck_r = (jck, tck) if sealer == "jax" else (tck, jck)
    planes = [_plane(ck_w, tmp_path, rank=r, world=2) for r in (1, 0)]
    try:
        for plane in planes:
            st = _FakeState()
            st._commits, st._saved_state = 1, tree
            plane.note_commit(st)
        assert _wait_for(lambda: planes[1].last_manifest_step == 1)
    finally:
        for plane in planes:
            plane.stop()
    template = {"w": np.zeros((3, 4), np.float32),
                "b": np.zeros(5, np.float32),
                "opt": {"m": np.zeros((2, 2), np.float32), "count": 0}}
    got = ck_r.sharded_restore_or_none(str(tmp_path), target=template)
    _equal_trees(got, tree)
    if sealer == "jax":  # the port puts array leaves on a tensor template
        got = tck.sharded_restore_or_none(
            str(tmp_path), target=tck.tensor_tree(template))
        assert isinstance(got["w"], torch.Tensor)
        _equal_trees(got, tree)


def test_bfloat16_leaves_round_trip(tmp_path):
    """numpy has no bfloat16: a bf16 tensor is kept as its uint16 bits,
    tagged by the dtype, one leaf, and comes back bit for bit."""
    x = torch.randn(5, 3).bfloat16()
    host = tck.to_host(x)
    assert host.dtype == tck.BF16_DTYPE and host.shape == (5, 3)
    assert host.view(np.uint16).dtype == np.uint16
    back = tck.from_host(host)
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    plane = _plane(tck, tmp_path)
    st = _FakeState()
    st._commits, st._saved_state = 1, {"x": host, "n": 2}
    try:
        plane.note_commit(st)
        assert _wait_for(lambda: plane.last_manifest_step == 1)
    finally:
        plane.stop()
    got = tck.sharded_restore_or_none(
        str(tmp_path), target={"x": torch.zeros(5, 3, dtype=torch.bfloat16),
                               "n": 0})
    assert torch.equal(got["x"], x) and got["n"] == 2


# ---------------------------------------------------------------------------
# peer transfers over a KV store (TestPeerTransfersKV, TestShardVerification)
# ---------------------------------------------------------------------------

class _MemKV:
    """An in-memory stand-in of the KV client (put, wait, delete)."""

    def __init__(self):
        self.cv = threading.Condition()
        self.store = {}

    def put(self, key, value):
        with self.cv:
            self.store[key] = value
            self.cv.notify_all()

    def wait(self, key, timeout=60.0, poll_interval=0.1):
        end = time.monotonic() + min(timeout, 10.0)
        with self.cv:
            while key not in self.store:
                if time.monotonic() > end:
                    raise TimeoutError(key)
                self.cv.wait(0.05)
            return self.store[key]

    def delete(self, key):
        with self.cv:
            self.store.pop(key, None)


def _run_world_transfers(ck, plan, trees, monkeypatch):
    """Every rank's side of ``ck.run_peer_transfers`` on a thread of its
    own, with a lockstep allgather and the in-memory KV store; returns
    ``{rank: (new_leaves, reason)}``."""
    kv = _MemKV()
    monkeypatch.setattr(ck, "_kv_client", lambda: kv)
    n = plan.world
    cv, calls, vals = threading.Condition(), {}, {}

    def allgather(obj):
        with cv:
            me = threading.current_thread().name
            rnd = calls.get(me, 0)
            calls[me] = rnd + 1
            vals.setdefault(rnd, {})[me] = obj
            cv.notify_all()
            end = time.monotonic() + 15.0
            while len(vals[rnd]) < n:
                if time.monotonic() > end:
                    raise TimeoutError("allgather barrier")
                cv.wait(0.05)
            return [vals[rnd][k] for k in sorted(vals[rnd])]

    out = {}

    def one(rank):
        out[rank] = ck.run_peer_transfers(plan, rank, flatten(trees[rank])[0],
                                          allgather=allgather)

    ts = [threading.Thread(target=one, args=(r,), name=f"r{r:02d}",
                           daemon=True) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive(), "transfer thread hung"
    return out


def _blob_t(rank, commits):
    leaves, treedef = flatten(_tree(0))
    return {"rank": rank, "commits": commits, "n_leaves": len(leaves),
            "struct": tck.structure_digest(leaves, treedef),
            "manifest": -1}


def _corrupt_once(tag, payload):
    step, d, owner, lo, hi, attempt = tag
    return b"\x00" + payload[1:] if owner == 0 and attempt == 0 else payload


TRANSFER_CASES = {
    # (commits of each rank, the corruption hook, the fault spec)
    "two_joiners": ((5, 5, 0, 0), None, None),
    "digest_mismatch_repulled": ((5, 5, 0), _corrupt_once, None),
    "unrecoverable": ((5, 5, 0), lambda tag, p: b"\x00" + p[1:], None),
    "shard_pull_fault": ((5, 5, 0), None,
                         "ckpt.shard_pull:error:rank=0:times=1"),
}


@pytest.mark.parametrize("case", sorted(TRANSFER_CASES))
def test_peer_transfers_match_jax(case, monkeypatch, fault_spec):
    commits, hook, spec = TRANSFER_CASES[case]
    results = {}
    for name, ck in (("jax", jck), ("port", tck)):
        if spec is not None:
            fault_spec(spec)
        plan = tck.make_restore_plan(
            [_blob_t(r, c) for r, c in enumerate(commits)],
            world=len(commits))
        jplan = ck.RestorePlan(plan.step, plan.world, plan.n_leaves,
                               plan.survivors, plan.needy, plan.fresh,
                               plan.degraded_reason)
        trees = {r: _tree(9 if c else 0) for r, c in enumerate(commits)}
        monkeypatch.setattr(ck, "_corrupt_shard_hook", hook)
        results[name] = _run_world_transfers(ck, jplan, trees, monkeypatch)
    want = flatten(_tree(9))[0]
    for r in range(len(commits)):
        got, reason = results["port"][r]
        assert reason == results["jax"][r][1], (r, reason)
        if got is None:
            assert results["jax"][r][0] is None
            continue
        assert reason is None
        for x, y, z in zip(got, want, results["jax"][r][0]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            np.testing.assert_array_equal(np.asarray(x), np.asarray(z))


def _payload(leaves):
    data = pickle.dumps(leaves, protocol=pickle.HIGHEST_PROTOCOL)
    return ("ok", tck.shard_digest(data), data)


VERIFY_CASES = {
    "matching": lambda leaves: _payload(leaves[0:2]),
    "digest": lambda leaves: ("ok", _payload(leaves[0:2])[1] ^ 1,
                              _payload(leaves[0:2])[2]),
    "refused": lambda leaves: ("err", "boom"),
    "shape": lambda leaves: _payload([np.zeros((9, 9)), np.zeros((9, 9))]),
    "count": lambda leaves: _payload(leaves[0:1]),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_shard_verification_verdicts_match_jax(case):
    leaves = flatten(_tree(2))[0]
    envelope = VERIFY_CASES[case](leaves)
    verdicts = []
    for ck in (jck, tck):
        try:
            verdicts.append(("ok", len(ck._verify_shard(envelope, leaves,
                                                        0, 2))))
        except ValueError as e:  # _ShardRejected, in each package
            verdicts.append(("rejected", type(e).__name__,
                             str(e).split(":")[0]))
    assert verdicts[0] == verdicts[1]
    assert (verdicts[1][0] == "ok") == (case == "matching")


# ---------------------------------------------------------------------------
# run_fn, the sampler, the loaders
# ---------------------------------------------------------------------------

def _elastic_script(state_mod, exc_type):
    """``run_fn`` over an ``ObjectState`` that fails once, mid-epoch, with
    an injected ``HorovodInternalError``: the restores, the resets and the
    final values."""
    counts = {"restores": 0, "resets": 0, "calls": 0}
    failed = []

    class Counting(state_mod.ObjectState):
        def restore(self):
            counts["restores"] += 1
            super().restore()

    state = Counting(bcast_object=lambda obj: obj, get_rank=lambda: 0,
                     epoch=0, batch=0, total=0)

    def train(st):
        counts["calls"] += 1
        for st.epoch in range(st.epoch, 3):
            for st.batch in range(st.batch, 4):
                st.total += st.epoch * 10 + st.batch
                if (st.epoch, st.batch) == (1, 2) and not failed:
                    failed.append(1)
                    raise exc_type("injected collective failure")
                st.commit()
            st.batch = 0
        return st.total

    def reset():
        counts["resets"] += 1

    result = state_mod.run_fn(train, reset)(state)
    return result, counts, (state.epoch, state.batch, state.total)


def test_run_fn_recovers_as_jax():
    from horovod_tpu.exceptions import HorovodInternalError as JError
    jres = _elastic_script(jstate, JError)
    tres = _elastic_script(tstate, HorovodInternalError)
    assert tres == jres
    assert tres[1]["restores"] == 1 and tres[1]["resets"] == 1


class _FakeRuntime:
    def __init__(self, rank, size):
        self._rank, self._size = rank, size

    def is_initialized(self):
        return True

    def rank(self):
        return self._rank

    def size(self):
        return self._size

    process_rank = rank
    process_count = size


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_elastic_sampler_indices_match_jax(world, monkeypatch):
    """Two epochs over 23 samples (shuffled and not), a mid-epoch
    ``record_batch``, and the state carried into a world of another
    size: every rank's indices equal the JAX sampler's."""
    for shuffle in (True, False):
        seq = {}
        for name, mod in (("jax", jsampler), ("port", tsampler)):
            rows = []
            for rank in range(world):
                monkeypatch.setattr(mod, "runtime",
                                    _FakeRuntime(rank, world))
                s = mod.ElasticSampler(23, shuffle=shuffle, seed=4)
                rows.append(list(s))
                s.record_batch(2)
                rows.append(s.local_indices())
                state = s.state_dict()
                monkeypatch.setattr(mod, "runtime",
                                    _FakeRuntime(0, world % 4 + 1))
                s.load_state_dict(state)
                rows.append((len(s), s.local_indices()))
                s.set_epoch(1)
                rows.append(list(s))
            seq[name] = rows
        assert seq["port"] == seq["jax"]


def _loaders(mod, fail_at=None):
    class Numbers(mod.BaseDataLoader):
        def __len__(self):
            return 5

        def _iterate(self):
            for i in range(5):
                if i == fail_at:
                    raise RuntimeError("producer failed")
                yield np.full(3, i)

        def _process_batch(self, batch):
            return batch * 2

    class AsyncNumbers(mod.AsyncDataLoaderMixin, Numbers):
        pass

    return Numbers, AsyncNumbers


@pytest.mark.parametrize("queue", [0, 2])
def test_loaders_match_jax(queue):
    got = {}
    for name, mod in (("jax", jloader), ("port", tloader)):
        plain, async_ = _loaders(mod)
        got[name] = ([b.tolist() for b in plain()],
                     [b.tolist() for b in async_(
                         async_loader_queue_size=queue)])
        _, failing = _loaders(mod, fail_at=3)
        loader = failing(async_loader_queue_size=queue)
        seen = []
        with pytest.raises(RuntimeError, match="producer failed"):
            for b in loader:
                seen.append(b.tolist())
        got[name] += (seen,)
        assert loader._thread is None  # closed after the error
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][1] == [[2 * i] * 3
                                                for i in range(5)]


# ---------------------------------------------------------------------------
# TorchState in gloo worlds of 2 and 4
# ---------------------------------------------------------------------------

STATE_STEPS = 3


def _make(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 4))
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    return model, opt


def _train_step(model, opt, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(5, 6, generator=g)
    opt.zero_grad(set_to_none=False)
    (model(x) ** 2).mean().backward()
    opt.step()


def _become_joiner(state, model, opt, sampler) -> None:
    """Make this rank a fresh joiner in place: other weights, one step of
    other data, no progress, one commit of its own (commits are
    collective, so every rank made the same ones before)."""
    g = torch.Generator().manual_seed(100)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    _train_step(model, opt, 123)
    sampler.set_epoch(0)
    state.epoch = 0
    state.save()
    state._commits = 1


def _state_rank(out_path: str) -> None:
    """One rank: ``TorchState`` commit, in-place restore, and ``sync()``
    with the last rank needy."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        r, n = hvd.rank(), hvd.size()
        sampler = hvd.elastic.ElasticSampler(40, seed=1)
        model, opt = _make(0)
        state = hvd.elastic.TorchState(model=model, optimizer=opt,
                                       sampler=sampler, epoch=0)
        ptrs = [p.data_ptr() for p in model.parameters()]
        for i in range(STATE_STEPS):
            _train_step(model, opt, 7 + i)
            sampler.record_batch(2)
            state.epoch = i + 1
            state.commit()
        committed = [p.detach().clone() for p in model.parameters()]
        out = {}
        # an uncommitted step, then restore: in place, to the commit
        _train_step(model, opt, 99)
        state.restore()
        out["restore_equal"] = all(torch.equal(a, b) for a, b in
                                   zip(model.parameters(), committed))
        out["restore_in_place"] = ptrs == [p.data_ptr()
                                           for p in model.parameters()]
        # the peer restore (the default), then rank 0's broadcast
        for mode in ("peer", "broadcast"):
            os.environ["HVD_CKPT_PEER_RESTORE"] = ("1" if mode == "peer"
                                                   else "0")
            if r == n - 1:
                _become_joiner(state, model, opt, sampler)
            state.sync()
            out[f"{mode}_epoch"] = state.epoch
            out[f"{mode}_commits"] = state._commits
            out[f"{mode}_sampler"] = sampler.processed_num
            out[f"{mode}_in_place"] = ptrs == [p.data_ptr()
                                               for p in model.parameters()]
            for i, p in enumerate(model.parameters()):
                out[f"{mode}_p{i}"] = p.detach().numpy().copy()
                for k, v in opt.state[p].items():
                    out[f"{mode}_s{i}_{k}"] = v.numpy().copy()
        snap = hvd.metrics.snapshot()
        out["pulled"] = sum(v for (name, _), v in snap.items()
                            if name == "hvd_ckpt_peer_shards_pulled_total")
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def state_world(request, tmp_path_factory):
    n = request.param
    return n, run_world("_state_rank",
                        tmp_path_factory.mktemp(f"state{n}"), size=n,
                        module="test_torch_checkpoint", kv=True,
                        env={"HVD_DYNAMIC_ENGINE": "0"})


def test_torch_state_restores_in_place(state_world):
    _, res = state_world
    for got in res:
        assert bool(got["restore_equal"]) and bool(got["restore_in_place"])


@pytest.mark.parametrize("mode", ["peer", "broadcast"])
def test_torch_state_sync_is_bitwise(state_world, mode):
    """After ``sync()`` every rank holds rank 0's committed parameters,
    Adam state, sampler progress and plain attributes bit for bit, in the
    same tensors; the needy rank pulled one shard from each survivor in
    the peer restore."""
    n, res = state_world
    for r, got in enumerate(res):
        assert int(got[f"{mode}_epoch"]) == STATE_STEPS
        if mode == "peer":  # the broadcast path leaves the count, as JAX's
            assert int(got[f"{mode}_commits"]) == STATE_STEPS
        assert int(got[f"{mode}_sampler"]) == int(res[0][f"{mode}_sampler"])
        assert bool(got[f"{mode}_in_place"])
        keys = [k for k in got if k.startswith(f"{mode}_p")
                or k.startswith(f"{mode}_s")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(got[k], res[0][k], err_msg=k)
    assert int(res[-1]["pulled"]) == n - 1
    assert all(int(got["pulled"]) == 0 for got in res[:-1])
