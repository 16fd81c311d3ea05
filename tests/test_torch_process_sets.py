"""The port's process sets against the JAX package's.

The table (ids, the sorted free-list, the dedup of identical rank lists, id
0, the dynamic gate) runs in this process over a world of 8 with a stand-in
for ``dist.new_group``, beside the reference's table on the conftest's
8-device CPU mesh. The collectives run in spawned gloo worlds (started once
each for the module by :func:`test_torch_world2.run_world`): the sets
[0, 2], [1, 2, 3], [0, 1] and [2, 3] of a world of 4, and [0, 1] of a
world of 3. Their ranks run :func:`_process_sets_rank`, which imports no
JAX; every member passes its own seeded input, and the reference takes the
members' inputs as a ``per_rank`` bundle on a JAX process set of the same
global ranks. Inputs are integer-valued float32 or int32, so that every
result is exact and compared bitwise, except the AVERAGE over the set of
three, which divides by 3 (rtol 1e-6).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_world2 import A2AV_ROWS, a2av_splits, run_world

# The sets of each world: the first registered by init(process_sets=...),
# the rest by add_process_set. In the world of 4, [0, 1] and [2, 3] reduce
# at the same time, after [0, 2] and [1, 2, 3].
PSETS = {4: ([0, 2], [1, 2, 3], [0, 1], [2, 3]), 3: ([0, 1],)}
AG_ROWS = (2, 0, 3)  # the ragged allgather's rows of the i-th member


def pset_inputs(n: int, s: int) -> dict:
    """The inputs of set ``s`` of the world of ``n``: per-member lists."""
    k = len(PSETS[n][s])
    rng = np.random.default_rng(200 + 10 * n + s)
    ints = lambda shape, dt=np.float32, lo=-50, hi=50: rng.integers(
        lo, hi, size=shape).astype(dt)
    return {"x": [ints((4, 3)) for _ in range(k)],
            "xi": [ints((5,), np.int32) for _ in range(k)],
            "small": [ints((3,), lo=-4, hi=5) for _ in range(k)],
            "ag": [ints((AG_ROWS[i], 2)) for i in range(k)],
            "a2a": [ints((2 * k, 3)) for _ in range(k)],
            "a2av": [ints((A2AV_ROWS, 2)) for _ in range(k)],
            "rs": [ints((2 * k, 3)) for _ in range(k)],
            "p": [ints((2, 2)) for _ in range(k)],
            "pi": [ints((3,), np.int32) for _ in range(k)]}


# Each allreduce case over a set: (input, op).
ALLREDUCES = {"sum": ("x", "Sum"), "avg": ("x", "Average"),
              "min": ("x", "Min"), "max": ("x", "Max"),
              "prod": ("small", "Product"), "int": ("xi", "Sum")}


def _raised(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _process_sets_rank(out_path: str, device: str | None = "cpu") -> None:
    """One rank: register the world's sets (the first through ``init``, the
    others through ``add_process_set``), run every collective over each set
    it is a member of, and record a non-member's error; on ``device`` (gloo
    on the CPU; None: NCCL, one card a rank)."""
    import horovod_tpu_torch as hvd

    os.environ["HVD_DYNAMIC_PROCESS_SETS"] = "1"
    n = int(os.environ["WORLD_SIZE"])
    hvd.init(device=device, process_sets=[PSETS[n][0]])
    try:
        rank, dev = hvd.rank(), hvd.device()
        sets = [hvd.runtime.process_set_table().find(PSETS[n][0])]
        sets += [hvd.add_process_set(r) for r in PSETS[n][1:]]
        out = {"ids": np.asarray([ps.process_set_id for ps in sets])}
        for s, ps in enumerate(sets):
            pre = f"s{s}_"
            if not ps.included():
                out[pre + "err"] = _raised(lambda: hvd.allreduce(
                    torch.ones(2, device=dev), process_set=ps))
                continue
            me = ps.rank()
            inp = {k: torch.as_tensor(v[me]).to(dev)
                   for k, v in pset_inputs(n, s).items()}
            root = ps.ranks[-1]
            res = {f"ar_{key}": hvd.allreduce(inp[src], op=getattr(hvd, op),
                                              process_set=ps)
                   for key, (src, op) in ALLREDUCES.items()}
            res["grouped"] = torch.cat([t.float().ravel() for t in (
                hvd.grouped_allreduce([inp["x"], inp["xi"]], op=hvd.Sum,
                                      process_set=ps))])
            res["grouped_async"] = hvd.grouped_allreduce_async(
                [inp["x"]], op=hvd.Average, process_set=ps).synchronize()[0]
            res["bcast"] = hvd.broadcast(inp["x"], root, process_set=ps)
            res["bcast_async"] = hvd.broadcast_async(
                inp["xi"], root, process_set=ps).synchronize()
            res["grouped_bcast"] = hvd.grouped_broadcast(
                [inp["a2a"]], root, process_set=ps)[0]
            res["ag"] = hvd.allgather(inp["ag"], process_set=ps)
            res["ag_async"] = hvd.allgather_async(
                inp["ag"], process_set=ps).synchronize()
            res["a2a"] = hvd.alltoall(inp["a2a"], process_set=ps)
            res["a2av"], res["a2av_recv"] = hvd.alltoall(
                inp["a2av"], splits=a2av_splits(ps.size())[me],
                process_set=ps)
            res["rs_sum"] = hvd.reducescatter(inp["rs"], process_set=ps)
            res["rs_avg"] = hvd.reducescatter(inp["rs"], op=hvd.Average,
                                              process_set=ps)
            params = {"p": inp["p"].clone(), "pi": inp["pi"].clone()}
            hvd.broadcast_parameters(params, root, process_set=ps)
            res.update(bparams_p=params["p"], bparams_pi=params["pi"])
            w = torch.nn.Parameter(torch.zeros_like(inp["p"]))
            sgd = torch.optim.SGD([w], lr=1.0, momentum=0.5)
            w.grad = inp["p"].clone()
            sgd.step()  # the momentum buffer is this member's gradient
            hvd.broadcast_optimizer_state(sgd, root, process_set=ps)
            res["bopt"] = sgd.state[w]["momentum_buffer"]
            hvd.barrier(process_set=ps)
            out.update({pre + k: v.cpu().numpy() for k, v in res.items()})
            out[pre + "err_root"] = _raised(lambda: hvd.broadcast(
                inp["x"], [r for r in range(n) if r not in ps.ranks][0],
                process_set=ps))
            out[pre + "objects"] = repr(hvd.allgather_object(
                (rank, s), process_set=ps))
        # the freed id comes back to the next set registered
        hvd.remove_process_set(sets[-1])
        out["readded_id"] = np.asarray(
            hvd.add_process_set(PSETS[n][-1]).process_set_id)
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


def _process_sets_rank_on_card(out_path: str) -> None:
    _process_sets_rank(out_path, device=None)


@pytest.fixture(scope="module", params=[4, 3], ids=["world4", "world3"])
def world(request, tmp_path_factory):
    """``(n, per-rank results)`` of one gloo world of n ranks."""
    n = request.param
    return n, run_world("_process_sets_rank",
                        tmp_path_factory.mktemp(f"psets{n}"), size=n,
                        module="test_torch_process_sets")


def _members(n):
    return [(s, ranks) for s, ranks in enumerate(PSETS[n])]


@pytest.fixture
def jax_sets(hvd, world):
    """The reference's process sets of the world's rank lists."""
    sets = [hvd.add_process_set(ranks) for ranks in PSETS[world[0]]]
    yield sets
    for ps in sets:
        hvd.remove_process_set(ps)


def _bundle(hvd, ps, n, s, key):
    return hvd.per_rank([np.asarray(x) for x in pset_inputs(n, s)[key]], ps)


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ids_and_registration(world):
    """The first set takes id 1 at init, the others the next ids; a removed
    set's id goes to the next set registered."""
    n, ranks = world
    for res in ranks:
        assert res["ids"].tolist() == list(range(1, len(PSETS[n]) + 1))
        assert int(res["readded_id"]) == len(PSETS[n])


@pytest.mark.parametrize("key", list(ALLREDUCES))
def test_allreduce_over_a_set_matches_jax(hvd, world, jax_sets, key):
    """SUM, AVERAGE (over the set's size), MIN, MAX, PRODUCT and int32 SUM
    over each set: bitwise, but AVERAGE over three members (rtol 1e-6)."""
    n, ranks = world
    src, op = ALLREDUCES[key]
    for s, members in _members(n):
        want = np.asarray(hvd.allreduce(_bundle(hvd, jax_sets[s], n, s, src),
                                        op=getattr(hvd, op),
                                        process_set=jax_sets[s]))
        for r in members:
            got = ranks[r][f"s{s}_ar_{key}"]
            if key == "avg" and len(members) == 3:
                assert got.dtype == want.dtype
                np.testing.assert_allclose(got, want, rtol=1e-6)
            else:
                _same(got, want)


def test_average_over_three_divides_by_three(world):
    n, ranks = world
    for s, members in _members(n):
        total = sum(pset_inputs(n, s)["x"])
        for r in members:
            np.testing.assert_allclose(ranks[r][f"s{s}_ar_avg"],
                                       total / len(members), rtol=1e-6)


def test_grouped_allreduce_over_a_set_matches_jax(hvd, world, jax_sets):
    n, ranks = world
    for s, members in _members(n):
        ps = jax_sets[s]
        x, xi = (_bundle(hvd, ps, n, s, k) for k in ("x", "xi"))
        want = hvd.grouped_allreduce([x, xi], op=hvd.Sum, process_set=ps)
        want = np.concatenate([np.asarray(w, np.float32).ravel()
                               for w in want])
        want_avg = np.asarray(hvd.grouped_allreduce(
            [x], op=hvd.Average, process_set=ps)[0])
        for r in members:
            _same(ranks[r][f"s{s}_grouped"], want)
            got = ranks[r][f"s{s}_grouped_async"]
            np.testing.assert_allclose(got, want_avg, rtol=1e-6)
            if len(members) != 3:
                _same(got, want_avg)


@pytest.mark.parametrize("key,src", [("bcast", "x"), ("bcast_async", "xi"),
                                     ("grouped_bcast", "a2a")])
def test_broadcast_over_a_set_matches_jax(hvd, world, jax_sets, key, src):
    """The root is the set's last member, a global rank."""
    n, ranks = world
    for s, members in _members(n):
        ps = jax_sets[s]
        want = hvd.broadcast(_bundle(hvd, ps, n, s, src), members[-1],
                             process_set=ps)
        for r in members:
            _same(ranks[r][f"s{s}_{key}"], want)


def test_broadcast_parameters_over_a_set_matches_jax(hvd, world, jax_sets):
    n, ranks = world
    for s, members in _members(n):
        ps = jax_sets[s]
        want = hvd.broadcast_parameters(
            {k: _bundle(hvd, ps, n, s, k) for k in ("p", "pi")}, members[-1],
            process_set=ps)
        for r in members:
            for k in ("p", "pi"):
                _same(ranks[r][f"s{s}_bparams_{k}"], want[k])


def test_broadcast_optimizer_state_over_a_set(world):
    """Each member's SGD momentum buffer is its own gradient; after the
    broadcast over the set every member holds the root's."""
    n, ranks = world
    for s, members in _members(n):
        for r in members:
            _same(ranks[r][f"s{s}_bopt"], pset_inputs(n, s)["p"][-1])


@pytest.mark.parametrize("key", ["ag", "ag_async"])
def test_allgather_over_a_set_matches_jax(hvd, world, jax_sets, key):
    """Ragged first dims (the second member sends none)."""
    n, ranks = world
    for s, members in _members(n):
        want = hvd.allgather(_bundle(hvd, jax_sets[s], n, s, "ag"),
                             process_set=jax_sets[s])
        for r in members:
            _same(ranks[r][f"s{s}_{key}"], want)


def test_alltoall_over_a_set_matches_jax(hvd, world, jax_sets):
    n, ranks = world
    for s, members in _members(n):
        ps = jax_sets[s]
        even = np.asarray(hvd.alltoall(_bundle(hvd, ps, n, s, "a2a"),
                                       process_set=ps).array)
        outs, recv = hvd.alltoall(_bundle(hvd, ps, n, s, "a2av"),
                                  splits=a2av_splits(len(members)),
                                  process_set=ps)
        for i, r in enumerate(members):
            _same(ranks[r][f"s{s}_a2a"], even[i])
            _same(ranks[r][f"s{s}_a2av"], outs[i])
            _same(ranks[r][f"s{s}_a2av_recv"], recv[i])


@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_reducescatter_over_a_set_matches_jax(hvd, world, jax_sets, op):
    n, ranks = world
    key = "rs_sum" if op == "Sum" else "rs_avg"
    for s, members in _members(n):
        want = np.asarray(hvd.reducescatter(
            _bundle(hvd, jax_sets[s], n, s, "rs"), op=getattr(hvd, op),
            process_set=jax_sets[s]).array)
        for i, r in enumerate(members):
            got = ranks[r][f"s{s}_{key}"]
            if op == "Average" and len(members) == 3:
                np.testing.assert_allclose(got, want[i], rtol=1e-6)
            else:
                _same(got, want[i])


def test_root_outside_the_set_raises_as_jax(hvd, world, jax_sets):
    n, ranks = world
    for s, members in _members(n):
        ps = jax_sets[s]
        outside = [r for r in range(n) if r not in members][0]
        with pytest.raises(ValueError) as err:
            hvd.broadcast(_bundle(hvd, ps, n, s, "x"), outside,
                          process_set=ps)
        for r in members:
            assert str(ranks[r][f"s{s}_err_root"]) == (
                f"ValueError: {err.value}")


def test_non_member_raises_before_any_collective(world):
    """A rank outside a set raises at once (had it entered the collective,
    the members would have hung or mis-paired)."""
    n, ranks = world
    for s, members in _members(n):
        for r in range(n):
            if r not in members:
                assert str(ranks[r][f"s{s}_err"]) == (
                    f"ValueError: rank {r} is not a member of ProcessSet("
                    f"id={s + 1}, ranks={members}); only its members may "
                    "call a collective over it")


def test_object_collectives_over_a_set(world):
    n, ranks = world
    for s, members in _members(n):
        for r in members:
            assert str(ranks[r][f"s{s}_objects"]) == repr(
                [(m, s) for m in members])


# -- the table, in this process --------------------------------------------

class _FakeGroups:
    """Stands in for ``dist.new_group``/``destroy_process_group``."""

    def __init__(self):
        self.made, self.ended = [], []

    def new(self, ranks):
        self.made.append(list(ranks))
        return ("group", tuple(ranks))

    def end(self, group):
        self.ended.append(group)


@pytest.fixture
def tables(hvd):
    """A port table over a world of 8 with stand-in groups, and a fresh
    reference table on the conftest's world of 8, both with the dynamic
    gate open."""
    from horovod_tpu.process_sets import ProcessSetTable as RefTable
    from horovod_tpu_torch.process_sets import ProcessSetTable
    groups = _FakeGroups()
    ours = ProcessSetTable(8, new_group=groups.new, destroy_group=groups.end)
    ref = RefTable()
    ref.initialize_global(hvd.size())
    ours.dynamic_enabled = ref.dynamic_enabled = True
    return ours, ref, groups


def test_table_ids_and_free_list_match_jax(tables):
    """The same adds and removes give the same ids on both tables: a
    removed id goes back to a sorted free-list, the lowest is reused
    first, identical rank lists share one set (and one group)."""
    ours, ref, groups = tables
    ranks = [[1, 3, 5], [2, 0], [0, 2], [7], [4, 6]]
    mine = [ours.add(rs) for rs in ranks]
    theirs = [ref.add(rs) for rs in ranks]
    assert [p.process_set_id for p in mine] == [1, 2, 2, 3, 4]
    assert [p.process_set_id for p in theirs] == [1, 2, 2, 3, 4]
    assert mine[1] is mine[2] and mine[0].ranks == [1, 3, 5]
    assert groups.made == [[1, 3, 5], [0, 2], [7], [4, 6]]
    for i in (3, 0):
        ours.remove(mine[i])
        ref.remove(theirs[i])
    assert mine[0].process_set_id is None
    assert theirs[0].process_set_id is None
    assert groups.ended == [("group", (7,)), ("group", (1, 3, 5))]
    assert ours.ids() == ref.ids() == [0, 2, 4]
    again = [t.add(rs).process_set_id for t in (ours, ref)
             for rs in ([5, 6], [6, 7], [1, 2])]
    assert again == [1, 3, 5, 1, 3, 5]


def test_table_refuses_as_jax(tables):
    """id 0 cannot be removed; a rank outside the world and a dynamic add
    while the gate is closed raise, with the reference's texts."""
    from horovod_tpu_torch.process_sets import ProcessSet
    ours, ref, _ = tables
    for t in (ours, ref):
        with pytest.raises(ValueError, match="id 0"):
            t.remove(t.get(0))
    with pytest.raises(ValueError) as mine:
        ours.add([0, 8])
    with pytest.raises(ValueError) as theirs:
        ref.add([0, 8])
    assert str(mine.value) == str(theirs.value)
    ours.dynamic_enabled = ref.dynamic_enabled = False
    with pytest.raises(RuntimeError) as mine:
        ours.add([0, 1])
    with pytest.raises(RuntimeError) as theirs:
        ref.add([0, 1])
    assert str(mine.value) == str(theirs.value)
    assert ours.add([0, 1], force=True).ranks == [0, 1]
    assert ours.ids() == [0, 1] and ours.get(0).ranks == list(range(8))
    assert repr(ProcessSet([2, 1])) == "ProcessSet(id=None, ranks=[1, 2])"


def test_process_set_views_match_jax(hvd):
    """ranks, size, included, rank and is_global on both packages' sets,
    in a port world of one beside the reference's world of eight."""
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    try:
        for rs in ([0], [0, 3, 5]):
            ours, theirs = thvd.ProcessSet(rs), hvd.ProcessSet(rs)
            assert ours.ranks == theirs.ranks and ours.size() == len(rs)
            for r in range(6):
                assert ours.included(r) == theirs.included(r)
                assert ours.rank(r) == theirs.rank(r)
        assert thvd.global_process_set.is_global
        assert thvd.global_process_set.ranks == [0]
        assert thvd.global_process_set.group() is None
        with pytest.raises(ValueError, match="not a member"):
            thvd.ProcessSet([3]).group()
    finally:
        thvd.shutdown()


def test_init_takes_static_sets_and_the_dynamic_gate(monkeypatch):
    """``init(process_sets=[[0]])`` registers (here: finds the global set),
    ``"dynamic"`` opens the gate, ``HVD_DYNAMIC_PROCESS_SETS`` too, and a
    table is fresh after ``shutdown()``/``init()``."""
    import horovod_tpu_torch as thvd
    monkeypatch.delenv("HVD_DYNAMIC_PROCESS_SETS", raising=False)
    monkeypatch.delenv("HOROVOD_DYNAMIC_PROCESS_SETS", raising=False)
    tables = []
    for kw, gate in (({"process_sets": [[0]]}, False),
                     ({"process_sets": "dynamic"}, True), ({}, False)):
        thvd.init(device="cpu", **kw)
        try:
            table = thvd.runtime.process_set_table()
            assert table.dynamic_enabled == gate and table.ids() == [0]
            tables.append(table)
            if not gate:
                with pytest.raises(RuntimeError, match="Dynamic process"):
                    thvd.add_process_set([0])
            else:
                assert thvd.add_process_set([0]).process_set_id == 0
        finally:
            thvd.shutdown()
    monkeypatch.setenv("HVD_DYNAMIC_PROCESS_SETS", "1")
    thvd.init(device="cpu")
    try:
        assert thvd.runtime.process_set_table().dynamic_enabled
    finally:
        thvd.shutdown()
    assert len({id(t) for t in tables}) == 3
