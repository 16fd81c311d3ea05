"""Two-level collectives and the composed rank layout of the PyTorch port
(``ops/hierarchical.py``, ``parallel/mesh.py``) against the flat ones and
the JAX package's.

A spawned gloo world of 4 ranks in two nodes of two (``LOCAL_WORLD_SIZE=2``)
runs :func:`_hier_rank`, which imports no JAX. In the exactness domain
(integer-valued float32, power-of-two divisors and scales, docs/mesh.md)
every correct order of reduction is exact, so two-level against flat is
bitwise; on Gaussian inputs rtol 1e-6. The layout's parsing and carving
are held against the reference's in this process.
"""

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

WORLD, LOCAL = 4, 2
SHAPES = [(7,), (3, 5), (2, 2, 2), (33,)]
# (op, prescale, postscale): power-of-two scales keep the exactness domain
CASES = {"sum": ("Sum", 1.0, 1.0), "avg": ("Average", 1.0, 1.0),
         "avg_scaled": ("Average", 0.5, 4.0), "sum_scaled": ("Sum", 2.0, 0.25)}
DATA_SETS = ([0, 2], [1, 3])  # the ranks of one expert coordinate
LR = 0.5


def hier_inputs(rank: int) -> dict:
    rng = np.random.default_rng(300 + rank)
    return {"exact": [rng.integers(-40, 40, s).astype(np.float32)
                      for s in SHAPES],
            "gauss": [rng.standard_normal(s).astype(np.float32)
                      for s in SHAPES],
            "ragged": rng.integers(-9, 9, (rank + 1, 3)).astype(np.float32)}


def _layouts(composed):
    """dp x dp (two nodes of two), dp x ep with the data axis across the
    nodes, and dp x ep within one node of four."""
    return {"dcn2_ici2": composed.layout(()),
            "ep_across": composed.layout((("expert", 2),)),
            "ep_within": composed.layout((("expert", 2),), ici_size=4)}


def _hier_rank(out_path: str, device: str | None = "cpu") -> None:
    """One rank of the two-node world: flat and two-level results of every
    case, the routing counts, the layouts' syncs and optimizer steps."""
    import os
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import hierarchical
    from horovod_tpu_torch.parallel import mesh as composed

    os.environ["HVD_FUSION_THRESHOLD"] = "64"  # several wire buffers
    hvd.init(device=device, process_sets=list(DATA_SETS))
    try:
        rank, dev = hvd.rank(), hvd.device()
        inp = hier_inputs(rank)
        on = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        host = lambda t: t.cpu().numpy()  # noqa: E731
        out = {"ici": hierarchical.default_ici_size(),
               "local_size": hvd.local_size()}
        calls = {"reduce": 0, "gather": 0}
        real_reducer = hierarchical.two_level_reducer
        real_gather = hierarchical.two_level_gather

        def counted_reducer(*a):
            calls["reduce"] += 1
            return real_reducer(*a)

        def counted_gather(*a):
            calls["gather"] += 1
            return real_gather(*a)

        hierarchical.two_level_reducer = counted_reducer
        hierarchical.two_level_gather = counted_gather
        for data in ("exact", "gauss"):
            xs = [on(x) for x in inp[data]]
            for case, (op, pre, post) in CASES.items():
                kw = dict(op=getattr(hvd, op), prescale_factor=pre,
                          postscale_factor=post)
                key = f"{data}_{case}"
                os.environ.pop("HVD_HIERARCHICAL_ALLREDUCE", None)
                flat = hvd.grouped_allreduce(xs, **kw)
                os.environ["HVD_HIERARCHICAL_ALLREDUCE"] = "1"
                before = calls["reduce"]
                two = hvd.grouped_allreduce(xs, **kw)
                out[key + "_routed"] = calls["reduce"] - before
                explicit = [hvd.hierarchical_allreduce(x, **kw) for x in xs]
                for i in range(len(xs)):
                    out[f"{key}_flat{i}"] = host(flat[i])
                    out[f"{key}_two{i}"] = host(two[i])
                    out[f"{key}_explicit{i}"] = host(explicit[i])
        # the knob leaves other ops and other sets flat
        before = calls["reduce"]
        hvd.allreduce(torch.ones(3, device=dev), op=hvd.Min)
        ps = hvd.runtime.process_set_table().find(DATA_SETS[rank % 2])
        hvd.allreduce(torch.ones(3, device=dev), process_set=ps)
        out["flat_when_not_routed"] = calls["reduce"] - before
        os.environ.pop("HVD_HIERARCHICAL_ALLREDUCE")
        # allgather: flat, routed, explicit
        ragged = on(inp["ragged"])
        out["ag_flat"] = host(hvd.allgather(ragged))
        os.environ["HVD_HIERARCHICAL_ALLGATHER"] = "1"
        out["ag_two"] = host(hvd.allgather(ragged))
        out["ag_routed"] = calls["gather"]
        os.environ.pop("HVD_HIERARCHICAL_ALLGATHER")
        out["ag_explicit"] = host(hvd.hierarchical_allgather(ragged))
        hierarchical.two_level_reducer = real_reducer
        hierarchical.two_level_gather = real_gather
        # sync_gradients over each layout's data axes, against the flat
        # AVERAGE over the same ranks
        grads = {"w": on(inp["exact"][1]), "b": [on(inp["exact"][0])]}
        for name, lay in _layouts(composed).items():
            data = sorted(r for q in lay.axis_ranks("dcn")
                          for r in lay.axis_ranks("ici_dp", q))
            out[f"{name}_data_ranks"] = np.asarray(data)
            ps = hvd.runtime.process_set_table().find(data)
            synced = composed.sync_gradients(grads, lay)
            flat = hvd.grouped_allreduce([grads["w"], grads["b"][0]],
                                         process_set=ps)
            out[f"{name}_sync_w"] = host(synced["w"])
            out[f"{name}_sync_b"] = host(synced["b"][0])
            out[f"{name}_flat_w"] = host(flat[0])
            out[f"{name}_flat_b"] = host(flat[1])
        # DistributedOptimizer(mesh_spec=) against the flat sync over the
        # world (the expert axis's mean and the data axes'), several
        # buckets
        os.environ["HVD_BUCKET_BYTES"] = "64"
        lay = _layouts(composed)["ep_across"]
        os.environ["HVD_MESH_AXES"] = "expert:2"
        for name, spec in (("layout", lay), ("names", composed.DATA_AXES),
                           ("flat", None)):
            ps = [torch.nn.Parameter(torch.ones(s, device=dev))
                  for s in SHAPES]
            kw = {"mesh_spec": spec} if spec is not None else {}
            opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=LR), **kw)
            opt.zero_grad()
            sum((p * on(g)).sum() for p, g in zip(ps, inp["exact"])).backward()
            opt.step()
            out.update({f"opt_{name}{i}": host(p.detach())
                        for i, p in enumerate(ps)})
            out[f"opt_{name}_in_backward"] = np.asarray(
                opt.stats["started_in_backward"])
        os.environ.pop("HVD_MESH_AXES")
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


def _hier_rank_on_card(out_path: str) -> None:
    _hier_rank(out_path, device=None)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("_hier_rank", tmp_path_factory.mktemp("hier"),
                     size=WORLD, module="test_torch_hierarchical",
                     env={"LOCAL_WORLD_SIZE": str(LOCAL)})


def _numpy_allreduce(xs, op, pre, post):
    total = sum(x * np.float32(pre) for x in xs)
    if op == "Average":
        total = total / np.float32(len(xs))
    return total * np.float32(post)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("data", ["exact", "gauss"])
def test_two_level_allreduce_matches_flat(world, data, case):
    """``HVD_HIERARCHICAL_ALLREDUCE`` routes the global set's
    ``grouped_allreduce`` two-level (reduce-scatter in the node, allreduce
    across, allgather in the node), and ``hierarchical_allreduce`` does
    the same: bitwise the flat result and numpy's on integer-valued
    inputs with power-of-two scales, rtol 1e-6 on Gaussian ones; a length
    the node does not divide (7, 33) is padded."""
    op, pre, post = CASES[case]
    inputs = [hier_inputs(r)[data] for r in range(WORLD)]
    for res in world:
        assert int(res["ici"]) == LOCAL and int(res["local_size"]) == LOCAL
        assert int(res[f"{data}_{case}_routed"]) == 1  # one reducer a call
        for i in range(len(SHAPES)):
            flat = res[f"{data}_{case}_flat{i}"]
            want = _numpy_allreduce([x[i] for x in inputs], op, pre, post)
            for kind in ("two", "explicit"):
                got = res[f"{data}_{case}_{kind}{i}"]
                assert got.dtype == flat.dtype == np.float32
                if data == "exact":
                    np.testing.assert_array_equal(got, flat)
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, flat, rtol=1e-6,
                                               atol=1e-6)


def test_two_level_leaves_other_ops_and_sets_flat(world):
    """MIN, and a set other than the global one, stay flat with the knob
    on, as in the reference."""
    for res in world:
        assert int(res["flat_when_not_routed"]) == 0


def test_two_level_allgather_in_rank_order(world):
    """``HVD_HIERARCHICAL_ALLGATHER`` and ``hierarchical_allgather`` gather
    within the node, then across: every rank's rows (1 to 4 of them) in
    global rank order, as the flat gather gives them."""
    want = np.concatenate([hier_inputs(r)["ragged"] for r in range(WORLD)])
    for res in world:
        assert int(res["ag_routed"]) == 1
        for kind in ("flat", "two", "explicit"):
            np.testing.assert_array_equal(res[f"ag_{kind}"], want)


@pytest.mark.parametrize("layout", ["dcn2_ici2", "ep_across", "ep_within"])
def test_sync_gradients_equals_pure_dp(world, layout):
    """``sync_gradients`` over a layout's data axes equals the flat
    AVERAGE over the same ranks bitwise in the exactness domain: dp x dp
    over two nodes, dp x ep with the data axis across the nodes, and dp x
    ep within one node of four (``ici_size=4``); the expert axis is never
    reduced over."""
    data = {"dcn2_ici2": [list(range(WORLD))] * WORLD,
            "ep_across": [DATA_SETS[r % 2] for r in range(WORLD)],
            "ep_within": [DATA_SETS[r % 2] for r in range(WORLD)]}[layout]
    inputs = [hier_inputs(r)["exact"] for r in range(WORLD)]
    for r, res in enumerate(world):
        assert res[f"{layout}_data_ranks"].tolist() == data[r]
        for key, i in (("w", 1), ("b", 0)):
            got = res[f"{layout}_sync_{key}"]
            np.testing.assert_array_equal(got, res[f"{layout}_flat_{key}"])
            np.testing.assert_array_equal(got, _numpy_allreduce(
                [inputs[j][i] for j in data[r]], "Average", 1.0, 1.0))


def test_optimizer_mesh_spec_steps_as_the_data_set(world):
    """``DistributedOptimizer(mesh_spec=)`` (the layout, or the data axes'
    names with ``HVD_MESH_AXES=expert:2``) over dp x ep is the reference's
    composed step: the mean over the expert axis (its ``pmean``), then
    over the data axes, so every rank holds the same parameters. Its SGD
    step is bitwise that of the flat sync over the world, buckets started
    in the backward pass."""
    inputs = [hier_inputs(r)["exact"] for r in range(WORLD)]
    for r, res in enumerate(world):
        for i in range(len(SHAPES)):
            want = 1 - np.float32(LR) * _numpy_allreduce(
                [inputs[j][i] for j in range(WORLD)], "Average", 1.0, 1.0)
            for name in ("layout", "names", "flat"):
                np.testing.assert_array_equal(res[f"opt_{name}{i}"], want)
        for name in ("layout", "names"):
            assert res[f"opt_{name}_in_backward"].tolist() == \
                res["opt_flat_in_backward"].tolist()
            assert res[f"opt_{name}_in_backward"][0] >= 1


def test_optimizer_mesh_spec_refuses_a_stage_axis():
    """A ``stage`` axis's ranks hold different parameters, so
    ``mesh_spec`` cannot average over it: ``MeshLayoutError`` naming
    ``process_set=``; AVERAGE's and SUM's two-level sync takes no MIN."""
    from horovod_tpu_torch.parallel import mesh as port
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    try:
        params = [torch.nn.Parameter(torch.ones(2))]
        for axes in ((("stage", 1),), (("expert", 1), ("model", 1))):
            lay = port.MeshLayout(dcn=1, ici_dp=1, model_axes=axes)
            with pytest.raises(port.MeshLayoutError, match="process_set="):
                thvd.DistributedOptimizer(torch.optim.SGD(params, lr=1.0),
                                          mesh_spec=lay)
        with pytest.raises(ValueError, match="SUM/AVERAGE"):
            thvd.DistributedOptimizer(
                torch.optim.SGD(params, lr=1.0), op=thvd.Min,
                mesh_spec=port.MeshLayout(dcn=1, ici_dp=1))
    finally:
        thvd.shutdown()


# --------------------------------------------------------------------------
# the layout against the reference's, in this process
# --------------------------------------------------------------------------

SPECS = ["", "seq:2", " expert:4 , stage:2 ", "seq", "seq:", "seq:two",
         ":4", "a:1,,b:2"]
LAYOUT_CASES = [((), 4, 8), ((("seq", 2),), 4, 8), ((("expert", 2),), 2, 4),
                ((("expert", 2), ("stage", 2)), 4, 8), ((("seq", 3),), 4, 8),
                ((), 3, 8), ((("m", 2), ("m", 2)), 4, 8),
                ((("ici_dp", 2),), 4, 8), ((("bad-name", 2),), 4, 8)]


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return type(e).__name__, None


@pytest.mark.parametrize("spec", SPECS)
def test_parse_axes_matches_jax(spec):
    from horovod_tpu.parallel import mesh as ref
    from horovod_tpu_torch.parallel import mesh as port
    got = _outcome(lambda: port.parse_axes(spec))
    want = _outcome(lambda: ref.parse_axes(spec))
    assert got == want, (got, want)


def _describe(lay):
    return (lay.shape, lay.axis_names, lay.data_axes, lay.model_axis_names,
            lay.size, lay.key(),
            tuple(lay.axis_size(a) for a in lay.axis_names))


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=str)
def test_layout_matches_jax(case):
    """``layout`` carves the same axes, or raises ``MeshLayoutError``
    where the reference does."""
    from horovod_tpu.parallel import mesh as ref
    from horovod_tpu_torch.parallel import mesh as port
    model, ici, world = case
    got = _outcome(lambda: _describe(port.layout(model, ici_size=ici,
                                                 world=world)))
    want = _outcome(lambda: _describe(ref.layout(model, ici_size=ici,
                                                 world=world)))
    assert got == want, (got, want)
    with pytest.raises(port.MeshLayoutError):
        port.MeshLayout(dcn=0, ici_dp=1)
    with pytest.raises(port.MeshLayoutError):
        port.resolve_data_axes("dcn")


def test_default_layout_and_rank_order_match_jax(monkeypatch, hvd):
    """``default_layout`` reads ``HVD_MESH_AXES`` and
    ``HVD_HIERARCHICAL_ICI_SIZE`` as the reference does, and each rank's
    group along each axis holds the ranks the reference's composed mesh
    puts beside it (world 8)."""
    from horovod_tpu.parallel import mesh as ref
    from horovod_tpu_torch.parallel import mesh as port
    monkeypatch.setenv("HVD_MESH_AXES", "seq:2")
    monkeypatch.setenv("HVD_HIERARCHICAL_ICI_SIZE", "4")
    lay = port.default_layout(world=8)
    rlay = ref.default_layout(world=8)
    assert lay.key() == rlay.key() == (2, 2, ("seq", 2))
    mesh = ref.composed_mesh(rlay)
    rank_of = {d: i for i, d in enumerate(hvd.devices())}
    ranks = np.vectorize(lambda d: rank_of[d])(mesh.devices)
    for axis, name in enumerate(lay.axis_names):
        for r in range(8):
            where = list(zip(*np.nonzero(ranks == r)))[0]
            index = list(where)
            index[axis] = slice(None)
            assert lay.axis_ranks(name, rank=r) == ranks[
                tuple(index)].tolist(), (name, r)


def test_adasum_raises_naming_the_roadmap_item():
    """Adasum is ported (ROADMAP A9b): over a layout of one rank
    ``sync_gradients(op=Adasum)`` gives the gradients back unchanged and
    ``DistributedOptimizer(op=Adasum, mesh_spec=)`` is made; a scale
    factor beside Adasum raises, as in the reference (``mesh.py:289``,
    ``optim/__init__.py:208``). The two-level Adasum of a world of four is
    in ``test_torch_adasum.py``."""
    from horovod_tpu_torch.parallel import mesh as port
    import horovod_tpu_torch as thvd
    lay = port.MeshLayout(dcn=1, ici_dp=1)
    thvd.init(device="cpu")
    try:
        g = torch.tensor([1.5, -2.0])
        out = port.sync_gradients([g], lay, op=thvd.Adasum)
        torch.testing.assert_close(out[0], g, rtol=0, atol=0)
        p = torch.nn.Parameter(torch.ones(2))
        thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                  op=thvd.Adasum, mesh_spec=lay)
        with pytest.raises(ValueError, match="scale-invariant"):
            port.sync_gradients([g], lay, op=thvd.Adasum,
                                prescale_factor=2.0)
        with pytest.raises(ValueError, match="scale-invariant"):
            thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                      op=thvd.Adasum, mesh_spec=lay,
                                      postscale_factor=0.5)
    finally:
        thvd.shutdown()
