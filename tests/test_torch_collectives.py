"""The port's eager collectives against the JAX package's, on the CPU at
worlds of 2 and 4.

Each world is a spawned gloo world (:func:`test_torch_world2.run_world`),
started once per module for each size, whose ranks run
:func:`test_torch_world2._collectives_rank`: each passes its own tensor,
made from a seed (:func:`test_torch_world2.collective_inputs`). The
reference takes the same per-rank numpy arrays as a ``per_rank`` bundle on
a JAX process set of the first n devices of the conftest's 8-device CPU
mesh (``horovod_tpu/process_sets.py:186``). Inputs are integer-valued
float32 or int32 and an average divides by 2 or 4 (the exactness domain,
``docs/mesh.md:111-122``), so every comparison is bitwise. The reference's
single-controller splits matrix of the uneven alltoall gives each rank of
the port its own row.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from test_torch_world2 import (A2AV_ROWS, ALLREDUCE_CASES, a2av_splits,
                               collective_inputs, collective_objects,
                               run_world)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    """``(n, per-rank results)`` of one gloo world of n ranks."""
    n = request.param
    return n, run_world("_collectives_rank",
                        tmp_path_factory.mktemp(f"collectives{n}"), size=n)


@pytest.fixture
def pset(hvd, world):
    """A JAX process set of as many devices as the world has ranks."""
    ps = hvd.add_process_set(list(range(world[0])))
    yield ps
    hvd.remove_process_set(ps)


def _bundle(hvd, ps, key, n):
    return hvd.per_rank([np.asarray(x) for x in collective_inputs(n)[key]],
                        ps)


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["ag", "ag_int", "ag_scalar"])
def test_allgather_matches_jax(hvd, world, pset, key):
    """Ragged first dims (one rank sends none), int32, and 0-d tensors."""
    n, ranks = world
    want = hvd.allgather(_bundle(hvd, pset, key, n), process_set=pset)
    for res in ranks:
        _same(res[key], want)


@pytest.mark.parametrize("key", list(ALLREDUCE_CASES))
def test_allreduce_matches_jax(hvd, world, pset, key):
    """Prescale and postscale (on int32 they promote to float32: C1), MIN,
    MAX, PRODUCT, and bools (SUM counts in int32: C2): the same dtype and
    values as the reference, bitwise."""
    n, ranks = world
    src, op, kw = ALLREDUCE_CASES[key]
    want = hvd.allreduce(_bundle(hvd, pset, src, n), op=getattr(hvd, op),
                         process_set=pset, **kw)
    for res in ranks:
        _same(res[key], want)


def test_poll_sees_an_unfinished_handle(world):
    """Rank 0 starts an allreduce a second before the others: ``poll``
    says False, then True once ``synchronize`` has returned the sum."""
    n, ranks = world
    total = sum(collective_inputs(n)["red"])
    assert ranks[0]["polls"].tolist() == [False, True]
    for res in ranks:
        assert bool(res["polls"][1])
        _same(res["polled"], total)


def test_allgather_async_matches_allgather(world):
    for res in world[1]:
        _same(res["ag_async"], res["ag"])


@pytest.mark.parametrize("key", ["a2a", "a2a_int"])
def test_alltoall_even_matches_jax(hvd, world, pset, key):
    n, ranks = world
    want = np.asarray(hvd.alltoall(_bundle(hvd, pset, key, n),
                                   process_set=pset).array)
    for r, res in enumerate(ranks):
        _same(res[key], want[r])


def test_alltoall_uneven_matches_jax(hvd, world, pset):
    """Rank r passes row r of the reference's splits matrix; row sums stay
    below dim 0 on some ranks. Outputs and recv_splits per rank."""
    n, ranks = world
    outs, recv = hvd.alltoall(_bundle(hvd, pset, "a2av", n),
                              splits=a2av_splits(n), process_set=pset)
    assert (a2av_splits(n).sum(axis=1) < A2AV_ROWS).any()
    for r, res in enumerate(ranks):
        _same(res["a2av"], outs[r])
        _same(res["a2av_recv"], recv[r])


@pytest.mark.parametrize("key,op", [("rs_sum", "Sum"), ("rs_avg", "Average"),
                                    ("rs_int", "Sum")])
def test_reducescatter_matches_jax(hvd, world, pset, key, op):
    n, ranks = world
    src = "rs_int" if key == "rs_int" else "rs"
    want = np.asarray(hvd.reducescatter(_bundle(hvd, pset, src, n),
                                        op=getattr(hvd, op),
                                        process_set=pset).array)
    for r, res in enumerate(ranks):
        _same(res[key], want[r])


def test_broadcast_async_matches_jax(hvd, world, pset):
    n, ranks = world
    want = hvd.broadcast(_bundle(hvd, pset, "a2a", n), n - 1,
                         process_set=pset)
    for res in ranks:
        _same(res["bcast_async"], want)


@pytest.mark.parametrize("key,call", [
    ("err_a2a_rows", lambda hvd, b, ps, n: hvd.alltoall(b("bad_rows"),
                                                        process_set=ps)),
    ("err_rs_rows", lambda hvd, b, ps, n: hvd.reducescatter(
        b("bad_rows"), process_set=ps)),
    ("err_rs_avg_int", lambda hvd, b, ps, n: hvd.reducescatter(
        b("bad_int"), op=hvd.Average, process_set=ps)),
    ("err_a2av_sum", lambda hvd, b, ps, n: hvd.alltoall(
        b("a2av"), splits=np.full(n, A2AV_ROWS), process_set=ps)),
    ("err_rs_bool", lambda hvd, b, ps, n: hvd.reducescatter(
        b("red_bool"), process_set=ps)),
])
def test_errors_match_jax(hvd, world, pset, key, call):
    """dim 0 not divisible by the world size (alltoall, reducescatter),
    Average on ints, splits that sum past dim 0, bools to reducescatter
    (C2): the same exception type and text on every rank as the reference
    raises."""
    n, ranks = world
    with pytest.raises((ValueError, TypeError)) as err:
        call(hvd, lambda k: _bundle(hvd, pset, k, n), pset, n)
    want = f"{err.type.__name__}: {err.value}"
    for res in ranks:
        assert str(res[key]) == want


def test_uneven_alltoall_takes_one_row_of_splits(world):
    """The port's splits are this rank's row: a row of another length
    raises on every rank before anything moves."""
    n, ranks = world
    for res in ranks:
        assert str(res["err_a2av_len"]) == (
            f"ValueError: splits must be one row of length {n}, got shape "
            f"({n - 1},)")


def test_object_collectives(world):
    """``broadcast_object`` gives every rank the root's object,
    ``allgather_object`` every rank's object in rank order."""
    n, ranks = world
    gathered = [collective_objects(r)[1] for r in range(n)]
    for res in ranks:
        assert str(res["bcast_object"]) == repr(collective_objects(n - 1)[0])
        assert str(res["gather_object"]) == repr(gathered)
        assert bool(res["homogeneous"])


@pytest.fixture
def torch_world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def test_world1_object_collectives_match_jax(hvd, torch_world1):
    """In one process both sides return the object itself, and a list of
    it; ``is_homogeneous`` holds on both."""
    obj = {"a": [1, 2.5], "b": "x"}
    assert thvd.broadcast_object(obj) == hvd.broadcast_object(obj) == obj
    assert thvd.allgather_object(obj) == hvd.allgather_object(obj) == [obj]
    assert thvd.is_homogeneous() and hvd.is_homogeneous()


def test_world1_collectives_are_the_identity(torch_world1):
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    assert torch.equal(thvd.allgather(x), x)
    assert torch.equal(thvd.alltoall(x), x)
    out, recv = thvd.alltoall(x, splits=[2])
    assert torch.equal(out, x[:2]) and recv.tolist() == [2]
    assert torch.equal(thvd.reducescatter(x, op=thvd.Average), x)
