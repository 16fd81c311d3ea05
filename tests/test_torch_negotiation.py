"""The negotiated multi-process eager path of the PyTorch port: the native
engine (``dynamic.py``), the KV store (``runner/http_kv.py``), the
negotiation service (``engine_service.py``) and ``join``.

Engine parity: the same request sequences go through the JAX package's
``dynamic.NativeEngine`` + ``drive_cycle`` and the port's (two libraries,
built apart from one source), and must give identical responses (names,
types, fusion, errors, cache hits) and stall reports; the cases mirror
``tests/test_dynamic_engine.py``.

The service runs in spawned gloo worlds of 2 and 4 under a KV server that
``run_world(kv=True)`` starts in this process, as a launcher would, each
rank :func:`_negotiation_rank` of this file, which imports no JAX. Every
value checked there is exact (integer-valued floats, divisors that are
powers of two or give exact quotients), so every comparison is bitwise.
"""

import dataclasses
import logging
import os
import time

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

ENGINE_STEPS = {0: 3, 1: 1, 2: 2, 3: 0}  # optimizer steps of each rank
SHAPES = [(3,), (2, 2), (5,)]
LR = 0.5


# --------------------------------------------------------------------------
# engine parity: scenarios of cycles, each a list of (rank, name, type,
# keywords) enqueues; "sleep" waits before the stall report
# --------------------------------------------------------------------------

AR, AG, BC, JOIN, A2A, BAR = 0, 1, 2, 3, 5, 6
SCENARIOS = {
    "not_ready_until_all": (2, {}, [[(0, "t", AR, {"shape": (4,)})],
                                    [(1, "t", AR, {"shape": (4,)})]]),
    "identical_plans": (4, {}, [[(r, n, AR, {"shape": s}) for r in range(4)
                                 for n, s in (("x", (8,)), (f"y{r}", (2,)))],
                                [(r, f"y{q}", AR, {"shape": (2,)})
                                 for r in range(4) for q in range(4)
                                 if q != r]]),
    "first_submission_order": (2, {}, [
        [(0, "late", AR, {"shape": (1000000,), "dtype": 1})],
        [(0, "early", AR, {"shape": (4,)}), (1, "early", AR, {"shape": (4,)}),
         (1, "late", AR, {"shape": (1000000,), "dtype": 1})]]),
    "duplicate_pending": (2, {}, [[(0, "d", AR, {"shape": (4,)}),
                                   (0, "d", AR, {"shape": (4,)})],
                                  [(1, "d", AR, {"shape": (4,)})]]),
    "name_reuse": (2, {}, [[(r, "r", AR, {"shape": (4,)}) for r in (0, 1)]] * 2),
    "shape_mismatch": (2, {}, [[(0, "t", AR, {"shape": (4,)}),
                                (1, "t", AR, {"shape": (5,)})],
                               [(r, "t", AR, {"shape": (4,)})
                                for r in (0, 1)]]),
    "dtype_mismatch": (2, {}, [[(0, "t", AR, {"shape": (4,), "dtype": 0}),
                                (1, "t", AR, {"shape": (4,), "dtype": 2})]]),
    "op_mismatch": (2, {}, [[(0, "t", AR, {"shape": (4,)}),
                             (1, "t", AG, {"shape": (4,)})]]),
    "reduce_op_mismatch": (2, {}, [[(0, "t", AR, {"shape": (4,),
                                                  "reduce_op": 1}),
                                    (1, "t", AR, {"shape": (4,),
                                                  "reduce_op": 0})]]),
    "root_mismatch": (2, {}, [[(0, "t", BC, {"shape": (4,), "root_rank": 0}),
                               (1, "t", BC, {"shape": (4,),
                                             "root_rank": 1})]]),
    "allgather_first_dims": (2, {}, [[(0, "g", AG, {"shape": (2, 3)}),
                                      (1, "g", AG, {"shape": (5, 3)})]]),
    "allgather_digest": (2, {}, [[(0, "g", AG, {"shape": (2, 3),
                                                "splits_crc": 7}),
                                  (1, "g", AG, {"shape": (5, 3),
                                                "splits_crc": 8})]]),
    "allgather_later_dims": (2, {}, [[(0, "g", AG, {"shape": (2, 3)}),
                                      (1, "g", AG, {"shape": (2, 4)})]]),
    "fusion": (2, {}, [[(r, n, AR, {"shape": s, "dtype": 1})
                        for r in (0, 1)
                        for n, s in (("a", (4,)), ("b", (6,)), ("c", (2,)))],
                       [(r, n, AR, {"shape": (4,), "dtype": d})
                        for r in (0, 1) for n, d in (("d", 1), ("e", 2))]]),
    "threshold": (2, {"fusion_threshold": 64}, [
        [(r, n, AR, {"shape": (8,), "element_size": 4})
         for r in (0, 1) for n in "abc"]]),
    "barrier_not_fused": (2, {}, [[(r, n, t, {"shape": s}) for r in (0, 1)
                                   for n, t, s in (("a", AR, (4,)),
                                                   ("bar", BAR, ()),
                                                   ("b", AR, (4,)))]]),
    "group": (2, {}, [[(r, "g1", AR, {"shape": (4,), "group_id": 7})
                       for r in (0, 1)],
                      [(r, "g2", AR, {"shape": (4,), "group_id": 7})
                       for r in (0, 1)]]),
    "join": (2, {}, [[(0, "j", JOIN, {})], [(1, "t", AR, {"shape": (4,)})],
                     [(1, "g", AG, {"shape": (3, 2)})],
                     [(1, "j2", JOIN, {})]]),
    "cache": (2, {}, [[(r, "c", AR, {"shape": (4,)}) for r in (0, 1)],
                      [(r, "c", AR, {"shape": (4,)}) for r in (0, 1)],
                      [(0, "c", AR, {"shape": (4,)})],
                      [(1, "c", AR, {"shape": (4,)})]]),
    "cache_invalidation": (2, {}, [
        [(r, n, AR, {"shape": s}) for r in (0, 1)
         for n, s in (("v", (4,)), ("w", (2,)))],
        [(0, "v", AR, {"shape": (9,)})],
        [(1, "v", AR, {"shape": (9,)})] + [(r, "w", AR, {"shape": (2,)})
                                           for r in (0, 1)]]),
    "alltoall_splits": (2, {}, [[(0, "a", A2A, {"shape": (5, 2),
                                                "splits": (2, 3)}),
                                 (1, "a", A2A, {"shape": (4, 2),
                                                "splits": (1, 3)})]]),
    "stall": (2, {"stall_warn": 0.05}, [[(0, "s", AR, {"shape": (4,)})],
                                        "sleep"]),
}


def _drive(dynamic, world, kw, cycles) -> list:
    """Every observable of a scenario under one package's engine."""
    engines = [dynamic.NativeEngine(world_size=world, rank=r, **kw)
               for r in range(world)]
    seen = []
    try:
        for cycle in cycles:
            if cycle == "sleep":
                time.sleep(0.2)
            else:
                for rank, name, rtype, meta in cycle:
                    try:
                        engines[rank].enqueue(name, rtype, **meta)
                        seen.append(("queued", rank, name))
                    except ValueError as e:
                        seen.append((type(e).__name__, rank, str(e)))
            seen.append([[dataclasses.asdict(x) for x in plan]
                         for plan in dynamic.drive_cycle(engines)])
            seen.append([(e.cache_size(), e.pending_count(),
                          e.join_pending()) for e in engines])
            for e in engines:
                report, shutdown = e.stall_report()
                seen.append(([(s.tensor_name, s.ready_ranks)
                              for s in report], shutdown))
    finally:
        for e in engines:
            e.close()
    return seen


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_engine_responses_equal_jax(case):
    """The port's engine and the JAX package's, fed the same requests,
    give the same responses, cache state and stall reports."""
    from horovod_tpu import dynamic as jax_dynamic
    from horovod_tpu_torch import dynamic as port_dynamic
    world, kw, cycles = SCENARIOS[case]
    want = _drive(jax_dynamic, world, kw, cycles)
    got = _drive(port_dynamic, world, kw, cycles)
    assert got == want
    if case == "stall":
        assert want[-1] == ([("s", [0])], False)


def test_request_wire_format_equals_jax():
    """One engine's serialized requests are byte-for-byte the JAX
    package's, and both parsers read them alike."""
    from horovod_tpu import dynamic as jax_dynamic
    from horovod_tpu_torch import dynamic as port_dynamic
    frames = []
    for dynamic in (jax_dynamic, port_dynamic):
        e = dynamic.NativeEngine(world_size=2, rank=1)
        e.enqueue("g.0", AR, shape=(3, 4), dtype=11, group_id=5,
                  reduce_op=0, prescale=0.5, postscale=2.0)
        e.enqueue("b", BC, shape=(7,), root_rank=0)
        e.enqueue("a", A2A, shape=(5, 2), splits=(2, 3))
        frames.append(e.pop_requests())
        e.close()
    assert frames[0] == frames[1]
    got = port_dynamic.parse_requests(frames[1])
    assert got == jax_dynamic.parse_requests(frames[0])
    assert [(q["rank"], q["request_type"], q["name"]) for q in got] == [
        (1, AR, "g.0"), (1, BC, "b"), (1, A2A, "a")]


def test_engine_builds_into_the_port():
    """The port's engine library comes from ``native/`` into the port's
    own build directory, never the JAX package's ``lib/``."""
    from horovod_tpu_torch import _native
    path = _native.build()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "horovod_tpu_torch"
    assert _native.version() == __import__(
        "horovod_tpu._native", fromlist=["version"]).version()


def test_kv_store_signs_and_gathers():
    """The KV store: a put is read back, a scope gathers in one long-poll,
    a delete drops a scope, and a client without the secret is refused
    (HTTP 403)."""
    import urllib.error
    from horovod_tpu_torch.runner.http_kv import (KVClient, KVServer,
                                                  make_secret)
    server = KVServer(secret=make_secret(), host="127.0.0.1")
    port = server.start()
    try:
        kv = KVClient("127.0.0.1", port, secret=server.secret)
        kv.put("s/a", b"1")
        kv.put("s/b", b"22")
        assert kv.get("s/a") == b"1" and kv.get("s/zz") is None
        assert kv.keys("s") == ["s/a", "s/b"]
        got, times = kv.gather("s", 2, timeout=5.0, with_times=True)
        assert got == {"s/a": b"1", "s/b": b"22"} and set(times) == set(got)
        with pytest.raises(TimeoutError):
            kv.gather("s", 3, timeout=0.3)
        kv.delete("s")
        assert kv.keys("s") == []
        with pytest.raises(urllib.error.HTTPError) as err:
            KVClient("127.0.0.1", port, secret="wrong").put("s/c", b"x")
        assert err.value.code == 403
    finally:
        server.stop()


# --------------------------------------------------------------------------
# the service in spawned worlds
# --------------------------------------------------------------------------

def opt_grads(rank: int, step: int) -> list:
    rng = np.random.default_rng(1000 + 10 * rank + step)
    return [rng.integers(-8, 8, s).astype(np.float32) for s in SHAPES]


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # the type and message, for the test to read
        return f"{type(e).__name__}: {e}"
    return ""


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _negotiation_rank(out_path: str) -> None:
    """One rank: the service's guarantees, then ``join``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import engine_service
    from horovod_tpu_torch.utils import logging as hvd_logging

    warnings = _Warnings()
    hvd_logging.get_logger().addHandler(warnings)
    os.environ["HVD_BUCKET_BYTES"] = "16"  # several gradient buckets
    hvd.init(device="cpu")
    try:
        r, n = hvd.rank(), hvd.size()
        out = {"service": engine_service.get_service() is not None}
        full = lambda v, s=(4,): torch.full(s, float(v))  # noqa: E731
        # named allreduces, submitted and waited for in other orders on
        # other ranks
        names = ["a", "b", "c"]
        order = names[r % 3:] + names[:r % 3]
        handles = {nm: hvd.allreduce_async(full(r + i, (i + 2,)), name=nm,
                                           op=hvd.Sum)
                   for i, nm in enumerate(names) if nm in order}
        handles = {nm: handles[nm] for nm in order}
        for nm in (reversed(order) if r % 2 else order):
            out[f"ooo_{nm}"] = handles[nm].synchronize().numpy()
        # every eager collective negotiates
        out["grouped"] = [t.numpy() for t in hvd.grouped_allreduce(
            [full(r), full(2 * r, (2, 3))], op=hvd.Sum)][1]
        out["allgather"] = hvd.allgather(full(r, (r + 1, 2))).numpy()
        out["broadcast"] = hvd.broadcast(full(r), root_rank=n - 1).numpy()
        out["alltoall"] = hvd.alltoall(
            torch.arange(2 * n, dtype=torch.float32) + 10 * r).numpy()
        a2a, recv = hvd.alltoall(torch.arange(n + r, dtype=torch.float32),
                                 splits=[1] * (n - 1) + [1 + r])
        out["alltoallv"], out["alltoallv_recv"] = a2a.numpy(), recv.numpy()
        out["reducescatter"] = hvd.reducescatter(full(r, (2 * n,))).numpy()
        hvd.barrier()
        svc = engine_service.get_service()
        out["rounds"] = svc.rounds
        # a mismatch raises on every rank, before any collective is issued
        mismatch = {
            "shape": lambda: hvd.allreduce(full(1, (4 + (r > 0),)),
                                           name="mm_shape"),
            "dtype": lambda: hvd.allreduce(
                full(1).double() if r else full(1), name="mm_dtype"),
            "op": lambda: hvd.allreduce(full(1), name="mm_op",
                                        op=hvd.Sum if r else hvd.Max),
            "root": lambda: hvd.broadcast(full(1), root_rank=min(r, 1),
                                          name="mm_root")}
        for key, fn in mismatch.items():
            out[f"mismatch_{key}"] = _raised(fn)
        out["after_mismatch"] = hvd.allreduce(full(1), op=hvd.Sum).numpy()
        # a name still pending is refused (issued at once: the fusion
        # cycle's queue would serialize the two instead, its name-reuse
        # flush, which the cycle's own tests hold)
        os.environ["HVD_CYCLE_TIME"] = "0"
        h = hvd.allreduce_async(full(1), name="dup", op=hvd.Sum)
        out["duplicate"] = _raised(
            lambda: hvd.allreduce_async(full(1), name="dup"))
        h.synchronize()
        # the stall inspector names the late ranks
        if n == 2:
            h = hvd.allreduce_async(full(1), name="late", op=hvd.Sum) \
                if r == 0 else None
            time.sleep(7.0)
            h = h or hvd.allreduce_async(full(1), name="late", op=hvd.Sum)
            h.synchronize()
            out["stall_warnings"] = [w for w in warnings.lines
                                     if "late" in w]
        del os.environ["HVD_CYCLE_TIME"]
        # HVD_DYNAMIC_ENGINE=0: unnegotiated, join is a barrier
        os.environ["HVD_DYNAMIC_ENGINE"] = "0"
        out["off_allreduce"] = hvd.allreduce(full(r), op=hvd.Sum).numpy()
        out["off_join"] = hvd.join()
        del os.environ["HVD_DYNAMIC_ENGINE"]
        # join: uneven steps of AVERAGE, the joined ranks' zeros divided
        # by the world
        for step in range(n - r):
            out[f"join_avg{step}"] = hvd.allreduce(
                full(6.0 * n), name=f"j{step}").numpy()
        # with every other rank joined: grouped, barrier, allgather
        if r == 0:
            out["join_grouped"] = [t.numpy() for t in hvd.grouped_allreduce(
                [full(i + 1, (2,)) for i in range(3)], op=hvd.Sum,
                name="jgrp")]
            hvd.barrier()
            out["join_gather"] = hvd.allgather(full(7, (3, 2))).numpy()
            out["join_gather_scalar"] = hvd.allgather(
                torch.tensor(3.0)).numpy()
        out["last_joined"] = hvd.join()
        # the optimizer over uneven data, then join and broadcast from
        # the last rank to join
        params = [torch.nn.Parameter(torch.ones(s)) for s in SHAPES]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=LR))
        for step in range(ENGINE_STEPS[r] if n == 4 else [2, 1][r]):
            opt.zero_grad()
            sum((p * torch.from_numpy(g)).sum() for p, g in
                zip(params, opt_grads(r, step))).backward()
            opt.step()
        out["opt_in_backward"] = np.asarray(
            opt.stats["started_in_backward"])
        last = hvd.join()
        out["opt_last"] = last
        out.update({f"opt_own{i}": p.detach().numpy().copy()
                    for i, p in enumerate(params)})
        hvd.broadcast_parameters({str(i): p.data
                                  for i, p in enumerate(params)},
                                 root_rank=last)
        out.update({f"opt_bcast{i}": p.detach().numpy()
                    for i, p in enumerate(params)})
        # broadcast (world 2) or alltoall (world 4) while a peer is
        # joined: raises on every rank, and the joined rank's service ends
        if r == 0:
            time.sleep(0.5)  # the peers' JOIN lands first
            out["joined_peer"] = _raised(
                lambda: hvd.broadcast(full(1), root_rank=0) if n == 2
                else hvd.alltoall(full(1, (n,))))
        else:
            out["joined_peer"] = _raised(hvd.join)
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    return n, run_world("_negotiation_rank",
                        tmp_path_factory.mktemp(f"negotiation{n}"), size=n,
                        module="test_torch_negotiation", kv=True,
                        # a 10 ms busy cycle (2 ms by default) keeps the
                        # ranks' KV traffic off the other tests' cores
                        env={"HVD_STALL_CHECK_TIME_SECONDS": "1",
                             "HVD_PENDING_CYCLE_TIME": "10"})


def test_out_of_order_submissions_complete(world):
    """Named allreduces submitted, and waited for, in different orders
    on different ranks all complete with the right sums: each rank
    issues them in the order their plans arrived."""
    n, res = world
    for got in res:
        assert bool(got["service"])
        for i, nm in enumerate("abc"):
            want = np.full((i + 2,), float(sum(r + i for r in range(n))))
            np.testing.assert_array_equal(got[f"ooo_{nm}"], want)


def test_every_eager_collective_is_negotiated(world):
    """grouped allreduce, allgather, broadcast, alltoall (even and
    uneven: the received splits come with the plan), reducescatter and
    barrier under the service, each with its unnegotiated result; busy
    rounds were made."""
    n, res = world
    for r, got in enumerate(res):
        np.testing.assert_array_equal(
            got["grouped"], np.full((2, 3), float(sum(2 * q
                                                      for q in range(n)))))
        np.testing.assert_array_equal(got["allgather"], np.concatenate(
            [np.full((q + 1, 2), float(q)) for q in range(n)]))
        np.testing.assert_array_equal(got["broadcast"], np.full(4, n - 1.0))
        np.testing.assert_array_equal(got["alltoall"], np.concatenate(
            [np.arange(2 * r, 2 * r + 2) + 10.0 * q for q in range(n)]))
        recv = [1] * n if r < n - 1 else [1 + q for q in range(n)]
        np.testing.assert_array_equal(got["alltoallv_recv"], recv)
        want = np.concatenate([
            np.arange(n + q, dtype=np.float32)[r:r + recv[q]]
            for q in range(n)])
        np.testing.assert_array_equal(got["alltoallv"], want)
        np.testing.assert_array_equal(
            got["reducescatter"], np.full(2, float(sum(range(n)))))
        assert int(got["rounds"]) > 0


@pytest.mark.parametrize("kind", ["shape", "dtype", "op", "root"])
def test_mismatch_raises_on_every_rank(world, kind):
    """A disagreement of shape, dtype, op or root is a
    ``HorovodCollectiveError`` on every rank, and the service goes on."""
    n, res = world
    for got in res:
        msg = str(got[f"mismatch_{kind}"])
        assert msg.startswith("HorovodCollectiveError"), msg
        np.testing.assert_array_equal(got["after_mismatch"],
                                      np.full(4, float(n)))


def test_duplicate_pending_name_is_refused(world):
    _, res = world
    for got in res:
        assert str(got["duplicate"]).startswith("DuplicateNameError")


def test_stall_is_reported(world):
    """``HVD_STALL_CHECK_TIME_SECONDS=1``: a tensor submitted by rank 0
    alone for 7 s is reported with its missing rank, on rank 0 (the
    report is made by every rank's engine, which all saw it)."""
    n, res = world
    if n != 2:
        pytest.skip("the world of 2 waits out the stall")
    lines = [str(x) for x in res[0]["stall_warnings"]]
    assert any("missing ranks: [1]" in x for x in lines), lines


def test_dynamic_engine_off_runs_unnegotiated(world):
    """``HVD_DYNAMIC_ENGINE=0``: the collectives run as without a KV store,
    and ``join`` is a barrier that returns ``size() - 1``."""
    n, res = world
    for got in res:
        np.testing.assert_array_equal(got["off_allreduce"],
                                      np.full(4, float(sum(range(n)))))
        assert int(got["off_join"]) == n - 1


def test_join_uneven_average_divides_by_the_world(world):
    """Rank r runs n - r AVERAGE allreduces of 6n and joins: at step s
    the n - s ranks still running get 6(n - s), the joined ranks'
    zeros counted in the divisor."""
    n, res = world
    for r, got in enumerate(res):
        for step in range(n - r):
            np.testing.assert_array_equal(got[f"join_avg{step}"],
                                          np.full(4, 6.0 * (n - step)))


def test_join_grouped_barrier_and_allgather(world):
    """With every other rank joined: a grouped SUM equals rank 0's own
    tensors, the barrier passes, and an allgather omits the joined
    ranks' rows (a scalar gather gets a zero of each, as the
    reference's)."""
    n, res = world
    got = res[0]
    for i in range(3):
        np.testing.assert_array_equal(got["join_grouped"][i],
                                      np.full(2, i + 1.0))
    np.testing.assert_array_equal(got["join_gather"], np.full((3, 2), 7.0))
    np.testing.assert_array_equal(got["join_gather_scalar"],
                                  [3.0] + [0.0] * (n - 1))


def test_join_returns_the_same_last_rank(world):
    n, res = world
    lasts = {int(got["last_joined"]) for got in res}
    assert len(lasts) == 1 and lasts <= set(range(n)), lasts


def test_join_refuses_broadcast_and_alltoall(world):
    """A broadcast (world 2) or alltoall (world 4) while a peer is joined
    raises on the rank that called it and ends the joined ranks' join
    with an error, instead of a hang."""
    n, res = world
    assert str(res[0]["joined_peer"]).startswith("HorovodCollectiveError")
    assert ("BROADCAST" if n == 2 else "ALLTOALL") in str(
        res[0]["joined_peer"])
    for got in res[1:]:
        msg = str(got["joined_peer"])
        assert msg.startswith("HorovodCollectiveError") and "join" in msg


def test_optimizer_with_uneven_data_and_join(world):
    """``DistributedOptimizer(SGD)`` with a different number of batches
    on each rank, then ``join``: every rank's parameters after the
    broadcast from the last rank to join equal the steps computed with
    zero gradients from the joined ranks; each step's buckets started in
    the backward pass."""
    n, res = world
    steps = ENGINE_STEPS if n == 4 else {0: 2, 1: 1}
    params = [np.ones(s, np.float32) for s in SHAPES]
    for step in range(max(steps.values())):
        grads = [sum(opt_grads(r, step)[i] for r in range(n)
                     if step < steps[r]) for i in range(len(SHAPES))]
        params = [p - np.float32(LR) * (g / np.float32(n))
                  for p, g in zip(params, grads)]
    last = int(res[0]["opt_last"])
    assert steps[last] == max(steps.values())
    for r, got in enumerate(res):
        assert int(got["opt_last"]) == last
        assert len(got["opt_in_backward"]) == steps[r]
        assert all(k >= 1 for k in got["opt_in_backward"])
        for i in range(len(SHAPES)):
            np.testing.assert_array_equal(got[f"opt_bcast{i}"], params[i])
            if steps[r] == steps[last]:
                np.testing.assert_array_equal(got[f"opt_own{i}"], params[i])


# --------------------------------------------------------------------------
# the rank side of the four-card test (tests/test_torch_cuda.py)
# --------------------------------------------------------------------------

CARD_STEPS = {0: 3, 1: 1, 2: 2, 3: 0}  # the trainer's uneven batches
CARD_EVEN_STEPS = 3  # steps of every rank, timed, before the uneven ones


def _service_rank_on_card(out_path: str) -> None:
    """One rank over NCCL under the KV service: out-of-order named
    allreduces, a shape mismatch, the full-width trainer (8 x 2048 tokens
    a card, Adam) for ``CARD_EVEN_STEPS`` timed steps on every rank, then
    ``CARD_STEPS[rank]`` more, ``join`` and ``broadcast_parameters`` from
    the last rank to join."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import engine_service
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)

    hvd.init()
    try:
        r, n, dev = hvd.rank(), hvd.size(), hvd.device()
        out = {}
        names = ["a", "b", "c"]
        order = names[r % 3:] + names[:r % 3]
        handles = {nm: hvd.allreduce_async(
            torch.full((1 << 16,), float(r + i), device=dev), name=nm,
            op=hvd.Sum) for i, nm in enumerate(names)}
        for nm in (reversed(order) if r % 2 else order):
            out[f"ooo_{nm}"] = handles[nm].synchronize().cpu().numpy()
        out["mismatch"] = _raised(lambda: hvd.allreduce(
            torch.ones(4 + (r > 0), device=dev), name="mm"))
        svc = engine_service.get_service()
        cfg = TransformerConfig(attn_mode="ulysses")
        model = TransformerLM(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3))

        def step(seed):
            tokens = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab_size, size=(8, 2048))).to(dev)
            opt.zero_grad()
            loss = lm_loss(model(tokens), tokens)
            loss.backward()
            opt.step()
            return loss.item()

        losses = [step(100 * r)]
        rounds0, seconds0 = svc.rounds, svc.round_seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(100 * r + i) for i in range(1, CARD_EVEN_STEPS)]
        torch.cuda.synchronize()
        out["step_ms"] = ((time.perf_counter() - t0)
                          / (CARD_EVEN_STEPS - 1) * 1e3)
        out["rounds_per_step"] = ((svc.rounds - rounds0)
                                  / (CARD_EVEN_STEPS - 1))
        out["round_ms"] = ((svc.round_seconds - seconds0)
                           / max(svc.rounds - rounds0, 1) * 1e3)
        out["buckets"] = len(opt.stats["bucket_bytes"])
        out["transport"] = type(svc.transport).__name__
        losses += [step(100 * r + 50 + i) for i in range(CARD_STEPS[r])]
        out["losses"] = losses
        last = hvd.join()
        out["last"] = last
        hvd.broadcast_parameters(model.state_dict(), root_rank=last)
        out["checksum"] = [float(p.double().sum()) for p in
                           model.parameters()]
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# the rank side of tests/test_torch_negotiation_cache.py and
# tests/test_torch_observability.py (and of their card tests): the
# coordinator ResponseCache, the health watchdog and the timeline
# --------------------------------------------------------------------------

CACHE_ITERS = 6  # iterations of the served-traffic loop
CACHE_ROOT = 1  # the named broadcast's root
WATCHDOG_CALLS = 12  # named allreduces each rank tries; rank 1 dies at 6
TIMELINE_NAMES = ("loss", "acc", "grads")


def cache_inputs(n: int, it: int) -> dict:
    """Iteration ``it``'s per-rank inputs of the served-traffic loop:
    integer-valued float32, the average's multiples of 4, so that every
    result of a world of 2 or 4 is exact."""
    rng = np.random.default_rng(4000 + it)
    ints = lambda shape: rng.integers(-8, 8, shape).astype(  # noqa: E731
        np.float32)
    return {"a": [ints((5,)) for _ in range(n)],
            "g": [ints((r + 1, 3)) for r in range(n)],
            "b": [ints((2, 2)) for _ in range(n)],
            "c": [4 * ints((3,)) for _ in range(n)]}


def _cache_loop(hvd, out: dict) -> None:
    """The served-traffic loop: each iteration submits a named allreduce
    ``loss`` (SUM), an auto-named allgather (never cached), a named
    broadcast ``b`` from ``CACHE_ROOT`` and a named AVERAGE ``c``, all
    async, and waits for them in an order of its own (rotated by rank).
    After two iterations ``loss``, ``b`` and ``c`` are served from the
    cache, so they are issued by their place in the submission order
    while the allgather's plan arrives whenever it does."""
    import json

    from horovod_tpu_torch import engine_service

    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    svc = engine_service.get_service()
    served, rounds = [], []
    for it in range(CACHE_ITERS):
        x = cache_inputs(n, it)
        t = lambda k: torch.from_numpy(x[k][r]).to(dev)  # noqa: E731
        hits = hvd.response_cache_stats()["global"]["hits"]
        rounds0 = svc.rounds
        handles = {
            "a": hvd.allreduce_async(t("a"), name="loss", op=hvd.Sum),
            "g": hvd.allgather_async(t("g")),
            "b": hvd.broadcast_async(t("b"), root_rank=CACHE_ROOT,
                                     name="b"),
            "c": hvd.allreduce_async(t("c"), name="c")}
        keys = list(handles)
        for k in keys[r % 4:] + keys[:r % 4]:
            out[f"{k}{it}"] = handles[k].synchronize().cpu().numpy()
        served.append(hvd.response_cache_stats()["global"]["hits"] - hits)
        rounds.append(svc.rounds - rounds0)
    out["served"] = served
    out["rounds"] = rounds
    out["stats"] = json.dumps(hvd.response_cache_stats())
    out["transport"] = type(svc.transport).__name__


def _cache_rank(out_path: str) -> None:
    """One rank of :func:`_cache_loop` on the CPU."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        out = {}
        _cache_loop(hvd, out)
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


CARD_CALLS = 50  # timed allreduces of each kind on the card


def _cache_rank_on_card(out_path: str) -> None:
    """:func:`_cache_loop` over NCCL, then ``CARD_CALLS`` named allreduces
    of 256 KiB served from the cache (their busy rounds counted) timed
    against as many unnegotiated ones (``HVD_DYNAMIC_ENGINE=0``)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import engine_service

    hvd.init()
    try:
        out, dev = {}, hvd.device()
        _cache_loop(hvd, out)
        svc = engine_service.get_service()
        x = torch.ones(1 << 16, device=dev)

        def timed(name):
            for _ in range(3):  # the first two negotiate: confirmation
                hvd.allreduce(x, name=name, op=hvd.Sum)
            torch.cuda.synchronize()
            rounds0 = svc.rounds
            t0 = time.perf_counter()
            for _ in range(CARD_CALLS):
                y = hvd.allreduce(x, name=name, op=hvd.Sum)
            torch.cuda.synchronize()
            return ((time.perf_counter() - t0) / CARD_CALLS * 1e3,
                    (svc.rounds - rounds0) / CARD_CALLS, y)

        out["served_ms"], out["served_rounds"], y = timed("steady")
        out["served_sum"] = y.cpu().numpy()[:4]
        os.environ["HVD_DYNAMIC_ENGINE"] = "0"
        out["plain_ms"], _, _ = timed(None)
        del os.environ["HVD_DYNAMIC_ENGINE"]
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


def _watchdog_rank(out_path: str, device: str | None = "cpu") -> None:
    """Named allreduces in a loop; ``HVD_FAULT_SPEC`` kills rank 1 at its
    sixth negotiated call. The others save which call failed, how, and
    how long after it began. On the card a survivor then exits without
    the teardown, which would wait for the dead rank's NCCL peer."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.exceptions import PeerFailureError

    hvd.init(device=device)
    out, dev = {"failed_at": -1}, hvd.device()
    try:
        for i in range(WATCHDOG_CALLS):
            t0 = time.monotonic()
            try:
                hvd.allreduce(torch.ones(4, device=dev), name=f"w{i}",
                              op=hvd.Sum)
            except PeerFailureError as e:
                out.update(failed_at=i, dead_rank=e.rank,
                           seconds=time.monotonic() - t0, error=str(e))
                break
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        if dev.type == "cuda":
            os._exit(0)
        hvd.shutdown()


def _watchdog_rank_on_card(out_path: str) -> None:
    _watchdog_rank(out_path, device=None)


def _timeline_rank_on_card(out_path: str) -> None:
    _timeline_rank(out_path, device=None)


def _timeline_rank(out_path: str, device: str | None = "cpu") -> None:
    """Named collectives under ``HVD_TIMELINE``: an allreduce of each of
    ``TIMELINE_NAMES``, a grouped allreduce and a broadcast; the file is
    closed at exit."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import timeline

    hvd.init(device=device)
    try:
        r, dev = hvd.rank(), hvd.device()
        out = {"active": timeline.timeline_active()}
        for i, name in enumerate(TIMELINE_NAMES):
            out[name] = hvd.allreduce(torch.full((3,), float(r + i),
                                                 device=dev),
                                      name=name, op=hvd.Sum).cpu().numpy()
        hvd.grouped_allreduce([torch.ones(2, device=dev)] * 2, name="grp")
        hvd.broadcast(torch.ones(2, device=dev), root_rank=0, name="bc")
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()
