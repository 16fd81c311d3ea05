"""The port's public API against the JAX package's.

The two ``__all__`` lists are equal up to the intended omissions (names of
JAX's single-controller mesh that have no counterpart where a process is a
rank, and an optax transform) and the port's own additions; the build
flags say what this build has; ``alltoall_async``, the in-place
``allreduce_``/``broadcast_`` and ``metric_average(process_set=)`` run in
gloo worlds of 2 and 4 (rank side :func:`_api_rank`, which imports no JAX)
and equal the JAX package's eager ``alltoall`` on the same per-rank
inputs, as a ``per_rank`` bundle on a process set of the first n devices
(integer-valued float32: bitwise); ``init(comm=)`` takes only the whole
world.
"""

import numpy as np
import pytest
import torch

import horovod_tpu
import horovod_tpu_torch as thvd
from test_torch_world2 import run_world

# names of the JAX package the port leaves out on purpose (ROADMAP A21)
INTENDED_OMISSIONS = {
    "AXIS_NAME", "axis_name", "mesh", "devices",  # the JAX device mesh
    "PerRank", "per_rank",  # single-controller input bundles
    "loopback",  # a world as threads of one controller
    "hierarchical_mesh",  # a jax.sharding.Mesh of the two levels
    "allreduce_gradients_transform",  # an optax transform
}
# the port's own names
PORT_ONLY = {"Compressor", "ResponseCacheJoinError", "device", "exceptions"}


def test_all_lists_are_equal_up_to_the_intended_omissions():
    jax_all, port_all = set(horovod_tpu.__all__), set(thvd.__all__)
    assert jax_all - port_all == INTENDED_OMISSIONS
    assert port_all - jax_all == PORT_ONLY
    for name in thvd.__all__:
        assert hasattr(thvd, name), name


# the name of horovod_tpu.elastic the port leaves out: TorchState takes
# JaxState's place
ELASTIC_OMISSIONS = {"JaxState"}
ELASTIC_PORT_ONLY = {"TorchState", "ElasticSampler", "NOTIFY_KEY"}


def test_elastic_and_runner_lists_equal_jax_up_to_the_omissions():
    import horovod_tpu.elastic as jel
    import horovod_tpu.runner as jrunner
    import horovod_tpu_torch.elastic as tel
    import horovod_tpu_torch.runner as trunner
    assert set(jel.__all__) - set(tel.__all__) == ELASTIC_OMISSIONS
    assert set(tel.__all__) - set(jel.__all__) == ELASTIC_PORT_ONLY
    assert sorted(trunner.__all__) == sorted(jrunner.__all__)
    for mod in (tel, trunner):
        for name in mod.__all__:
            assert hasattr(mod, name), name
    assert thvd.elastic is tel


def test_module_names_have_the_intended_omissions():
    """``models.transformer.param_shardings`` and
    ``parallel.mesh.layout_signature`` shard and key JAX programs."""
    from horovod_tpu.models import transformer as jt
    from horovod_tpu.parallel import mesh as jm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import mesh as tm
    assert hasattr(jt, "param_shardings") and not hasattr(
        tt, "param_shardings")
    assert hasattr(jm, "layout_signature") and not hasattr(
        tm, "layout_signature")
    for name in ("MeshLayout", "MeshLayoutError", "composed_mesh",
                 "sync_gradients"):
        assert getattr(thvd, name) is getattr(tm, name)


def test_build_flags_say_what_this_build_has():
    assert thvd.gloo_built() is True
    assert thvd.mpi_built() is False and thvd.mpi_enabled() is False
    assert thvd.xla_enabled() is False and thvd.xla_built() is False
    assert thvd.ccl_built() is False and thvd.ddl_built() is False
    assert thvd.tpu_built() is False
    assert thvd.rocm_built() is (torch.version.hip is not None)
    assert thvd.cuda_built() is torch.backends.cuda.is_built()
    assert thvd.__version__ == horovod_tpu.__version__
    # the flags the JAX package has, and no other
    flags = {n for n in horovod_tpu.__all__ if n.endswith(
        ("_built", "_enabled", "_supported"))}
    assert flags == {n for n in thvd.__all__ if n.endswith(
        ("_built", "_enabled", "_supported"))}


def test_world1_process_queries_and_gloo_enabled():
    thvd.init(device="cpu")
    try:
        assert thvd.process_rank() == thvd.rank() == 0
        assert thvd.process_count() == thvd.size() == 1
        assert thvd.local_ranks() == [0]
        assert thvd.process_of_rank(0) == 0
        with pytest.raises(ValueError):
            thvd.process_of_rank(1)
        assert thvd.gloo_enabled() is True
    finally:
        thvd.shutdown()
    assert thvd.gloo_enabled() is False


def test_value_and_grad_takes_mesh_spec():
    """At a world of one the layout's two-level sync is the identity: the
    gradients equal those of the plain reduction."""
    from horovod_tpu_torch.parallel import mesh as tm
    thvd.init(device="cpu")
    try:
        w = torch.linspace(-1, 1, 6)

        def fun(p):
            return (p ** 3).sum()

        plain = thvd.value_and_grad(fun)(w)
        for spec in (tm.default_layout(), tm.DATA_AXES):
            value, g = thvd.value_and_grad(fun, mesh_spec=spec)(w)
            assert torch.equal(value, plain[0]) and torch.equal(g, plain[1])
        assert torch.equal(thvd.grad(fun, mesh_spec=tm.DATA_AXES)(w),
                           plain[1])
        with pytest.raises(ValueError, match="process_set"):
            thvd.value_and_grad(fun, mesh_spec=tm.DATA_AXES,
                                process_set=thvd.global_process_set)
    finally:
        thvd.shutdown()


def test_init_comm_takes_the_whole_world_only():
    with pytest.raises(ValueError, match="whole world"):
        thvd.init(comm=[0, 1], device="cpu")
    thvd.init(comm=[0], device="cpu")
    try:
        assert thvd.size() == 1
    finally:
        thvd.shutdown()


def api_inputs(n: int) -> dict:
    """Each rank's inputs: integer-valued float32."""
    rng = np.random.default_rng(31 + n)
    return {"a2a": [rng.integers(-9, 10, (2 * n, 3)).astype(np.float32)
                    for _ in range(n)],
            "ar": [rng.integers(-9, 10, (5,)).astype(np.float32)
                   for _ in range(n)],
            "metric": [float(r + 1) for r in range(n)]}


def _api_rank(out_path: str) -> None:
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", process_sets=[[0, 1]])
    try:
        r, n = hvd.rank(), hvd.size()
        x = api_inputs(n)
        h = hvd.alltoall_async(torch.from_numpy(x["a2a"][r]))
        out = {"a2a": hvd.synchronize(h).numpy()}
        t = torch.from_numpy(x["ar"][r].copy())
        ptr = t.data_ptr()
        res = hvd.allreduce_(t, op=hvd.Sum)
        out["ar_"] = t.numpy()
        out["ar_same"] = res is t and t.data_ptr() == ptr
        b = torch.from_numpy(x["ar"][r].copy())
        hvd.broadcast_(b, root_rank=n - 1)
        out["bcast_"] = b.numpy()
        pset = hvd.runtime.process_set_table().find([0, 1])
        if r in (0, 1):
            out["metric_pset"] = hvd.metric_average(
                x["metric"][r], process_set=pset)
            out["metrics_pset"] = hvd.average_metrics(
                {"b": x["metric"][r], "a": 2 * x["metric"][r]},
                process_set=pset)["a"]
        out["metric_all"] = hvd.metric_average(x["metric"][r])
        out["flags"] = [hvd.gloo_enabled(), hvd.process_count(),
                        hvd.process_rank(), hvd.local_ranks()[0]]
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    return n, run_world("_api_rank", tmp_path_factory.mktemp(f"api{n}"),
                        size=n, module="test_torch_api")


@pytest.fixture
def pset(hvd, world):
    ps = hvd.add_process_set(list(range(world[0])))
    yield ps
    hvd.remove_process_set(ps)


def test_alltoall_async_matches_jax(hvd, world, pset):
    n, ranks = world
    want = np.asarray(hvd.alltoall(hvd.per_rank(api_inputs(n)["a2a"], pset),
                                   process_set=pset).array)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["a2a"], want[r])


def test_in_place_allreduce_and_broadcast_match_jax(hvd, world, pset):
    """The port's ``allreduce_``/``broadcast_`` write into their input and
    equal the JAX package's (which aliases the pure versions)."""
    n, ranks = world
    x = api_inputs(n)["ar"]
    want_ar = np.asarray(hvd.allreduce_(hvd.per_rank(x, pset), op=hvd.Sum,
                                        process_set=pset))
    want_b = np.asarray(hvd.broadcast_(hvd.per_rank(x, pset), n - 1,
                                       process_set=pset))
    for res in ranks:
        assert bool(res["ar_same"])
        np.testing.assert_array_equal(res["ar_"], want_ar)
        np.testing.assert_array_equal(res["bcast_"], want_b)


def test_metric_average_over_a_process_set_matches_jax(hvd, world):
    """``metric_average``/``average_metrics(process_set=)`` on ranks 0 and
    1: the JAX package's AVERAGE allreduce of the same float32 values over
    a set of two devices (what its ``metric_average`` runs)."""
    n, ranks = world
    metric = api_inputs(n)["metric"]
    two = hvd.add_process_set([0, 1])
    try:
        want = float(hvd.allreduce(
            hvd.per_rank([np.float32(m) for m in metric[:2]], two),
            op=hvd.Average, process_set=two))
    finally:
        hvd.remove_process_set(two)
    for r, res in enumerate(ranks):
        if r < 2:
            assert float(res["metric_pset"]) == want
            assert float(res["metrics_pset"]) == 2 * want
        assert float(res["metric_all"]) == sum(metric) / n
        assert res["flags"].tolist() == [True, n, r, r]


@pytest.mark.parametrize("exc,recoverable", [
    (RuntimeError("Connection closed by peer [10.0.0.2]:29500"), True),
    (RuntimeError("gloo barrier failed: rank 3"), True),
    (ValueError("all-reduce failed on rank 1"), True),
    (RuntimeError("shape mismatch in matmul"), False),
    (ValueError("service unavailable"), False),
    (KeyError("peer"), False),
])
def test_recoverable_errors_of_builtin_types_match_jax(exc, recoverable):
    """A builtin-typed exception is recoverable only by a phrase of the
    collective runtime, in both packages; ``wrap_internal_errors`` turns
    exactly those into ``HorovodInternalError``."""
    from horovod_tpu import exceptions as jexc
    from horovod_tpu_torch import exceptions as texc
    assert texc.is_recoverable_distributed_error(exc) is recoverable
    assert jexc.is_recoverable_distributed_error(exc) is recoverable

    def fail():
        raise exc

    want = texc.HorovodInternalError if recoverable else type(exc)
    with pytest.raises(want):
        texc.wrap_internal_errors(fail)()


def test_torch_distributed_errors_are_recoverable():
    """torch's ``DistBackendError`` (NCCL's errors) and the port's own
    types are the runtime's: broad markers apply to them, as the JAX
    package applies them to jaxlib's types."""
    import torch.distributed as dist
    from horovod_tpu_torch import exceptions as texc
    assert texc.is_recoverable_distributed_error(
        dist.DistBackendError("NCCL communicator was aborted on rank 2"))
    assert texc.is_recoverable_distributed_error(
        dist.DistNetworkError("Connection reset by peer"))
    assert not texc.is_recoverable_distributed_error(
        dist.DistBackendError("invalid argument"))
    hosts = texc.HostsUpdatedInterrupt(skip_sync=True)

    def interrupted():
        raise hosts

    with pytest.raises(texc.HostsUpdatedInterrupt):
        texc.wrap_internal_errors(interrupted)()
