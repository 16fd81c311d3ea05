"""The port's Ray integration (``horovod_tpu_torch/ray``) against the JAX
package's.

* **Contract.** The cases of ``tests/test_ray.py`` and
  ``tests/test_ray_elastic.py`` against the port, over the same in-process
  stubs of the Ray API (actors as objects, or as threads for the elastic
  driver's node death and replacement).
* **Parity.** ``RayHostDiscovery`` gives the JAX one's hosts from the same
  cluster states; a rank's launcher contract (``worker_env``) holds the
  JAX package's ``HVD_*`` keys and values, and the card of its node.
* **Worlds of processes.** Over :func:`horovod_tpu_torch.testing.
  make_process_ray` (an actor is a child process): ``RayExecutor`` and
  ``ElasticRayExecutor`` run a gloo world of 2, ranks bitwise equal; the
  twin ``examples/ray_train.py`` runs static and elastic, and prints SKIP
  without Ray.

The JAX package and its tests' stubs are imported inside the tests only:
a rank process imports this file for its functions and none of JAX.
"""

import hashlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def restore_env():
    """In-process stub actors seed the launcher's contract into this
    process's environment; put it back afterwards."""
    before = dict(os.environ)
    yield
    for k in [k for k in os.environ if k not in before]:
        del os.environ[k]
    os.environ.update(before)


@pytest.fixture()
def stub_ray(monkeypatch, restore_env):
    from test_ray import _make_stub_ray
    ray = _make_stub_ray()
    monkeypatch.setitem(sys.modules, "ray", ray)
    return ray


@pytest.fixture()
def process_ray(monkeypatch, restore_env):
    from horovod_tpu_torch import testing
    ray = testing.make_process_ray({"127.0.0.1": 2})
    monkeypatch.setitem(sys.modules, "ray", ray)
    yield ray
    ray.shutdown()


# ---------------------------------------------------------------------------
# tests/test_ray.py against the port
# ---------------------------------------------------------------------------

def test_ray_executor_runs_fn_per_worker(stub_ray):
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=3)
    ex.start()
    try:
        assert ex.run(lambda x: x * 2, args=(21,)) == [42, 42, 42]
        assert ex.execute_single(lambda: "rank0") == "rank0"
    finally:
        ex.shutdown()


def test_ray_executor_seeds_launcher_env(stub_ray):
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=2, env_vars={"MY_FLAG": "7"})
    ex.start()
    try:
        envs = ex.run(lambda: {k: v for k, v in os.environ.items()
                               if k.startswith("HVD_") or k in (
                                   "MY_FLAG", "MASTER_ADDR", "WORLD_SIZE")})
        for env in envs:
            assert env["HVD_SIZE"] == env["WORLD_SIZE"] == "2"
            assert env["HVD_NUM_PROCESSES"] == "2"
            assert env["HVD_KV_ADDR"] and env["HVD_KV_PORT"]
            assert env["HVD_COORDINATOR_ADDR"] == env["MASTER_ADDR"] \
                == "127.0.0.1"
            assert env["HVD_SECRET_KEY"]
            assert env["MY_FLAG"] == "7"
        slots_env = [ex._rdv.worker_env(s) for s in ex._build_slots(
            ["127.0.0.1", "127.0.0.1"])]
        assert [e["HVD_RANK"] for e in slots_env] == ["0", "1"]
        assert [e["HVD_LOCAL_RANK"] for e in slots_env] == ["0", "1"]
    finally:
        ex.shutdown()


def test_ray_executor_multi_host_slots(stub_ray):
    from horovod_tpu_torch.ray import RayExecutor
    slots = RayExecutor(num_workers=4)._build_slots(["h1", "h1", "h2", "h2"])
    assert [s.rank for s in slots] == [0, 1, 2, 3]
    assert [s.local_rank for s in slots] == [0, 1, 0, 1]
    assert [s.cross_rank for s in slots] == [0, 0, 1, 1]
    assert all(s.cross_size == 2 and s.local_size == 2 for s in slots)


def test_ray_executor_requires_start(stub_ray):
    from horovod_tpu_torch.ray import RayExecutor
    with pytest.raises(RuntimeError, match="start"):
        RayExecutor(num_workers=1).run(lambda: 1)


@pytest.mark.parametrize("cls", ["RayExecutor", "ElasticRayExecutor"])
def test_module_imports_without_ray(cls, monkeypatch):
    import horovod_tpu_torch.ray as tray
    monkeypatch.setitem(sys.modules, "ray", None)
    ex = (tray.RayExecutor(num_workers=2) if cls == "RayExecutor"
          else tray.ElasticRayExecutor(min_workers=1))
    with pytest.raises((ImportError, RuntimeError)):
        ex.start()


# ---------------------------------------------------------------------------
# tests/test_ray_elastic.py against the port
# ---------------------------------------------------------------------------

def test_ray_host_discovery_parses_cluster_state():
    from test_ray_elastic import _Cluster, _make_stub_ray

    from horovod_tpu_torch.ray import RayHostDiscovery
    cluster = _Cluster({"10.0.0.1": 4, "10.0.0.2": 2, "10.0.0.3": 0})
    disc = RayHostDiscovery(_make_stub_ray(cluster), cpus_per_worker=2)
    assert disc.find_available_hosts_and_slots() == {
        "10.0.0.1": 2, "10.0.0.2": 1}
    disc2 = RayHostDiscovery(_make_stub_ray(_Cluster({"10.0.0.1": 8})),
                             cpus_per_worker=1,
                             resources_per_worker={"TPU": 1})
    assert disc2.find_available_hosts_and_slots() == {}


def test_elastic_ray_node_death_and_replacement(monkeypatch, restore_env):
    """A worker's node dies mid-round; the driver blacklists it, discovery
    finds a replacement, a new round starts, the survivor re-registers
    and the replacement syncs through the KV store (the JAX test's
    scenario, actors as threads)."""
    from test_ray_elastic import _Cluster, _make_stub_ray

    import horovod_tpu_torch.ray.elastic as ray_elastic
    from horovod_tpu_torch.elastic.driver import (ROUND_KEY, ROUND_SPEC_KEY,
                                                  done_key, ready_key)
    from horovod_tpu_torch.ray import ElasticRayExecutor
    from horovod_tpu_torch.runner.http_kv import KVClient

    cluster = _Cluster({"10.0.0.1": 1, "10.0.0.2": 1})
    monkeypatch.setitem(sys.modules, "ray", _make_stub_ray(cluster))

    def stub_cls_factory(_ray):
        class _W:  # passes the env to fn: threads share os.environ
            def execute(self, env, fn, args, kwargs):
                try:
                    return ("ok", fn(env, *args, **(kwargs or {})))
                except SystemExit as e:
                    return ("exit", int(e.code or 0))
        return _W

    monkeypatch.setattr(ray_elastic, "_make_elastic_worker_cls",
                        stub_cls_factory)

    def worker_fn(env):
        kv = KVClient(env["HVD_KV_ADDR"], int(env["HVD_KV_PORT"]),
                      secret=env["HVD_SECRET_KEY"])
        host, slot = env["HVD_HOSTNAME"], int(env["HVD_LOCAL_RANK"])
        rnd = int(env["HVD_ELASTIC_ROUND"])
        kv.put(ready_key(rnd, host, slot), b"1")
        if host == "10.0.0.2":
            cluster.kill("10.0.0.2")
            cluster.add("10.0.0.3")
            raise RuntimeError("node lost")
        deadline = time.monotonic() + 60
        if rnd == 1:
            while True:
                raw = kv.get(ROUND_KEY)
                if raw is not None and int(raw) > 1:
                    new_round = int(raw)
                    break
                assert time.monotonic() < deadline, "no new round"
                time.sleep(0.1)
            spec = pickle.loads(kv.get(ROUND_SPEC_KEY.format(new_round)))
            assert any(s["hostname"] == "10.0.0.3" for s in spec["slots"])
            kv.put("test/state", b"step=7")
            kv.put(ready_key(new_round, host, slot), b"1")
        else:
            while kv.get("test/state") is None:
                assert time.monotonic() < deadline, "state never synced"
                time.sleep(0.1)
        kv.put(done_key(host, slot), b"1")
        return f"{host}/{slot}"

    ex = ElasticRayExecutor(min_workers=2, elastic_timeout=60)
    ex.start()
    try:
        results = ex.run(worker_fn)
    finally:
        ex.shutdown()
    assert sorted(results) == ["10.0.0.1/0", "10.0.0.3/0"]


def test_elastic_ray_requires_start():
    from horovod_tpu_torch.ray import ElasticRayExecutor
    with pytest.raises(RuntimeError, match="start"):
        ElasticRayExecutor(min_workers=1).run(lambda env: None)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

CLUSTERS = {
    "cpus": ({"10.0.0.1": 4, "10.0.0.2": 2, "10.0.0.3": 0}, 2, None, None),
    "resources": ({"10.0.0.1": 8, "10.0.0.2": 3}, 1, {"CPU": 2}, None),
    "capped": ({"10.0.0.1": 16, "10.0.0.2": 1}, 1, None, 3),
    "missing_resource": ({"10.0.0.1": 8}, 1, {"GPU": 1}, None),
}


@pytest.mark.parametrize("case", sorted(CLUSTERS))
def test_host_discovery_equals_jax(case):
    from test_ray_elastic import _Cluster, _make_stub_ray

    from horovod_tpu.ray import RayHostDiscovery as JaxDiscovery
    from horovod_tpu_torch.ray import RayHostDiscovery
    hosts, cpus, resources, cap = CLUSTERS[case]
    ray = _make_stub_ray(_Cluster(hosts))
    got = RayHostDiscovery(ray, cpus, resources,
                           cap).find_available_hosts_and_slots()
    want = JaxDiscovery(ray, cpus, resources,
                        cap).find_available_hosts_and_slots()
    assert got == want


@pytest.mark.parametrize("ips", [["127.0.0.1"] * 2, ["h1", "h1", "h2"],
                                 ["h1", "h2", "h3", "h1"]])
def test_worker_env_holds_the_jax_contract(ips):
    from horovod_tpu.runner import hosts as jhosts
    from horovod_tpu.runner.launch import worker_env as jax_worker_env
    from horovod_tpu_torch.runner import hosts
    from horovod_tpu_torch.runner.launch import worker_env
    kw = dict(coordinator_addr=ips[0], coordinator_port=23456,
              kv_addr="10.1.1.1", kv_port=4567, secret="s3", extra={"X": "1"})
    for slot, jslot in zip(hosts.slots_from_ips(ips),
                           jhosts.slots_from_ips(ips)):
        got = worker_env(slot, card=slot.local_rank, **kw)
        want = jax_worker_env(jslot, **kw)
        hvd = {k: v for k, v in want.items() if k.startswith("HVD_")}
        assert {k: got[k] for k in hvd} == hvd
        assert set(k for k in got if k.startswith("HVD_")) - set(hvd) == {
            "HVD_CUDA_DEVICE"}
        assert got["HVD_CUDA_DEVICE"] == str(slot.local_rank)
        assert (got["RANK"], got["WORLD_SIZE"], got["MASTER_ADDR"],
                got["MASTER_PORT"]) == (hvd["HVD_RANK"], hvd["HVD_SIZE"],
                                        ips[0], "23456")


# ---------------------------------------------------------------------------
# worlds of processes over the process stub
# ---------------------------------------------------------------------------

STEPS = 4


def _gloo_rank(steps: int = STEPS) -> dict:
    """A rank of a gloo world: a few data-parallel SGD steps on its own
    rows; returns its place, its card and a digest of its parameters."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    rng = np.random.default_rng(hvd.rank())
    x = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    y = x.sum(1, keepdim=True)
    model = torch.nn.Linear(4, 1)
    model.load_state_dict({"weight": torch.zeros(1, 4),
                           "bias": torch.zeros(1)})
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    for _ in range(steps):
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        opt.step()
    out = {"rank": hvd.rank(), "size": hvd.size(),
           "card": os.environ.get("HVD_CUDA_DEVICE"), "pid": os.getpid(),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "digest": hashlib.sha256(b"".join(
               p.detach().numpy().tobytes()
               for p in model.parameters())).hexdigest()}
    hvd.shutdown()
    return out


def _elastic_rank(steps: int = STEPS) -> dict:
    """A rank under ``hvd.elastic.run`` with ``TorchState``, committing
    every step."""
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    model = torch.nn.Linear(4, 1)
    model.load_state_dict({"weight": torch.zeros(1, 4),
                           "bias": torch.zeros(1)})
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0)
    x = torch.arange(8.0 * (hvd.rank() + 1), 8.0 * (hvd.rank() + 1) + 32
                     ).reshape(8, 4) / 32.0
    y = x.sum(1, keepdim=True)

    @hvd.elastic.run
    def train(state):
        while state.step < steps:
            opt.zero_grad()
            ((model(x) - y) ** 2).mean().backward()
            opt.step()
            state.step += 1
            state.commit()
        return state.step

    done = train(state)
    out = {"rank": hvd.rank(), "size": hvd.size(), "steps": done,
           "card": os.environ.get("HVD_CUDA_DEVICE"),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "digest": hashlib.sha256(b"".join(
               p.detach().numpy().tobytes()
               for p in model.parameters())).hexdigest()}
    hvd.shutdown()
    return out


def test_ray_executor_gloo_world_of_two_processes(process_ray):
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=2)
    ex.start()
    try:
        got = ex.run(_gloo_rank)
        pids = {a.process.pid for a in process_ray.actors}
    finally:
        ex.shutdown()
    assert [r["rank"] for r in got] == [0, 1]
    assert all(r["size"] == 2 for r in got)
    assert {r["pid"] for r in got} == pids and os.getpid() not in pids
    assert [r["card"] for r in got] == ["0", "1"]  # one card an actor
    assert got[0]["digest"] == got[1]["digest"]
    assert not any(a.process.is_alive() for a in process_ray.actors)


def test_elastic_ray_executor_gloo_world_of_two_processes(process_ray):
    from horovod_tpu_torch.ray import ElasticRayExecutor
    ex = ElasticRayExecutor(min_workers=2, max_workers=2,
                            elastic_timeout=120)
    ex.start()
    try:
        got = sorted(ex.run(_elastic_rank), key=lambda r: r["rank"])
    finally:
        ex.shutdown()
    assert [r["rank"] for r in got] == [0, 1]
    assert all(r["size"] == 2 and r["steps"] == STEPS for r in got)
    assert sorted(r["card"] for r in got) == ["0", "1"]
    assert got[0]["digest"] == got[1]["digest"]
    # an actor whose worker settled is ended: its card is free
    assert not any(a.process.is_alive() for a in process_ray.actors)


@pytest.fixture()
def process_ray_gpus(monkeypatch, restore_env):
    """The process stub of a cluster whose node offers Ray two GPUs."""
    from horovod_tpu_torch import testing
    ray = testing.make_process_ray({"127.0.0.1": 2}, gpus=2)
    monkeypatch.setitem(sys.modules, "ray", ray)
    yield ray
    ray.shutdown()


def test_ray_executor_takes_the_gpus_ray_gives(process_ray_gpus):
    """On a cluster that offers GPUs each actor asks Ray for one, sees
    only that one (Ray narrows ``CUDA_VISIBLE_DEVICES``) and drives it as
    its card 0; the card pool is not asked."""
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=2)
    ex.start()
    try:
        got = ex.run(_gloo_rank)
        asked = [a.gpu_ids for a in process_ray_gpus.actors]
    finally:
        ex.shutdown()
    assert asked == [[0], [1]]
    assert [r["card"] for r in got] == ["0", "0"]
    assert [r["visible"] for r in got] == ["0", "1"]
    assert got[0]["digest"] == got[1]["digest"]


def test_elastic_ray_executor_takes_the_gpus_ray_gives(process_ray_gpus):
    from horovod_tpu_torch.ray import ElasticRayExecutor
    ex = ElasticRayExecutor(min_workers=2, max_workers=2,
                            elastic_timeout=120)
    ex.start()
    try:
        got = sorted(ex.run(_elastic_rank), key=lambda r: r["rank"])
    finally:
        ex.shutdown()
    assert all(r["size"] == 2 and r["steps"] == STEPS for r in got)
    assert [r["card"] for r in got] == ["0", "0"]
    assert sorted(r["visible"] for r in got) == ["0", "1"]
    assert got[0]["digest"] == got[1]["digest"]


def test_ray_host_discovery_offers_a_slot_a_gpu():
    """Where the cluster offers GPUs an actor asks for one, so a node has
    no more slots than GPUs (a node without any, none)."""
    from horovod_tpu_torch.ray import RayHostDiscovery

    class Ray:
        @staticmethod
        def nodes():
            return [{"NodeManagerAddress": ip, "Alive": True,
                     "Resources": {"CPU": cpus, **({"GPU": g} if g else {})}}
                    for ip, cpus, g in (("10.0.0.1", 8.0, 2.0),
                                        ("10.0.0.2", 8.0, 0.0),
                                        ("10.0.0.3", 1.0, 4.0))]

    assert RayHostDiscovery(Ray).find_available_hosts_and_slots() == {
        "10.0.0.1": 2, "10.0.0.3": 1}


@pytest.mark.parametrize("argv,want", [
    ([], "SKIP: ray not installed"),
    (["--smoke", "--device", "cpu", "--process-stub", "--elastic"], "OK"),
])
def test_ray_train_twin(argv, want):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.ray_train",
         *argv], capture_output=True, text=True, timeout=240, cwd=REPO,
        env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert want in res.stdout
