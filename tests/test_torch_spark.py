"""The port's Spark integration (``horovod_tpu_torch/spark``) against the
JAX package's.

* **Contract.** The cases of ``tests/test_spark.py`` and
  ``tests/test_spark_estimator.py`` against the port over the same
  in-process stub of pyspark's barrier API (tasks as threads), with the
  estimator's recipe in torch's form: ``init_fn(generator, batch) ->
  nn.Module``, ``loss_fn(model, batch)``, ``optimizer`` a function of the
  parameters.
* **Parity.** The regression estimator (SGD at 0.05, seed 3, one task)
  gives the JAX ``fit``'s parameters on the same data to rtol 1e-5
  (float32 rounding of the same steps).
* **Worlds of processes.** Over :func:`horovod_tpu_torch.testing.
  make_process_pyspark` (a barrier task is a child process): ``run``
  forms a gloo world of 2, ranks bitwise equal, and ``fit`` over two
  tasks gives the one-task parameters to rtol 1e-5 (the mean of two
  half-batch means is the batch mean); the twins
  ``examples/spark_train.py`` and ``spark_estimator.py`` print SKIP
  without pyspark.

The JAX package and its tests' stubs are imported inside the tests only.
"""

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SGD = functools.partial(torch.optim.SGD, lr=0.05)


@pytest.fixture()
def restore_env():
    """Tasks seed the launcher's contract into the environment of the
    process they run in; put it back afterwards."""
    before = dict(os.environ)
    yield
    for k in [k for k in os.environ if k not in before]:
        del os.environ[k]
    os.environ.update(before)


@pytest.fixture()
def stub_pyspark(monkeypatch, restore_env):
    from test_spark import _StubBarrierContext, _StubSparkContext
    sc = _StubSparkContext()
    mod = types.ModuleType("pyspark")
    mod.SparkContext = types.SimpleNamespace(_active_spark_context=sc)
    mod.BarrierTaskContext = _StubBarrierContext
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    return sc


@pytest.fixture()
def process_pyspark(monkeypatch, restore_env):
    from horovod_tpu_torch import testing
    mod = testing.make_process_pyspark(default_parallelism=2)
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    return mod.SparkContext._active_spark_context


# ---------------------------------------------------------------------------
# tests/test_spark.py against the port
# ---------------------------------------------------------------------------

def test_spark_run_returns_rank_ordered_results(stub_pyspark):
    import horovod_tpu_torch.spark as spark
    assert spark.run(lambda x: x * 2, args=(21,), num_proc=3) == [42] * 3


def test_spark_run_default_num_proc(stub_pyspark):
    import horovod_tpu_torch.spark as spark
    assert len(spark.run(lambda: "ok")) == stub_pyspark.defaultParallelism


def test_spark_run_seeds_launcher_env(stub_pyspark):
    import horovod_tpu_torch.spark as spark
    envs = spark.run(lambda: {k: v for k, v in os.environ.items()
                              if k.startswith("HVD_") or k in (
                                  "MY_FLAG", "WORLD_SIZE", "MASTER_PORT")},
                     num_proc=2, env={"MY_FLAG": "7"})
    for env in envs:
        assert env["HVD_SIZE"] == env["WORLD_SIZE"] == "2"
        assert env["HVD_NUM_PROCESSES"] == "2"
        assert env["HVD_KV_ADDR"] and env["HVD_KV_PORT"]
        assert env["HVD_COORDINATOR_ADDR"]
        assert env["HVD_COORDINATOR_PORT"] == env["MASTER_PORT"] != "0"
        assert env["HVD_SECRET_KEY"]
        assert env["HVD_CUDA_DEVICE"] in ("0", "1")  # its local rank
        assert env["MY_FLAG"] == "7"


class _Gpu:
    def __init__(self, addresses):
        self.name, self.addresses = "gpu", addresses


class _Ctx:
    def __init__(self, resources):
        self._resources = resources

    def resources(self):
        return self._resources


@pytest.mark.parametrize("ctx,local_rank,want", [
    (_Ctx({"gpu": _Gpu(["3"])}), 1, 3),   # Spark's GPU scheduling
    (_Ctx({"gpu": _Gpu(["2", "5"])}), 0, 2),
    (_Ctx({"gpu": _Gpu([])}), 1, 1),
    (_Ctx({}), 1, 1),                     # no GPU resource: the local rank
    (object(), 0, 0),                     # a context without resources()
], ids=["one-gpu", "two-gpus", "no-address", "no-gpu", "no-resources"])
def test_spark_task_card(ctx, local_rank, want):
    """A task drives the GPU Spark gave it, by the machine's own ordinal
    (Spark leaves ``CUDA_VISIBLE_DEVICES`` alone), else its local rank."""
    from horovod_tpu_torch.spark import _task_card
    assert _task_card(ctx, local_rank) == want


def test_spark_run_propagates_worker_errors(stub_pyspark):
    import horovod_tpu_torch.spark as spark

    def boom():
        raise ValueError("rank exploded")

    with pytest.raises(ValueError, match="rank exploded"):
        spark.run(boom, num_proc=2)


def test_spark_run_timeout_covers_startup_only(stub_pyspark):
    import time

    import horovod_tpu_torch.spark as spark
    assert spark.run(lambda: time.sleep(1.0) or "slow-ok", num_proc=2,
                     start_timeout=0.3) == ["slow-ok", "slow-ok"]


def test_spark_run_timeout_cancels_unscheduled_job(stub_pyspark):
    import horovod_tpu_torch.spark as spark
    stub_pyspark.hang_tasks = True
    with pytest.raises(TimeoutError, match="barrier"):
        spark.run(lambda: 1, num_proc=2, start_timeout=0.3)
    assert stub_pyspark.cancelled


def test_spark_run_requires_active_context(monkeypatch):
    import horovod_tpu_torch.spark as spark
    mod = types.ModuleType("pyspark")
    mod.SparkContext = types.SimpleNamespace(_active_spark_context=None)
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    with pytest.raises(RuntimeError, match="SparkContext"):
        spark.run(lambda: 1, num_proc=1)


def test_module_imports_without_pyspark(monkeypatch):
    import horovod_tpu_torch.spark as spark
    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError):
        spark.run(lambda: 1, num_proc=1)


# ---------------------------------------------------------------------------
# tests/test_spark_estimator.py against the port, in torch's form
# ---------------------------------------------------------------------------

def _make_regression(n=256, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_true = np.arange(1.0, d + 1.0, dtype=np.float32)[:, None]
    y = (x @ w_true)[:, 0] + 0.5
    return x, y.astype(np.float32)


def _init_fn(generator, batch):
    x, _ = batch
    model = torch.nn.Linear(x.shape[1], 1)
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    return model


def _loss_fn(model, batch):
    x, y = batch
    return ((model(x)[:, 0] - y) ** 2).mean()


def _mse(params, x, y):
    pred = x @ params["weight"][0] + params["bias"][0]
    return float(np.mean((pred - y) ** 2))


ZERO = {"weight": np.zeros((1, 4)), "bias": np.zeros(1)}


def test_fit_trains_from_arrays(stub_pyspark):
    import horovod_tpu_torch.spark as spark
    x, y = _make_regression()
    params = spark.fit((x, y), _init_fn, _loss_fn, optimizer=SGD, epochs=5,
                       batch_size=64, num_proc=1, seed=3, device="cpu")
    assert _mse(params, x, y) < 0.1 * _mse(ZERO, x, y)
    assert isinstance(params["weight"], np.ndarray)


def test_fit_checkpoints_and_resumes(tmp_path):
    from horovod_tpu_torch.spark import estimator as est
    x, y = _make_regression(n=128)
    store = str(tmp_path / "store")
    args = ((x, y), _init_fn, _loss_fn, SGD)
    out1 = est._fit_task(*args, 2, 64, True, 0, store, "cpu")
    assert out1["epochs_run"] == 2
    out2 = est._fit_task(*args, 2, 64, True, 0, store, "cpu")
    assert out2["epochs_run"] == 0
    np.testing.assert_array_equal(out2["params"]["weight"],
                                  out1["params"]["weight"])
    out3 = est._fit_task(*args, 4, 64, True, 0, store, "cpu")
    assert out3["epochs_run"] == 2
    assert _mse(out3["params"], x, y) <= _mse(out1["params"], x, y) + 1e-6
    # resumed from the Store, bitwise a 4-epoch run from scratch
    fresh = est._fit_task(*args, 4, 64, True, 0, str(tmp_path / "b"), "cpu")
    for k in fresh["params"]:
        np.testing.assert_array_equal(out3["params"][k], fresh["params"][k])


def test_fit_resumes_adam_moments(tmp_path):
    """The optimizer's state resumes with the parameters: Adam split 2 + 1
    epochs over the Store equals 3 epochs in one run, bitwise."""
    from horovod_tpu_torch.spark import estimator as est
    x, y = _make_regression(n=128)
    args = ((x, y), _init_fn, _loss_fn, None)
    est._fit_task(*args, 2, 32, True, 1, str(tmp_path / "a"), "cpu")
    resumed = est._fit_task(*args, 3, 32, True, 1, str(tmp_path / "a"),
                            "cpu")
    fresh = est._fit_task(*args, 3, 32, True, 1, None, "cpu")
    assert resumed["epochs_run"] == 1 and fresh["epochs_run"] == 3
    for k in fresh["params"]:
        np.testing.assert_array_equal(resumed["params"][k],
                                      fresh["params"][k])


def test_save_dataset_roundtrip(tmp_path, stub_pyspark):
    import horovod_tpu_torch.spark as spark
    from horovod_tpu_torch.spark import estimator as est
    x, y = _make_regression(n=128)
    path = est.save_dataset(str(tmp_path / "store"), x, y)
    params = spark.fit(path, _init_fn, _loss_fn, optimizer=SGD, epochs=3,
                       batch_size=64, num_proc=1, device="cpu")
    assert _mse(params, x, y) < _mse(ZERO, x, y)


def test_fit_dataframe_materializes_then_trains(stub_pyspark, tmp_path):
    from test_spark_estimator import _StubDataFrame

    import horovod_tpu_torch.spark as spark
    x, y = _make_regression(n=96, d=2)
    rows = [{"f0": float(a), "f1": float(b), "label": float(t)}
            for (a, b), t in zip(x, y)]
    params = spark.fit_dataframe(
        _StubDataFrame(rows), ["f0", "f1"], ["label"], _init_fn, _loss_fn,
        store_path=str(tmp_path / "store"), optimizer=SGD, epochs=4,
        batch_size=32, num_proc=1, device="cpu")
    zero = {"weight": np.zeros((1, 2)), "bias": np.zeros(1)}
    assert _mse(params, x, y) < 0.5 * _mse(zero, x, y)
    assert (tmp_path / "store" / "dataset.npz").exists()


# ---------------------------------------------------------------------------
# parity with the JAX package's fit
# ---------------------------------------------------------------------------

FIT_RTOL = 1e-5


def test_regression_fit_equals_jax(stub_pyspark):
    import optax
    from test_spark_estimator import _init_fn as jax_init
    from test_spark_estimator import _loss_fn as jax_loss

    import horovod_tpu.spark as jax_spark
    import horovod_tpu_torch.spark as spark
    x, y = _make_regression()
    want = jax_spark.fit((x, y), jax_init, jax_loss,
                         optimizer=optax.sgd(0.05), epochs=5, batch_size=64,
                         num_proc=1, seed=3)
    got = spark.fit((x, y), _init_fn, _loss_fn, optimizer=SGD, epochs=5,
                    batch_size=64, num_proc=1, seed=3, device="cpu")
    np.testing.assert_allclose(got["weight"], np.asarray(want["w"]).T,
                               rtol=FIT_RTOL)
    np.testing.assert_allclose(got["bias"], np.asarray(want["b"]),
                               rtol=FIT_RTOL)


# ---------------------------------------------------------------------------
# worlds of processes over the process stub
# ---------------------------------------------------------------------------

def test_spark_run_gloo_world_of_two_processes(process_pyspark):
    from test_torch_ray import _gloo_rank

    import horovod_tpu_torch.spark as spark
    got = spark.run(_gloo_rank, num_proc=2)
    assert [r["rank"] for r in got] == [0, 1]
    assert all(r["size"] == 2 for r in got)
    assert len({r["pid"] for r in got}) == 2 and os.getpid() not in {
        r["pid"] for r in got}
    assert [r["card"] for r in got] == ["0", "1"]  # the slot's local rank
    assert got[0]["digest"] == got[1]["digest"]
    assert not any(p.is_alive() for p in process_pyspark.tasks)


def test_fit_over_two_task_processes_equals_one(stub_pyspark,
                                                monkeypatch):
    """``fit`` at a gloo world of 2 (process tasks) against 1 (the
    in-process stub): the same SGD steps on the averaged gradient."""
    import horovod_tpu_torch.spark as spark
    from horovod_tpu_torch import testing
    x, y = _make_regression()
    one = spark.fit((x, y), _init_fn, _loss_fn, optimizer=SGD, epochs=3,
                    batch_size=64, num_proc=1, seed=3, device="cpu")
    monkeypatch.setitem(sys.modules, "pyspark",
                        testing.make_process_pyspark())
    two = spark.fit((x, y), _init_fn, _loss_fn, optimizer=SGD, epochs=3,
                    batch_size=64, num_proc=2, seed=3, device="cpu")
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=FIT_RTOL)


@pytest.mark.parametrize("twin", ["spark_train", "spark_estimator"])
def test_spark_twin_skips_without_pyspark(twin):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.examples.{twin}"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "SKIP: pyspark not installed" in res.stdout
