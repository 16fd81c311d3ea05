"""The port's training-loop pieces against the JAX package's, on the CPU:
learning-rate schedules, ``ShardedArrayLoader``, ``average_metrics``, and
the two entry points (twins of ``examples/synthetic_benchmark.py`` and
``examples/mnist.py``).

Schedules: the port's (Python floats) against the JAX ones (float32) at
every step of four epochs, rtol 1e-6. Loader: the union of the ranks'
shards, in rank order, equals the JAX loader's global batch exactly, at a
world of one (this process) and two (a spawned gloo world,
:func:`test_torch_world2.run_world`), over three epochs, with and without
the trailing partial batch. ``average_metrics`` at world 2: the exact mean.
The MNIST twin's ``ConvNet`` against the JAX example's, float32 logits rtol
1e-5 atol 1e-5, and its data bitwise.
"""

import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.optim.lr_scheduler import LambdaLR

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu_torch import runtime
from horovod_tpu_torch.callbacks import lr_schedule, warmup_schedule
from horovod_tpu_torch.data import ShardedArrayLoader
from horovod_tpu_torch.examples import mnist, synthetic_benchmark
from horovod_tpu_torch.models import from_flax_variables
from test_torch_convnets import torch_threads  # noqa: F401 (a fixture)
from test_torch_world2 import (LOADER_BATCH, LOADER_EPOCHS, loader_arrays,
                               loader_shards, run_world)

REPO = Path(__file__).resolve().parent.parent
STEPS_PER_EPOCH = 7


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("staircase", [True, False])
@pytest.mark.parametrize("multiplier", [0.5, lambda e: 1.0 / (1 + e)],
                         ids=["constant", "callable"])
def test_lr_schedule_matches_jax(multiplier, staircase):
    kw = dict(steps_per_epoch=STEPS_PER_EPOCH, start_epoch=1, end_epoch=3,
              staircase=staircase)
    ours = lr_schedule(0.1, multiplier, **kw)
    ref = jhvd.callbacks.lr_schedule(0.1, multiplier, **kw)
    for step in range(4 * STEPS_PER_EPOCH):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("size", [1, 4, 8])
def test_warmup_schedule_matches_jax(size):
    kw = dict(steps_per_epoch=STEPS_PER_EPOCH, warmup_epochs=2, size=size)
    ours = warmup_schedule(0.4, **kw)
    ref = jhvd.callbacks.warmup_schedule(0.4, **kw)
    for step in range(4 * STEPS_PER_EPOCH):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   err_msg=f"step {step}")
    assert math.isclose(ours(0), 0.4 / size * (1 + (size - 1) / 14))


def test_lambda_lr_takes_the_wrapped_optimizer():
    """``LambdaLR`` refuses ``DistributedOptimizer``, which is no
    ``torch.optim.Optimizer``; given ``opt.optimizer`` it drives the rate
    along the schedule, one ``sched.step()`` after each update."""
    param = torch.nn.Parameter(torch.zeros(3))
    opt = thvd.DistributedOptimizer(torch.optim.SGD([param], lr=0.4))
    schedule = warmup_schedule(0.4, steps_per_epoch=STEPS_PER_EPOCH,
                               warmup_epochs=1, size=4)
    with pytest.raises(TypeError):
        LambdaLR(opt, lambda s: schedule(s) / 0.4)
    sched = LambdaLR(opt.optimizer, lambda s: schedule(s) / 0.4)
    for step in range(2 * STEPS_PER_EPOCH):
        assert math.isclose(opt.param_groups[0]["lr"], schedule(step),
                            rel_tol=1e-12)
        opt.optimizer.step()
        sched.step()


def _jax_batches() -> dict:
    """The JAX loader's global batches, keyed as
    :func:`test_torch_world2.loader_shards` keys the shards."""
    out = {}
    for drop in (True, False):
        loader = jhvd.data.ShardedArrayLoader(
            *loader_arrays(), batch_size=LOADER_BATCH, seed=5,
            drop_remainder=drop)
        for epoch in range(LOADER_EPOCHS):
            loader.set_epoch(epoch)
            for i, (x, y) in enumerate(loader):
                out[f"{drop}_e{epoch}_b{i}_x"] = np.asarray(x)
                out[f"{drop}_e{epoch}_b{i}_y"] = np.asarray(y)
    return out


def _check_union(ranks: list) -> None:
    want = _jax_batches()
    assert set(ranks[0]) >= set(want) and len(want) == 2 * (
        LOADER_EPOCHS * 3 + LOADER_EPOCHS * 4)
    for key, batch in want.items():
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_array_equal(got, batch, err_msg=key)


def test_loader_world1_matches_jax_global_batches():
    """Outside a world (a world of one) the loader yields whole global
    batches, as tensors on the device it is given."""
    _check_union([loader_shards()])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("_training_utils_rank",
                     tmp_path_factory.mktemp("training_utils"))


def test_loader_world2_union_matches_jax_global_batches(world2):
    """Rank r holds rows [r * 8, (r + 1) * 8) of each global batch of 16."""
    _check_union(world2)
    assert all(len(v) == LOADER_BATCH // 2 for k, v in world2[1].items()
               if k.startswith("True_") and k.endswith("_y"))


def test_average_metrics_world2_is_the_mean(world2):
    for res in world2:
        assert list(res["metric_keys"]) == ["accuracy", "loss"]
        assert float(res["metric_loss"]) == 1.5
        assert float(res["metric_accuracy"]) == 0.375


def test_loader_divisibility_errors_match_jax(monkeypatch):
    """A global batch that does not divide by the world size, or a kept
    trailing batch that does not, raises as the JAX loader does."""
    x, y = loader_arrays()
    with pytest.raises(ValueError, match="divide"):
        list(jhvd.data.ShardedArrayLoader(x, y, batch_size=12))  # size 8
    monkeypatch.setattr(runtime, "_state", runtime._RuntimeState(
        device=torch.device("cpu"), rank=0, size=3, local_rank=0,
        local_size=3, owns_group=False))
    with pytest.raises(ValueError, match="divide"):
        list(ShardedArrayLoader(x, y, batch_size=16))
    with pytest.raises(ValueError, match="drop_remainder"):
        list(ShardedArrayLoader(x, y, batch_size=12, drop_remainder=False))
    assert len(ShardedArrayLoader(x, y, batch_size=12)) == 4
    assert len(ShardedArrayLoader(x, y, batch_size=12,
                                  drop_remainder=False)) == 5


def test_mnist_twin_data_and_convnet_match_the_jax_example():
    """The twin's own ``synthetic_mnist`` equals the example's bitwise, and
    its ``ConvNet`` (stride-2 ``"SAME"`` convs padded (0, 1) on 28 and 14,
    NHWC flattening) gives the example's logits from the same weights."""
    example = _jax_example("mnist")
    images, labels = mnist.synthetic_mnist(64, seed=3)
    ref_images, ref_labels = example.synthetic_mnist(64, seed=3)
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(labels, ref_labels)
    params = example.ConvNet().init(jax.random.PRNGKey(1),
                                    images[:1])["params"]
    params = jax.tree.map(np.asarray, params)
    want = example.ConvNet().apply({"params": params}, images)
    model = mnist.ConvNet(device="cpu")
    model.load_state_dict(from_flax_variables(params))
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_synthetic_benchmark_smoke_on_cpu():
    """ResNet-18 at 32x32, batch 4, through init (gloo), the parameter
    broadcast and DistributedOptimizer(SGD): finite losses, a throughput
    from the CPU, named as such."""
    res = synthetic_benchmark.main(["--smoke", "--device", "cpu"])
    assert res["device"] == "cpu" and res["world_size"] == 1
    assert res["model"] == "ResNet18" and len(res["losses"]) == 3
    assert all(math.isfinite(v) for v in res["losses"])
    assert res["img_sec"] > 0 and res["peak_memory_gib"] is None
    assert not thvd.is_initialized()


def test_mnist_smoke_on_cpu():
    """One epoch; the twin's own progress check holds, and the step loss
    falls over the epoch (the check ``chip_smoke.py`` makes on the card)."""
    res = mnist.main(["--smoke", "--device", "cpu"])
    assert len(res["epochs"]) == 1 and res["steps_per_epoch"] == 8
    assert math.isfinite(res["epochs"][0]["loss"])
    steps = res["step_losses"]
    assert len(steps) == 8 and all(math.isfinite(v) for v in steps)
    assert steps[-1] < steps[0], steps
    assert not thvd.is_initialized()


@pytest.mark.parametrize("entry", [synthetic_benchmark, mnist],
                         ids=["synthetic_benchmark", "mnist"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without ``--device`` an entry point asks for the card, and raises
    where there is none rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main(["--smoke"])
    assert not thvd.is_initialized()
