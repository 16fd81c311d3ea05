"""Parity of the port's ResNets with the JAX package's, on the CPU.

The flax model's variables (the tree of its ``init``, filled from a numpy
seed: LeCun-scaled kernels, and BatchNorm scales, biases and running
averages away from their initial values; the last norm of each residual
block, which flax zeroes, scaled about 0.2, so that every gradient is
exercised and the residual stream stays of unit scale) go through
``from_flax_variables`` into the port's model; both see the same numpy
images (NHWC for flax, NCHW for the port). ResNet-18 (here) and ResNet-50
(``test_torch_resnet50.py``) run at 32x32, where each stage's first 3x3
stride-2 conv sees an even input (8, 4 and 2: flax's ``"SAME"`` pads (0,
1)), and at 33x33, where it sees an odd one (9, 5 and 3: (1, 1)).

Training mode is compared twice. With float64 compute (float32 parameters,
as the JAX models fix ``param_dtype``) both sides agree to float32
rounding, which pins the arithmetic: logits rtol 1e-6 atol 1e-7, loss rtol
1e-6, every parameter's gradient rtol 1e-5 and atol 1e-6 of its tensor's
largest entry (the float32 logits and loss feed the backward on both
sides), the updated running averages rtol 1e-6 atol 1e-7. With float32
compute, BatchNorm over the 4 values of a channel at the 1x1 last stage,
with flax's E[x^2] - E[x]^2 variance, and ReLUs whose input rounds to the
other side of 0, amplify rounding differences; the limits are set from
measured errors: logits atol 2e-4 (measured at most 6.9e-5), loss rtol
1e-5 (2.0e-6), running averages atol 1e-4 (2.0e-5), gradients by relative
norm, all parameters together 2e-2 (5.5e-3, ResNet-50) and each tensor 0.1
(2.6e-2). Eval mode, float32: logits rtol 1e-4 atol 1e-4. Two
SGD-momentum steps (ResNet-18, float64 compute): parameters, momentum
buffers and running averages atol 1e-6. bfloat16 compute (float32
parameters and statistics), ResNet-18 at 64x64, batch 8:
logits within 2e-2 (eval; measured 4.7e-3) and 5e-2 (training; 1.3e-2) of
the reference's largest logit (bf16 rounds each layer's output to 8 bits,
and the batch statistics are taken from those rounded outputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as thvd
from horovod_tpu import models as jmodels
from horovod_tpu_torch import models as tmodels
from horovod_tpu_torch.models import from_flax_variables
from horovod_tpu_torch.models.layers import Conv, same_pads

NUM_CLASSES, BATCH = 10, 4
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two torch threads while a module of these tests runs: the test
    workers run side by side, and torch's default of one thread a core in
    each of them oversubscribes the host several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


# float32 compute: (logits atol, loss rtol, running averages atol, gradient
# relative norm of all parameters together, of each tensor)
F32_LIMITS = (2e-4, 1e-5, 1e-4, 2e-2, 0.1)


def fill_variables(variables, seed: int) -> dict:
    """numpy values for a flax variables tree (of arrays or shapes); the
    last BatchNorm of each residual block (``*Block_<i>``) gets scales
    about 0.2."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1 + 0.2 * rng.standard_normal(shape)
        elif name == "var":
            v = 1 + 0.2 * np.abs(rng.standard_normal(shape))
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    filled = jax.tree_util.tree_map_with_path(leaf, variables)
    for key, block in filled.get("params", {}).items():
        if "Block_" in key:
            last = max(int(n.split("_")[1]) for n in block
                       if n.startswith("BatchNorm_"))
            block[f"BatchNorm_{last}"]["scale"] *= np.float32(0.2)
    return filled


def variables_of(jmodel, size: int, seed: int, **init_kw) -> dict:
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), **init_kw))
    return fill_variables(jax.tree.map(lambda s: s, dict(shapes)), seed)


def images(size: int, seed: int = 0, batch: int = BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    return x, rng.integers(0, NUM_CLASSES, size=batch)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def jax_loss(logits, y):
    one_hot = jax.nn.one_hot(y, NUM_CLASSES)
    return -jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits), -1))


@functools.lru_cache(maxsize=None)
def jax_model(name: str, dtype=jnp.float32):
    return getattr(jmodels, name)(num_classes=NUM_CLASSES, dtype=dtype)


@functools.lru_cache(maxsize=None)
def jax_train_fn(name: str, dtype=jnp.float32):
    """jit(value_and_grad) of the training-mode loss; aux: logits and the
    updated batch_stats. Call it under ``jax.enable_x64(True)`` for
    float64."""
    model = jax_model(name, dtype)

    def loss_fn(params, batch_stats, x, y):
        logits, mut = model.apply(
            {"params": params, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        return jax_loss(logits, y), (logits, mut["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def torch_model(name: str, variables, dtype=torch.float32):
    model = getattr(tmodels, name)(num_classes=NUM_CLASSES, dtype=dtype,
                                   device="cpu")
    model.load_state_dict(from_flax_variables(variables["params"],
                                              variables.get("batch_stats")))
    return model


def running_stats(model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _rel_norm(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def compare_step(got: dict, want: dict, dtype: str) -> None:
    """Hold one step's ``logits``, ``loss``, ``grads`` and running averages
    (``stats``; dicts of numpy arrays by port name) to the limits of the
    module docstring for ``dtype`` compute."""
    assert set(got["grads"]) == set(want["grads"])
    assert set(got["stats"]) == set(want["stats"])
    if dtype == "float64":
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        for n, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][n], w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=n)
        for n, w in want["stats"].items():
            np.testing.assert_allclose(got["stats"][n], w, rtol=1e-6,
                                       atol=1e-7, err_msg=n)
        return
    logits_atol, loss_rtol, stats_atol, all_rel, each_rel = F32_LIMITS
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=logits_atol)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    for n, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][n], w, rtol=0,
                                   atol=stats_atol, err_msg=n)
    g, w = got["grads"], want["grads"]
    flat = lambda d: np.concatenate([d[n].ravel() for n in sorted(d)])
    assert _rel_norm(flat(g), flat(w)) <= all_rel
    worst = max(w, key=lambda n: _rel_norm(g[n], w[n]))
    assert _rel_norm(g[worst], w[worst]) <= each_rel, worst


def torch_step(model, x, y, **kw) -> dict:
    """One forward and backward of the port's model on numpy ``x``, ``y``."""
    logits = model(nchw(x), **kw)
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return {"logits": logits.detach().numpy(), "loss": loss.item(),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "stats": {k: t.numpy() for k, t in running_stats(model).items()}}


def jax_step(value_and_grad, variables, x, y, dtype: str) -> dict:
    """The same from a jitted ``value_and_grad`` of (params, batch_stats,
    x, y) with aux (logits, new batch_stats), in port names."""
    with jax.enable_x64(dtype == "float64"):
        (loss, (logits, stats)), grads = value_and_grad(
            variables["params"], variables.get("batch_stats", {}),
            x.astype(dtype), y)
        loss, logits = float(loss), np.asarray(logits)
        grads, stats = (jax.tree.map(np.asarray, t) for t in (grads, stats))
    numpy = lambda sd: {k: t.numpy() for k, t in sd.items()}
    return {"logits": logits, "loss": loss,
            "grads": numpy(from_flax_variables(grads)),
            "stats": numpy(from_flax_variables({}, stats))}


def check_train_step(name: str, size: int, dtype: str) -> None:
    """One training-mode step of both ResNets from the same variables."""
    v = variables_of(jax_model(name), size, seed=size, train=False)
    x, y = images(size, seed=size)
    want = jax_step(jax_train_fn(name, getattr(jnp, dtype)), v, x, y, dtype)
    model = torch_model(name, v, getattr(torch, dtype))
    model.train()
    compare_step(torch_step(model, x, y), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_train_step_matches_jax(size, dtype):
    """ResNet-18 in training mode (ResNet-50: ``test_torch_resnet50.py``)."""
    check_train_step("ResNet18", size, dtype)


def check_eval(name: str, size: int) -> None:
    """Eval mode normalizes with the running averages: logits match and no
    running average moves."""
    v = variables_of(jax_model(name), size, seed=size + 1, train=False)
    x, _ = images(size, seed=size + 1)
    want = jax.jit(lambda v, x: jax_model(name).apply(v, x, train=False))(
        v, x)
    model = torch_model(name, v)
    model.eval()
    before = {k: t.clone() for k, t in running_stats(model).items()}
    with torch.no_grad():
        got = model(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for k, t in running_stats(model).items():
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("size", [32, 33])
def test_resnet_eval_matches_jax(size):
    check_eval("ResNet18", size)


@pytest.fixture(scope="module")
def torch_world():
    """A gloo world of one rank in this process for the port's optimizer."""
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def test_resnet_sgd_momentum_steps_match_optax(torch_world):
    """Two training steps of DistributedOptimizer(SGD(lr, momentum=0.9))
    at a world of one against optax.sgd(lr, momentum=0.9), batch statistics
    carried from step to step, ResNet-18 at 32x32 with float64 compute (so
    that the optimizers, not float32 conditioning, are compared):
    parameters, momentum buffers and running averages atol 1e-6."""
    name, size, lr = "ResNet18", 32, 0.1
    v = variables_of(jax_model(name), size, seed=5, train=False)
    x, y = images(size, seed=5)
    model = torch_model(name, v, torch.float64)
    tx = optax.sgd(lr, momentum=0.9)
    params, stats = v["params"], v["batch_stats"]
    with jax.enable_x64(True):
        state = tx.init(params)
        for _ in range(2):
            (_, (_, stats)), g = jax_train_fn(name, jnp.float64)(
                params, stats, x.astype(np.float64), y)
            updates, state = tx.update(g, state, params)
            params = optax.apply_updates(params, updates)
        params, stats, trace = (jax.tree.map(np.asarray, t)
                                for t in (params, stats, state[0].trace))
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9))
    model.train()
    for _ in range(2):
        opt.zero_grad()
        F.cross_entropy(model(nchw(x)), torch.from_numpy(y)).backward()
        opt.step()
    want = from_flax_variables(params, stats)
    for n, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
    trace = from_flax_variables(trace)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(),
                                   trace[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("train,limit", [(False, 2e-2), (True, 5e-2)])
def test_resnet_bf16_forward_matches_jax(train, limit):
    """bf16 compute, float32 parameters and statistics, ResNet-18 at 64x64
    with a batch of 8 (BatchNorm over at least 32 values a channel):
    logits within ``limit`` of the JAX logits' largest magnitude."""
    name, size = "ResNet18", 64
    jm = jax_model(name, jnp.bfloat16)
    v = variables_of(jax_model(name), size, seed=9, train=False)
    x, _ = images(size, seed=9, batch=8)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=train,
                                         mutable=["batch_stats"])[0])(v, x)
    model = torch_model(name, v, torch.bfloat16)
    model.train(train)
    with torch.no_grad():
        got = model(nchw(x))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < limit, err


@pytest.mark.parametrize("name", ["ResNet18", "ResNet34", "ResNet50"])
def test_importer_fills_every_entry(name):
    """``from_flax_variables`` of the flax tree gives exactly the port
    model's state_dict keys and shapes (ResNet-50: 161 parameter tensors,
    as the flax model's params)."""
    shapes = jax.eval_shape(lambda: jax_model(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(shapes))
    sd = from_flax_variables(zeros["params"], zeros["batch_stats"])
    model = getattr(tmodels, name)(num_classes=NUM_CLASSES, device="cpu")
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, t in want.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
    n_params = len(jax.tree.leaves(shapes["params"]))
    assert len(list(model.parameters())) == n_params
    if name == "ResNet50":
        assert n_params == 161


def test_port_init_follows_flax_init():
    """The port's own initialization against flax's ``init`` of ResNet-18:
    the same BatchNorm scales are zero (the last norm of each block), every
    other scale is 1, biases and running means 0, running variances 1, and
    each kernel's standard deviation within 10 % of flax's (LeCun normal)."""
    jm = jax_model("ResNet18")
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3)),
                                  train=False))(jax.random.PRNGKey(0))
    want = from_flax_variables(jax.tree.map(np.asarray, v["params"]),
                               jax.tree.map(np.asarray, v["batch_stats"]))
    got = tmodels.ResNet18(num_classes=NUM_CLASSES, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    for k, t in got.state_dict().items():
        w = want[k]
        if t.dim() >= 2:
            np.testing.assert_allclose(t.std().item(), w.std().item(),
                                       rtol=0.1, err_msg=k)
        else:
            assert torch.equal(t, w), k


@pytest.mark.parametrize("n", [7, 8, 9, 14, 28, 56, 299])
@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (3, 2), (1, 2), (5, 1),
                                 (7, 2)])
def test_same_pads_match_xla(n, k, s):
    """The one helper that every convnet module pads with equals XLA's
    ``"SAME"`` rule."""
    assert same_pads(n, k, s) == tuple(
        jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


@pytest.mark.parametrize("n,pads", [(8, (0, 1)), (9, (1, 1))])
def test_strided_conv_pads_like_flax(n, pads):
    """A 3x3 stride-2 ``"SAME"`` conv against flax's: on an even input it
    pads (0, 1), where ``padding=1`` would pad (1, 1) and be wrong."""
    import flax.linen as nn
    rng = np.random.default_rng(n)
    x = rng.standard_normal((1, n, n, 4)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    want = nn.Conv(5, (3, 3), (2, 2), use_bias=False).apply(
        {"params": {"kernel": kernel}}, x)
    conv = Conv(4, 5, (3, 3), 2, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = conv(nchw(x)).permute(0, 2, 3, 1).numpy()
        symmetric = F.conv2d(nchw(x), conv.weight, stride=2, padding=1)
    assert same_pads(n, 3, 2) == pads
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    off = np.abs(symmetric.permute(0, 2, 3, 1).numpy() - np.asarray(want))
    assert (off.max() > 1e-2) == (pads == (0, 1))
