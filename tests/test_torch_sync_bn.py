"""The port's ``BatchNorm`` and ``SyncBatchNorm`` against flax's
``BatchNorm``, on the CPU.

World 1: ``BatchNorm`` against flax ``nn.BatchNorm`` (momentum 0.9, epsilon
1e-5) in training and eval mode, and ``SyncBatchNorm`` in a gloo world of
one rank against ``BatchNorm`` (bitwise: the average over one rank is the
identity). World 2: each rank of a spawned gloo world of two
(:func:`test_torch_world2.run_world`) takes its half of the batch through
``SyncBatchNorm``; the reference is the JAX package's ``SyncBatchNorm
(axis_name="d")``, flax ``BatchNorm`` with ``pmean`` moments, under
``jax.shard_map`` over two of the CPU devices, each device with the same
half.

Tolerances. float32: output and dx rtol 1e-5 atol 1e-5 (float32 moments
summed in another order), running averages rtol 1e-6 atol 1e-7, dscale and
dbias rtol 1e-5 atol 1e-5. bfloat16 input (the models' case: float32
statistics, bf16 output): the output and dx within one bf16 step (rtol
1e-2, atol 1e-2), the float32 running averages rtol 1e-5 atol 1e-6, dscale
and dbias rtol 1e-3 atol 1e-3 (sums of bf16 products).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu.models import SyncBatchNorm as JSyncBatchNorm
from horovod_tpu_torch.models import BatchNorm, SyncBatchNorm
from test_torch_convnets import torch_threads  # noqa: F401 (a fixture)
from test_torch_world2 import BN_DTYPES, BN_SHAPE, bn_inputs, bn_step, \
    run_world

TOLS = {"float32": {"y": (1e-5, 1e-5), "dx": (1e-5, 1e-5),
                    "dscale": (1e-5, 1e-5), "dbias": (1e-5, 1e-5),
                    "mean": (1e-6, 1e-7), "var": (1e-6, 1e-7)},
        "bfloat16": {"y": (1e-2, 1e-2), "dx": (1e-2, 1e-2),
                     "dscale": (1e-3, 1e-3), "dbias": (1e-3, 1e-3),
                     "mean": (1e-5, 1e-6), "var": (1e-5, 1e-6)}}


def _flax_step(module, x, ct, inp, train=True):
    """The flax twin of :func:`test_torch_world2.bn_step`, for one shard
    (inside ``shard_map`` when ``module`` syncs)."""
    def loss(params, x):
        y, mut = module.apply(
            {"params": params, "batch_stats": stats}, x,
            use_running_average=not train, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * ct), (y, mut)

    stats = {"mean": inp["mean"], "var": inp["var"]}
    params = {"scale": inp["scale"], "bias": inp["bias"]}
    if isinstance(module, JSyncBatchNorm):
        stats, params = {"sync_bn": stats}, {"sync_bn": params}
    (_, (y, mut)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    new = mut["batch_stats"]
    if isinstance(module, JSyncBatchNorm):
        gp, new = gp["sync_bn"], new["sync_bn"]
    return {"y": y.astype(jnp.float32), "dx": gx.astype(jnp.float32),
            "dscale": gp["scale"], "dbias": gp["bias"],
            "mean": new["mean"], "var": new["var"]}


def _close(got: dict, want: dict, dtype: str, keys=None):
    for k in keys or TOLS[dtype]:
        rtol, atol = TOLS[dtype][k]
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def torch_world():
    """A gloo world of one rank in this process."""
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


@pytest.mark.parametrize("dtype", BN_DTYPES)
def test_batch_norm_train_matches_flax(dtype):
    """Output, dx, dscale, dbias and the running averages after one
    training-mode pass."""
    inp = bn_inputs()
    x = torch.from_numpy(inp["x"]).to(getattr(torch, dtype))
    got = bn_step(BatchNorm(BN_SHAPE[-1], dtype=x.dtype, device="cpu"), x,
                  inp["ct"], inp)
    module = nn.BatchNorm(momentum=0.9, epsilon=1e-5,
                          dtype=getattr(jnp, dtype))
    want = _flax_step(module, jnp.asarray(inp["x"], getattr(jnp, dtype)),
                      inp["ct"], inp)
    _close(got, want, dtype)


def test_batch_norm_eval_matches_flax():
    """Eval mode normalizes with the running averages; they do not move."""
    inp = bn_inputs()
    norm = BatchNorm(BN_SHAPE[-1], dtype=torch.float32, device="cpu")
    bn_step(norm, torch.from_numpy(inp["x"]), inp["ct"], inp)  # loads state
    norm.eval()
    with torch.no_grad():
        norm.running_mean.copy_(torch.from_numpy(inp["mean"]))
        norm.running_var.copy_(torch.from_numpy(inp["var"]))
        y = norm(torch.from_numpy(inp["x"]).permute(0, 3, 1, 2))
    want = _flax_step(nn.BatchNorm(momentum=0.9, epsilon=1e-5),
                      jnp.asarray(inp["x"]), inp["ct"], inp, train=False)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), want["y"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(norm.running_mean.numpy(), inp["mean"])
    np.testing.assert_array_equal(norm.running_var.numpy(), inp["var"])


def test_running_variance_is_biased_unlike_batchnorm2d():
    """flax, and the port, move the running variance toward the biased
    batch variance; ``nn.BatchNorm2d`` (momentum 0.1 = flax's 0.9) toward
    the unbiased one, n / (n - 1) larger (n = 8 * 3 * 5 = 120 here)."""
    inp = bn_inputs()
    x = torch.from_numpy(inp["x"]).permute(0, 3, 1, 2)
    ours = BatchNorm(BN_SHAPE[-1], dtype=torch.float32, device="cpu")
    ref = torch.nn.BatchNorm2d(BN_SHAPE[-1], momentum=0.1, eps=1e-5)
    ours(x), ref(x)
    n = x.numel() // x.shape[1]
    biased = x.double().var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var.double(), 0.9 + 0.1 * biased,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(ref.running_var.double(),
                               0.9 + 0.1 * biased * n / (n - 1),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(ours.running_mean, ref.running_mean)
    assert (ref.running_var - ours.running_var).min() > 0


def test_zero_scale_and_defaults():
    """flax's initializers; momentum 0.9 and epsilon 1e-5 by default."""
    norm = BatchNorm(4, zero_scale=True, device="cpu")
    assert norm.momentum == 0.9 and norm.epsilon == 1e-5
    assert norm.weight.abs().sum() == 0 and norm.bias.abs().sum() == 0
    assert (norm.running_var == 1).all() and (norm.running_mean == 0).all()
    assert (BatchNorm(4, device="cpu").weight == 1).all()


@pytest.mark.parametrize("dtype", BN_DTYPES)
def test_sync_batch_norm_world1_equals_batch_norm(torch_world, dtype):
    """At a world of one, ``SyncBatchNorm`` is ``BatchNorm``, bitwise."""
    inp = bn_inputs()
    x = torch.from_numpy(inp["x"]).to(getattr(torch, dtype))
    got = bn_step(SyncBatchNorm(BN_SHAPE[-1], dtype=x.dtype, device="cpu"),
                  x, inp["ct"], inp)
    want = bn_step(BatchNorm(BN_SHAPE[-1], dtype=x.dtype, device="cpu"), x,
                   inp["ct"], inp)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def sync_bn_world2(tmp_path_factory):
    return run_world("_sync_bn_rank", tmp_path_factory.mktemp("sync_bn"))


def _flax_world2(dtype: str) -> list:
    """Each of two devices' results of the JAX package's ``SyncBatchNorm``
    on its half of the batch."""
    inp = bn_inputs()
    module = JSyncBatchNorm(axis_name="d", dtype=getattr(jnp, dtype))
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))

    def shard(x, ct):
        res = _flax_step(module, x, ct, inp)
        return {k: v if k in ("y", "dx") else v[None] for k, v in res.items()}

    out = jax.jit(jax.shard_map(
        shard, mesh=mesh, in_specs=(P("d"), P("d")), out_specs=P("d"),
        check_vma=False))(jnp.asarray(inp["x"], getattr(jnp, dtype)),
                          jnp.asarray(inp["ct"]))
    out = {k: np.asarray(v) for k, v in out.items()}
    half = BN_SHAPE[0] // 2
    return [{k: v[r * half:(r + 1) * half] if k in ("y", "dx") else v[r]
             for k, v in out.items()} for r in range(2)]


@pytest.mark.parametrize("dtype", BN_DTYPES)
def test_sync_batch_norm_world2_matches_flax_pmean(sync_bn_world2, dtype):
    """Each rank's output, dx, dscale, dbias and running averages equal
    those of its device under flax's ``pmean`` of (E[x], E[x^2]): global
    moments forward, the cotangents of the moments averaged backward."""
    want = _flax_world2(dtype)
    for rank in range(2):
        got = {k[len(dtype) + 1:]: v for k, v in sync_bn_world2[rank].items()
               if k.startswith(dtype + "_")}
        _close(got, want[rank], dtype)


def test_sync_batch_norm_world2_differs_from_local_stats(sync_bn_world2):
    """The world's moments are not a rank's own: a local ``BatchNorm`` on
    rank 0's half gives another output and running mean."""
    inp = bn_inputs()
    half = BN_SHAPE[0] // 2
    local = bn_step(BatchNorm(BN_SHAPE[-1], dtype=torch.float32,
                              device="cpu"),
                    torch.from_numpy(inp["x"][:half]), inp["ct"][:half], inp)
    for k in ("y", "mean", "var"):
        assert np.abs(local[k] - sync_bn_world2[0][f"float32_{k}"]).max() \
            > 1e-3, k


def test_resnet_with_sync_batch_norm_world1_equals_resnet(torch_world):
    """``ResNet18(sync_batch_norm=True)`` at a world of one trains as the
    local-statistics model, bitwise: logits, every gradient and every
    running average."""
    from horovod_tpu_torch.models import ResNet18
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 3, 32, 32), generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    res = []
    for sync in (False, True):
        model = ResNet18(num_classes=10, dtype=torch.float32,
                         sync_batch_norm=sync, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        logits = model(x)
        torch.nn.functional.cross_entropy(logits, y).backward()
        res.append((logits, {n: p.grad for n, p in model.named_parameters()},
                    model.state_dict()))
    assert sum(isinstance(m, SyncBatchNorm) for m in model.modules()) == 20
    (l0, g0, s0), (l1, g1, s1) = res
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


# --------------------------------------------------------------------------
# the autograd function: its plain backward, its hooks and its launches
# --------------------------------------------------------------------------

def _clamped_channel_value(shape) -> float:
    """A value that, filling a channel of ``shape``, gives that channel an
    E[x^2] - E[x]^2 below 0 in float64 (rounding), so that the variance
    clamps to 0 there."""
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    for v in np.linspace(0.01, 3.0, 300):
        x = torch.full((shape[0], 1) + shape[2:], float(v),
                       dtype=torch.float64)
        stats = sbn.stats_plain(x)
        if stats[1, 0] - stats[0, 0].square() < 0:
            return float(v)
    raise AssertionError("no value clamps")


def _gradcheck_inputs(seed=0, shape=(3, 3, 5, 1)):
    """float64 x whose channel 1 clamps its variance to 0, and a weight and
    bias, all leaves that require grad."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2 + 0.5
    x[:, 1] = _clamped_channel_value(shape)
    w = 1 + 0.1 * torch.randn(shape[1], generator=g, dtype=torch.float64)
    b = 0.1 * torch.randn(shape[1], generator=g, dtype=torch.float64)
    return [t.requires_grad_() for t in (x, w, b)]


def _op_chain(norm, x, weight, bias, stats=None):
    """The norm as the torch ops the port ran before its autograd function,
    differentiated by autograd: the moments (or ``stats`` given), their
    clamped variance and the normalization (training mode), or the running
    averages (eval mode)."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if norm.training:
        dims = [0] + list(range(2, x.dim()))
        if stats is None:
            stats = torch.stack((x32.mean(dims), x32.square().mean(dims)))
        mean, mean2 = stats
        var = (mean2 - mean.square()).clamp_min(0.0)
    else:
        mean, var = norm.running_mean, norm.running_var
    mul = torch.rsqrt(var + norm.epsilon) * weight
    y = (x32 - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return y.to(norm.compute_dtype)


@pytest.mark.parametrize("cls", ["BatchNorm", "SyncBatchNorm"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_function_passes_gradcheck(torch_world, cls, train):
    """The autograd function's plain backward (closed form) against finite
    differences in float64, through both hooks (``SyncBatchNorm`` at a
    world of one), with a channel whose variance clamps to 0."""
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    x, w, b = _gradcheck_inputs()
    norm = getattr(sbn, cls)(3, dtype=torch.float64, device="cpu")
    norm.train(train)
    with torch.no_grad():
        norm.running_var.fill_(1.3)
    assert torch.autograd.gradcheck(
        lambda x, w, b: sbn._BatchNormFunction.apply(x, w, b, norm),
        (x, w, b), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_backward_equals_autograd_of_the_op_chain(dtype, train):
    """The function's output and its closed-form dx, dweight and dbias
    against autograd of the plain op chain on the same input and cotangent,
    with a channel whose variance clamps to 0: float64 within 1e-12
    (relative, rounding only), float32 within 1e-5 and bf16 input (float32
    arithmetic, bf16 output and dx) within one bf16 step of dx (2^-7) and
    1e-5 of dweight and dbias (float32 sums of the same terms)."""
    from horovod_tpu_torch.models import BatchNorm
    dt = getattr(torch, dtype)
    x0, w, b = _gradcheck_inputs(seed=1, shape=(4, 3, 6, 5))
    ct = torch.randn(x0.shape, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    tol = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5),
           "bfloat16": (2 ** -7, 1e-5)}[dtype]
    res = []
    for run in ("function", "op chain"):
        norm = BatchNorm(3, dtype=dt, device="cpu").train(train)
        with torch.no_grad():
            norm.weight.copy_(w)
            norm.bias.copy_(b)
        x = x0.detach().to(dt).requires_grad_()
        if run == "function":
            y = norm(x)
        else:
            y = _op_chain(norm, x, norm.weight, norm.bias)
        (y.double() * ct).sum().backward()
        res.append({"y": y.double(), "dx": x.grad.double(),
                    "dweight": norm.weight.grad.double(),
                    "dbias": norm.bias.grad.double()})
    got, want = res
    for k in ("y", "dx"):
        torch.testing.assert_close(got[k], want[k], rtol=tol[0], atol=tol[0],
                                   msg=lambda m, k=k: f"{k}: {m}")
    for k in ("dweight", "dbias"):
        torch.testing.assert_close(got[k], want[k], rtol=tol[1], atol=tol[1],
                                   msg=lambda m, k=k: f"{k}: {m}")


def test_batch_norm_moment_cotangents_follow_the_clamp():
    """``bwd_reduce_plain``'s cotangents of the moments and ``bwd_dx_plain``
    without them against autograd of ``norm_plain`` with the moments as a
    leaf: one channel whose E[x^2] - E[x]^2 is below 0 (the clamp passes no
    gradient), one where it is exactly 0 (torch's ``clamp_min`` passes it)
    and one above, in float64 within 1e-12."""
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 3, 5, 2), generator=g, dtype=torch.float64)
    dy = torch.randn(x.shape, generator=g, dtype=torch.float64)
    w = torch.tensor([0.9, 1.1, 1.2], dtype=torch.float64)
    b = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    stats = torch.tensor([[1.0, 0.5, 0.2], [0.5, 0.25, 1.3]],
                         dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (x, stats, w, b)]
    y = sbn.norm_plain(leaves[0], leaves[1], True, leaves[2], leaves[3],
                       1e-5, torch.float64)
    want = torch.autograd.grad(y, leaves, dy)
    dw, db, dstats = sbn.bwd_reduce_plain(dy, x, stats, True, w, 1e-5)
    dx = sbn.bwd_dx_plain(dy, x, stats, True, w, 1e-5, None)
    assert dstats[1, 0] == 0 and want[1][1, 0] == 0  # clamped: no gradient
    assert want[1][1, 1] != 0  # exactly 0: the gradient passes
    for name, a, e in zip(("dx", "dstats", "dweight", "dbias"),
                          (dx, dstats, dw, db), want):
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_batch_norm_on_the_cpu_launches_no_kernel():
    """The CPU's path is the plain versions: the kernel counters stay 0
    through a training and an eval pass, forward and backward."""
    from horovod_tpu_torch.models import BatchNorm
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    sbn.reset_launch_counts()
    norm = BatchNorm(6, device="cpu")
    for train in (True, False):
        norm.train(train)
        x = torch.randn((4, 6, 3, 3)).requires_grad_()
        norm(x).float().sum().backward()
    assert sbn.launches == dict.fromkeys(sbn.launches, 0)


def test_resnet50_norm_shapes():
    """ResNet-50 at batch 256, 224 x 224 has 53 norms over 11,113,984
    elements an image, at the distinct shapes the card tests hold the
    kernels at (``test_torch_cuda.RESNET50_NORM_SHAPES``): its forward pass
    on the meta device, the norms on their plain versions."""
    from horovod_tpu_torch.models import BatchNorm, ResNet50
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    from test_torch_cuda import RESNET50_NORM_SHAPES
    model = ResNet50(num_classes=1000, device="meta")
    shapes = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape)))
    steps = sbn._steps
    sbn._steps = lambda x, dtype: sbn.PLAIN  # meta tensors: no kernels
    try:
        model(torch.empty((256, 3, 224, 224), device="meta"))
    finally:
        sbn._steps = steps
    assert len(shapes) == 53
    assert sum(torch.Size(s).numel() for s in shapes) == 256 * 11_113_984
    assert set(shapes) == set(RESNET50_NORM_SHAPES)


def test_batch_norm_second_derivative_raises():
    """The backward takes the moments as constants, so it is marked
    differentiable once: a second derivative raises rather than dropping
    the terms through the moments."""
    from horovod_tpu_torch.models import BatchNorm
    norm = BatchNorm(3, dtype=torch.float64, device="cpu")
    x = torch.randn((4, 3, 2, 2), dtype=torch.float64).requires_grad_()
    y = norm(x)
    (dx,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


@pytest.mark.parametrize("shape,layout", [
    ((4, 6, 3, 5), "nchw"), ((4, 6, 3, 5), "channels_last"),
    ((5, 6), "plain"), ((4, 6, 7), "plain")])
def test_rows_keeps_shape_and_values_with_channels_innermost(shape, layout):
    """``_rows``, the layout the kernels read: the same shape and values,
    channels innermost (stride 1, the other dims in order), and the tensor
    itself, no copy, where it already lies so."""
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    t = torch.arange(float(np.prod(shape))).reshape(shape)
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    got = sbn._rows(t)
    assert got.shape == t.shape and torch.equal(got, t)
    assert got.movedim(1, -1).is_contiguous()
    assert (got is t) == t.movedim(1, -1).is_contiguous()
