"""The port's fusion and gradient-bucket rules equal the JAX package's.

``_fusion_buckets`` (wire-dtype buckets capped at ``HVD_FUSION_THRESHOLD``)
and ``_bucket_layout`` (reverse-traversal gradient buckets) are copied in
meaning; here both sides get the same size and dtype lists and must yield
the same index lists. The fused wire buffers must hold the same bytes.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.optim import _bucket_layout as j_bucket_layout
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.optim import _bucket_layout as t_bucket_layout

_DTYPES = [np.float32, np.float16, np.int32, np.int8]


def _case(seed, n=40):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 600, size=n)
    dtypes = [_DTYPES[i] for i in rng.integers(0, len(_DTYPES), size=n)]
    arrays = [rng.integers(-9, 9, size=int(s)).astype(dt)
              for s, dt in zip(sizes, dtypes)]
    return arrays, [torch.from_numpy(a) for a in arrays]


def _name(dt) -> str:
    return str(dt).rsplit(".", 1)[-1] if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


@pytest.mark.parametrize("threshold", [1, 256, 1000, 4096, 1 << 30])
@pytest.mark.parametrize("seed", [0, 1])
def test_fusion_buckets_match_jax(seed, threshold):
    arrays, tensors = _case(seed)
    want = [(_name(dt), idxs) for dt, idxs in jcoll._fusion_buckets(
        arrays, threshold, lambda a: a.size)]
    got = [(_name(dt), idxs) for dt, idxs in tcoll._fusion_buckets(
        tensors, threshold, lambda t: t.numel())]
    assert got == want


@pytest.mark.parametrize("compression", ["fp16", "bf16"])
def test_fusion_buckets_by_wire_dtype_match_jax(compression):
    """With compression, floating tensors of every source dtype share the
    wire dtype's buckets; integers keep their own."""
    import jax.numpy as jnp
    from horovod_tpu.ops.compression import Compression as JCompression

    arrays, tensors = _case(7)
    jwire = [jcoll._wire_dtype_of(a, getattr(JCompression, compression))
             for a in arrays]
    twire = [tcoll._wire_dtype_of(t, getattr(Compression, compression))
             for t in tensors]
    assert [_name(t) for t in twire] == [jnp.dtype(j).name for j in jwire]
    want = [(_name(dt), idxs) for dt, idxs in jcoll._fusion_buckets(
        arrays, 2048, lambda a: a.size, dtype_of=lambda i: jwire[i])]
    got = [(_name(dt), idxs) for dt, idxs in tcoll._fusion_buckets(
        tensors, 2048, lambda t: t.numel(), dtype_of=lambda i: twire[i])]
    assert got == want


@pytest.mark.parametrize("threshold", ["64", "100000"])
def test_fused_wire_buffers_match_jax(monkeypatch, threshold):
    """``_fuse_by_dtype`` packs the same bytes in the same order as the JAX
    package's (a world of one bundle row), and ``_split_fused`` restores
    every tensor bitwise in its own dtype."""
    monkeypatch.setenv("HVD_FUSION_THRESHOLD", threshold)
    arrays, tensors = _case(3, n=12)
    jbufs, _ = jcoll._fuse_by_dtype([a[None] for a in arrays], 1)
    tbufs, metas = tcoll._fuse_by_dtype(tensors)
    assert len(tbufs) == len(jbufs)
    for t, j in zip(tbufs, jbufs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[0])
    back = tcoll._split_fused(tbufs, metas, len(tensors))
    for t, a in zip(back, arrays):
        assert t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("cap", [0, 1, 300, 2048, 10_000, 1 << 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_layout_matches_jax(seed, cap):
    sizes = [int(x) for x in
             np.random.default_rng(seed).integers(1, 1000, size=50)]
    assert t_bucket_layout(sizes, cap) == j_bucket_layout(sizes, cap)
