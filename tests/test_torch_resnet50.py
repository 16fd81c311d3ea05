"""Parity of the port's ResNet-50 with the JAX package's, on the CPU: the
cases of ``test_torch_convnets.py`` (which states every tolerance) for the
bottleneck model, at 32x32 (the stride-2 convs pad (0, 1)) and 33x33
((1, 1)) with float32 compute, and at 32x32 with float64 compute (ResNet-18
covers float64 at both sizes), in a file of its own so that the two
models' compiles run on two test workers."""

import pytest

from test_torch_convnets import (  # noqa: F401 (a fixture)
    check_eval, check_train_step, torch_threads)


@pytest.mark.parametrize("size,dtype", [(32, "float32"), (33, "float32"),
                                        (32, "float64")])
def test_resnet50_train_step_matches_jax(size, dtype):
    check_train_step("ResNet50", size, dtype)


@pytest.mark.parametrize("size", [32, 33])
def test_resnet50_eval_matches_jax(size):
    check_eval("ResNet50", size)
