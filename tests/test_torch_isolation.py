"""The PyTorch port stands alone: no JAX, no JAX package, and CPU tensors
never reach a CUDA kernel."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.ops import _build, flash

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
PORT_FILES = sorted((REPO / "horovod_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "convnet_host_probe.py",
    REPO / "trainer_turns.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_rule_allows_the_port_itself():
    assert not _forbidden("horovod_tpu_torch")
    assert not _forbidden("horovod_tpu_torch.ops.flash")
    assert _forbidden("horovod_tpu") and _forbidden("horovod_tpu.ops.flash")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.models, "
            "horovod_tpu_torch.parallel, horovod_tpu_torch.ops.flash, "
            "horovod_tpu_torch.data, horovod_tpu_torch.callbacks, "
            "horovod_tpu_torch.examples.synthetic_benchmark, "
            "horovod_tpu_torch.examples.mnist, "
            "horovod_tpu_torch.examples.long_context_lm; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_tensors_never_launch_a_kernel():
    """On CPU tensors the wrappers run their plain versions (here at a head
    dim the kernels do not take) and every launch counter stays at 0."""
    flash.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 9, 8), generator=g) for _ in range(3))
    m = torch.full((2, 9, 1), flash.NEG_INF)
    l, acc = torch.zeros((2, 9, 1)), torch.zeros((2, 9, 8))
    m, l, acc = flash.block_attend(q, k, v, 0, 0, True, m, l, acc)
    lse = m + torch.log(l)
    dout = torch.randn((2, 9, 8), generator=g)
    D = (dout * acc / l).sum(-1, keepdim=True)
    flash.flash_block_grads(q, k, v, lse, dout, D, 0, 0, True)
    assert flash.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                              "flash_bwd_dkv": 0}


def test_mixed_devices_raise():
    q = torch.zeros((1, 4, 64))
    meta = torch.zeros((1, 4, 1), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash.block_attend(q, q, q, 0, 0, True, meta, meta, q)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A build that cannot run raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
