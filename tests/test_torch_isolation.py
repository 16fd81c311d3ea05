"""The PyTorch port stands alone: no JAX, no JAX package, and CPU tensors
never reach a CUDA kernel."""

import ast
import os
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


# The modules of the expert, pipeline and two-level slice, each held to the
# rule by name as well as by the walk over the package.
SLICE7 = ["parallel/moe.py", "parallel/pipeline.py", "parallel/mesh.py",
          "ops/hierarchical.py", "examples/moe.py",
          "examples/pipeline_train.py"]


# The modules of the Adasum and negotiation slice.
SLICE8 = ["ops/adasum.py", "runner/__init__.py", "runner/http_kv.py",
          "utils/retry.py", "_native.py", "dynamic.py", "engine_service.py"]


# The modules of the negotiation control plane and observability slice.
SLICE9 = ["utils/envs.py", "exceptions.py", "metrics.py", "utils/faults.py",
          "utils/retry.py", "timeline.py", "conformance.py", "health.py",
          "negotiation/__init__.py", "negotiation/layout.py",
          "negotiation/response_cache.py", "negotiation/hierarchy.py",
          "engine_service.py", "ops/collectives.py", "runner/http_kv.py",
          "__init__.py"]


# The modules of the launcher and elastic slice.
SLICE12 = ["runner/__init__.py", "runner/hosts.py", "runner/config_parser.py",
           "runner/safe_exec.py", "runner/lsf.py", "runner/launch.py",
           "runner/task_exec.py", "runner/http_kv.py", "runtime.py",
           "elastic/__init__.py", "elastic/discovery.py",
           "elastic/registration.py", "elastic/driver.py",
           "elastic/rendezvous.py", "elastic/bootstrap.py",
           "elastic/launch.py", "elastic/notification.py",
           "elastic/state.py", "health.py", "utils/faults.py",
           "engine_service.py", "ops/dispatch_cache.py",
           "examples/elastic_train.py"]


# The modules of the autoscale, Ray and Spark slice.
SLICE13 = ["elastic/policy.py", "elastic/state.py", "elastic/launch.py",
           "elastic/discovery.py", "elastic/__init__.py", "utils/envs.py",
           "metrics.py", "health.py", "utils/faults.py", "runner/launch.py",
           "ray/__init__.py", "ray/runner.py", "ray/elastic.py",
           "spark/__init__.py", "spark/estimator.py", "testing.py",
           "examples/ray_train.py", "examples/spark_train.py",
           "examples/spark_estimator.py"]


@pytest.mark.parametrize("rel", SLICE13)
def test_slice13_module_is_a_port_file(rel):
    path = REPO / "horovod_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_slice13_import_starts_nothing_and_leaves_jax_out(tmp_path):
    """Importing the autoscale policy, the Ray and Spark integrations, the
    process stubs and the three twins imports no JAX and neither ``ray``
    nor ``pyspark``, starts no thread or process and writes no file."""
    code = ("import sys, threading, horovod_tpu_torch, "
            "horovod_tpu_torch.elastic.policy, horovod_tpu_torch.ray, "
            "horovod_tpu_torch.ray.runner, horovod_tpu_torch.ray.elastic, "
            "horovod_tpu_torch.spark, horovod_tpu_torch.spark.estimator, "
            "horovod_tpu_torch.testing, "
            "horovod_tpu_torch.examples.ray_train, "
            "horovod_tpu_torch.examples.spark_train, "
            "horovod_tpu_torch.examples.spark_estimator; "
            "bad = sorted(x for x in sys.modules if x.split('.')[0] in "
            f"{FORBIDDEN + ('ray', 'pyspark')!r}); "
            "extra = [th.name for th in threading.enumerate() "
            "if th is not threading.main_thread()]; "
            "print(bad, extra); sys.exit(1 if bad or extra else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("rel", SLICE12)
def test_slice12_module_is_a_port_file(rel):
    path = REPO / "horovod_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_slice12_import_starts_nothing_and_leaves_jax_out(tmp_path):
    """Importing the launcher and the elastic modules imports no JAX,
    starts no thread or process, opens no server and writes no file; the
    launcher's module runs as ``python -m`` once (the package imports it
    lazily)."""
    code = ("import sys, threading, horovod_tpu_torch, "
            "horovod_tpu_torch.runner, horovod_tpu_torch.runner.hosts, "
            "horovod_tpu_torch.runner.config_parser, "
            "horovod_tpu_torch.runner.safe_exec, "
            "horovod_tpu_torch.runner.lsf, "
            "horovod_tpu_torch.runner.task_exec, "
            "horovod_tpu_torch.elastic.discovery, "
            "horovod_tpu_torch.elastic.registration, "
            "horovod_tpu_torch.elastic.driver, "
            "horovod_tpu_torch.elastic.rendezvous, "
            "horovod_tpu_torch.elastic.bootstrap, "
            "horovod_tpu_torch.examples.elastic_train; "
            "lazy = 'horovod_tpu_torch.runner.launch' not in sys.modules; "
            "import horovod_tpu_torch.elastic.launch; "
            "bad = sorted(x for x in sys.modules if x.split('.')[0] in "
            f"{FORBIDDEN!r}); "
            "extra = [th.name for th in threading.enumerate() "
            "if th is not threading.main_thread()]; "
            "print(bad, extra, lazy); "
            "sys.exit(1 if bad or extra or not lazy else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert list(tmp_path.iterdir()) == []
    res = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m",
         "horovod_tpu_torch.runner.launch", "--version"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("rel", SLICE9)
def test_slice9_module_is_a_port_file(rel):
    path = REPO / "horovod_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_slice9_import_starts_nothing_and_leaves_jax_out(tmp_path):
    """Importing the observability modules imports no JAX, builds no
    engine, starts no thread, opens no server and writes no file."""
    code = ("import sys, threading, horovod_tpu_torch._native as n; "
            "n.BUILD_DIR = __import__('pathlib').Path(sys.argv[1]); "
            "import horovod_tpu_torch, horovod_tpu_torch.metrics as m, "
            "horovod_tpu_torch.timeline as t, "
            "horovod_tpu_torch.conformance, horovod_tpu_torch.health, "
            "horovod_tpu_torch.negotiation, horovod_tpu_torch.utils.faults; "
            "bad = sorted(x for x in sys.modules if x.split('.')[0] in "
            f"{FORBIDDEN!r}); built = list(n.BUILD_DIR.glob('*')); "
            "extra = [th.name for th in threading.enumerate() "
            "if th is not threading.main_thread()]; "
            "print(bad, built, extra, m._server, t._engine); "
            "sys.exit(1 if bad or built or extra or m._server is not None "
            "or t._engine is not None else 0)")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "b")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={**os.environ,
                                           "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("rel", SLICE8)
def test_slice8_module_is_a_port_file(rel):
    path = REPO / "horovod_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_slice8_import_builds_nothing_and_leaves_jax_out(tmp_path):
    """Importing the negotiation modules neither imports JAX nor builds
    the engine: ``g++`` runs at the first service, into the port's own
    ``_build/`` (a library elsewhere is never loaded)."""
    code = ("import sys, horovod_tpu_torch._native as n; "
            "n.BUILD_DIR = __import__('pathlib').Path(sys.argv[1]); "
            "import horovod_tpu_torch.dynamic, "
            "horovod_tpu_torch.engine_service, "
            "horovod_tpu_torch.runner.http_kv, horovod_tpu_torch.ops.adasum; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); built = list(n.BUILD_DIR.glob('*')); "
            "print(bad, built, n._lib); "
            "sys.exit(1 if bad or built or n._lib is not None else 0)")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "b")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_engine_build_without_compiler_raises(monkeypatch, tmp_path):
    """No fallback: an engine that cannot be compiled raises with the
    reason."""
    from horovod_tpu_torch import _native
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_native.NativeBuildError, match="no-such-g"):
        _native.build()


@pytest.mark.parametrize("rel", SLICE7)
def test_slice7_module_is_a_port_file(rel):
    path = REPO / "horovod_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


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
            "horovod_tpu_torch.examples.long_context_lm, "
            "horovod_tpu_torch.examples.moe, "
            "horovod_tpu_torch.examples.pipeline_train, "
            "horovod_tpu_torch.parallel.moe, "
            "horovod_tpu_torch.parallel.pipeline, "
            "horovod_tpu_torch.parallel.mesh, "
            "horovod_tpu_torch.ops.hierarchical, "
            "horovod_tpu_torch.ops.adasum, horovod_tpu_torch.dynamic, "
            "horovod_tpu_torch.engine_service, "
            "horovod_tpu_torch.runner.http_kv, horovod_tpu_torch.metrics, "
            "horovod_tpu_torch.timeline, horovod_tpu_torch.health, "
            "horovod_tpu_torch.conformance, horovod_tpu_torch.negotiation, "
            "horovod_tpu_torch.utils.faults; "
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
