"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, by top-level name compared whole; the references import nothing
of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from perfbench.frozen import imports
from perfbench.tests import tiny

BENCH = tiny.REPO / "perfbench"


def test_top_level_names_compared_whole():
    mods = ["horovod_tpu_torch", "horovod_tpu_torch.optim", "jaxtyping",
            "numpy", "flaxen", "horovod_tpu_extra"]
    assert imports.forbidden_loaded(mods) == []
    assert imports.forbidden_loaded(mods + [
        "horovod_tpu.ops", "jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "horovod_tpu.ops", "jax", "jaxlib.xla_client"]


def test_the_harness_loads_no_jax():
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "import perfbench.run, perfbench.worker, perfbench.readings\n"
        "import perfbench.check, perfbench.readers\n"
        "import perfbench.families.transformer_lm, perfbench.families.resnet\n"
        "import perfbench.reference.train\n"
        "from perfbench import manifest\n"
        "b = manifest.Bench(Path('.'))\n"
        "for m in b.spec['end_to_end'] + b.spec['per_layer']:\n"
        "    b.reader(m['name'])\n"
        "import horovod_tpu_torch\n"
        "from perfbench.frozen import imports\n"
        "print(json.dumps(imports.forbidden_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: resolve within perfbench
                parts = ["perfbench", *path.relative_to(BENCH).parts[:-1]]
                base = parts[:len(parts) - node.level + 1]
                names.add(".".join(base + ([node.module] if node.module
                                           else [])))
            else:
                names.add(node.module)
    return names


def test_references_import_neither_program_nor_jax():
    allowed_own = ("perfbench.reference", "perfbench.frozen")
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imported(path):
            top = imports.top_level(name)
            assert top not in imports.FORBIDDEN, (path.name, name)
            assert top != imports.PROGRAM, (path.name, name)
            if top == "perfbench":
                assert name.startswith(allowed_own), (path.name, name)


def test_frozen_imports_nothing_of_the_program():
    for path in sorted((BENCH / "frozen").glob("*.py")):
        for name in _imported(path):
            top = imports.top_level(name)
            assert top not in imports.FORBIDDEN | {imports.PROGRAM}, name


def test_check_exits_when_jax_is_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    try:
        imports.check("test")
    except SystemExit as e:
        assert e.code == 3
    else:
        raise AssertionError("no exit")
    assert "jax" in capsys.readouterr().err
