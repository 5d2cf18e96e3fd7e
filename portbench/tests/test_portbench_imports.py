"""What the benchmark's files import: no module of JAX or of the JAX
package anywhere (top-level names compared whole), nothing of the port in
the reference or the comparison, nothing but the standard library in the
clients' process."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import core

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(core.BENCH_DIR) for f in fs
               if f.endswith(".py"))


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, core.BENCH_DIR))
def test_no_forbidden_module(path):
    assert not top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p
                                  or p.endswith(("compare.py", "counts/__init__.py"))],
                         ids=lambda p: os.path.relpath(p, core.BENCH_DIR))
def test_reference_imports_nothing_of_the_port(path):
    assert "tacotron2_vae_torch" not in top_level_imports(path)


def test_the_forbidden_check_compares_whole_names():
    assert core.forbidden_modules(["tacotron2_vae_torch", "tacotron2_vae_torch.models",
                                   "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "tacotron2_vae_tpu.config"]) == [
        "jax", "tacotron2_vae_tpu"]


def test_client_process_loads_no_torch():
    code = ("import sys, portbench.client; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'tacotron2_vae_torch')))")
    out = subprocess.run([sys.executable, "-B", "-c", code], cwd=core.ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "[]"


def test_reference_loads_without_the_port():
    code = ("import sys, portbench.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tacotron2_vae_torch', 'jax', 'tacotron2_vae_tpu'}))")
    out = subprocess.run([sys.executable, "-B", "-c", code], cwd=core.ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "[]"
