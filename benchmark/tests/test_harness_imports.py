"""What the benchmark may import, and how a run fails."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "mort_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files():
    return [p for p in cells.BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for p in _files():
        for name in _imports(p):
            assert name.split(".")[0] not in FORBIDDEN, (p, name)


def test_the_reference_imports_nothing_of_the_program():
    for p in (cells.BENCH / "reference").rglob("*.py"):
        for name in _imports(p):
            assert name.split(".")[0] not in FORBIDDEN | {"mort_tpu_torch"}, \
                (p, name)
            assert not name.startswith("benchmark.loops"), (p, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "mort_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy_fake", object())
    assert run.forbidden_modules() == ["jax"]


def _run(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mort_scene1.frames", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_run_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA card")
    r = _run(cells.ROOT)
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "CUDA" in r.stderr


def test_run_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert not r.stdout.strip()
