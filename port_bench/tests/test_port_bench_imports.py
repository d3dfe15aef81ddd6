"""No module the benchmark runs is JAX or the JAX package, and the plain
reference imports nothing of the port: top-level module names, compared
whole (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import types

import pytest
from conftest import ROOT

from port_bench import harness

SOURCES = sorted(os.path.join(d, f) for d, _, files in os.walk(harness.BENCH_DIR)
                 for f in files if f.endswith(".py") and "/tests" not in d)


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in SOURCES if "/reference/" in p],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_port(path):
    assert not _imports(path) & set(harness.FORBIDDEN + ("galerkin_transformer_torch",))


def test_forbidden_names_compared_whole(monkeypatch):
    before = harness.imported_forbidden()
    for lookalike in ("jaxtools", "galerkin_transformer_tpu_extra", "flaxen.core"):
        monkeypatch.setitem(sys.modules, lookalike, types.ModuleType(lookalike))
    assert harness.imported_forbidden() == before
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert "flax" in harness.imported_forbidden()


RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import tiny
from port_bench import harness
r = harness.run("ex1-fourier.serve-n8192", 5, 0.2, False, device="cpu",
                cell=tiny("ex1-fourier.serve-n8192"))
print(json.dumps({{"held": harness.imported_forbidden(), "correct": r["correct"]}}))
"""


def test_a_run_loads_no_jax():
    """A run of a tiny cell, in a process of its own, holds none of the
    forbidden modules once its window has closed."""
    code = RUN_TINY.format(root=ROOT, tests=os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == {"held": [], "correct": True}


def test_command_refuses_without_a_card():
    """Where the cell's chips are not there, the command prints no result
    and exits with 2 (here: no CUDA device)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "ex1-fourier.serve-n8192", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
