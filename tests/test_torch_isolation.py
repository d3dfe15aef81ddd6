"""The port stands alone: it imports neither jax nor the JAX package.

The import check runs in a subprocess, because tests/conftest.py imports
jax into the test process itself.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import galerkin_transformer_torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "galerkin_transformer_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        galerkin_transformer_torch.__path__, "galerkin_transformer_torch."))


def test_port_modules_and_chip_smoke_import_no_jax():
    modules = _modules()
    for name in ("ops.cuda.galerkin", "ops.interp", "models.conv", "models.scaler",
                 "models.transformer", "data.darcy", "data.normalizer", "ops.fem",
                 "data.synthetic", "train.steps", "train.losses", "examples._darcy",
                 "examples.ex2_darcy", "examples.ex3_darcy_inv"):
        assert f"galerkin_transformer_torch.{name}" in modules
    code = "\n".join(
        [f"import {m}" for m in modules]
        + ["import chip_smoke",
           "import sys",
           "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
           " or m in ('flax', 'optax') or m.startswith('galerkin_transformer_tpu')]",
           "assert not bad, bad",
           "print('ok')"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax():
    imports = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|galerkin_transformer_tpu)\b",
                         re.M)
    files = [f for f in PACKAGE.rglob("*") if f.suffix in (".py", ".cu")]
    assert len(files) > 40
    assert {f.name for f in files} >= {"galerkin_scores_bf16.cu", "fourier_chain_bf16.cu",
                                       "galerkin_scores_bwd_bf16.cu",
                                       "fourier_chain_mixed.cu", "ex2_darcy.py", "fem.py"}
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files + [ROOT / "chip_smoke.py"]
            for m in imports.finditer(f.read_text())]
    # the package does not even name the JAX package
    hits += [str(f.relative_to(ROOT)) for f in files
             if "galerkin_transformer_tpu" in f.read_text()]
    assert hits == []
