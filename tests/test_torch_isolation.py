"""The port stands alone: it imports neither jax (flax, optax) nor the JAX
package, nor msgpack (its reader of JAX checkpoints is pure Python); nor
does the module of rank functions that the multi-process tests spawn
(``tests/torch_parallel_ranks.py``).  Importing it imports neither
matplotlib nor psutil, which the GPU machine lacks (the modules that use
them import them inside their functions).

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
                 "examples.ex2_darcy", "examples.ex3_darcy_inv", "data.ns",
                 "data.synthetic_torch", "examples.ex4_navier_stokes", "utils.args",
                 "utils.naming", "train.checkpoint", "train.schedule", "train.trainer",
                 "train.device_loop", "utils.torch_compat",
                 "examples.ex1_burgers_super_res", "models.graph", "ops.fem_native",
                 "ops.sparse", "models.random_fourier",
                 "examples.ex1_burgers_random_fourier_features", "parallel",
                 "parallel.mesh", "parallel.galerkin", "parallel.launch",
                 "examples.distributed_data_parallel", "models.encoder",
                 "utils.misc", "utils.prng", "utils.timing", "utils.system",
                 "utils.plotting", "utils.profiling", "ops.cuda._cost",
                 "examples._profile", "examples.ex1_memory_profile",
                 "examples.ex2_memory_profile", "examples.ex3_memory_profile",
                 "examples.encoder_memory_profile", "eval", "eval.ex1_burgers_eval",
                 "eval.ex2_darcy_eval", "eval.ex3_darcy_inv_eval"):
        assert f"galerkin_transformer_torch.{name}" in modules
    code = "\n".join(
        [f"import {m}" for m in modules]
        + ["import chip_smoke",
           "import sys",
           # the rank functions that the multi-process tests spawn
           f"sys.path.insert(0, {str(ROOT / 'tests')!r})",
           "import torch_parallel_ranks",
           "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
           " or m in ('flax', 'optax', 'msgpack') or m.startswith('flax.')"
           " or m.startswith('msgpack.') or m.startswith('galerkin_transformer_tpu')]",
           "assert not bad, bad",
           "lazy = [m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'psutil')]",
           "assert not lazy, lazy",
           "print('ok')"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax():
    imports = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|msgpack|galerkin_transformer_tpu)\b", re.M)
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
