"""The port's ``utils`` against the JAX package's, on the CPU: `DotDict`,
`load_config` and `merge_config`; the namespaces of the two packages;
`get_num_params`; `get_seed` and `split_like`; the timers; `get_system`
and the file helpers.
"""
import argparse
import ast
import os
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import galerkin_transformer_tpu.utils as jax_utils
import galerkin_transformer_torch as port
from galerkin_transformer_torch import utils as port_utils

ROOT = Path(__file__).resolve().parents[1]

# names the JAX package exports that have no counterpart in the port, each
# with its reason
JAX_ONLY = {
    ("utils", "module jax_setup"): "XLA's compilation cache and flags; the port's "
                                   "counterparts are utils/args.py (matmul precision) and "
                                   "utils/device.py",
}


def test_load_config_returns_jax_dotdict():
    """Fails on a plain dict: `load_config("ex1_burgers").n_hidden` raised
    AttributeError in the port."""
    for block in ("ex1_burgers", "ex2_darcy", "ex3_darcy_inv", "ex4_navier_stokes"):
        got, want = port_utils.load_config(block), jax_utils.load_config(block)
        assert isinstance(got, port_utils.DotDict)
        assert dict(got) == dict(want)
        assert got.n_hidden == want.n_hidden
        assert got.no_such_key is None and want.no_such_key is None
    cfg = port_utils.load_config("ex1_burgers")
    assert cfg.n_hidden == 96
    cfg.attention_type = "galerkin"       # attribute set
    assert cfg["attention_type"] == "galerkin"
    cfg["n_head"] = 3                      # item set, as the drivers do
    assert cfg.n_head == 3
    del cfg.n_head
    assert "n_head" not in cfg and cfg.n_head is None
    # a fresh copy every time
    assert port_utils.load_config("ex1_burgers").attention_type == "fourier"


def test_load_config_reads_a_yaml_path_like_jax(tmp_path):
    got = port_utils.load_config("ex2_darcy", path=str(ROOT / "config.yml"))
    assert isinstance(got, port_utils.DotDict)
    assert got == jax_utils.load_config("ex2_darcy", path=str(ROOT / "config.yml"))
    own = tmp_path / "own.yml"
    own.write_text("mine:\n  n_hidden: 7\n  attention_type: galerkin\n")
    assert port_utils.load_config("mine", path=str(own)).n_hidden == 7
    with pytest.raises(KeyError):
        port_utils.load_config("absent", path=str(own))


def test_load_config_path_without_pyyaml_names_the_package(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("no yaml here")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ImportError, match="PyYAML"):
        port_utils.load_config("ex1_burgers", path=str(ROOT / "config.yml"))
    assert port_utils.load_config("ex1_burgers").n_hidden == 96   # embedded: no YAML


def test_merge_config_matches_jax():
    ns = argparse.Namespace(n_hidden=64, attention_type=None, not_a_key=3)
    for overlays in ((ns,), ({"extra": 1, "n_head": 2},), (ns, None, {"n_head": 4})):
        got = port_utils.merge_config(port_utils.load_config("ex1_burgers"), *overlays)
        want = jax_utils.merge_config(jax_utils.load_config("ex1_burgers"), *overlays)
        assert isinstance(got, port_utils.DotDict)
        assert dict(got) == dict(want)
        assert got.n_hidden == want.n_hidden and got.not_a_key is None


def _exports(root: Path, sub: str) -> set:
    """The names a package's ``__init__.py`` imports, by AST."""
    tree = ast.parse((root / sub / "__init__.py").read_text())
    return {alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names}


@pytest.mark.parametrize("sub", ["", "ops", "models", "data", "train", "parallel", "utils"])
def test_namespaces_export_every_jax_name(sub):
    """Fails before the port exported them: the top level imported no
    subpackage, ``models`` lacked the graph layers, `get_activation` and
    the decoder, ``ops`` exported nothing, ``utils`` lacked twelve names."""
    want = _exports(ROOT / "galerkin_transformer_tpu", sub)
    got = _exports(ROOT / "galerkin_transformer_torch", sub)
    missing = {name for name in want - got if (sub, name) not in JAX_ONLY}
    assert not missing, missing
    module = port if not sub else getattr(port, sub)
    for name in want:
        assert hasattr(module, name), name


def test_utils_modules_match_jax_but_the_listed_ones():
    def modules(pkg):
        return {p.stem for p in (ROOT / pkg / "utils").glob("*.py") if p.stem != "__init__"}
    missing = {m for m in modules("galerkin_transformer_tpu") - modules(
        "galerkin_transformer_torch") if ("utils", f"module {m}") not in JAX_ONLY}
    assert not missing, missing
    assert all(reason for reason in JAX_ONLY.values())


def test_importing_the_package_starts_no_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("block,want", [("ex1_burgers", 530305),
                                        ("ex4_navier_stokes", 862049)])
def test_get_num_params_matches_jax(block, want):
    from galerkin_transformer_torch.models import (FourierTransformer2DLite,
                                                   SimpleTransformer)
    cls = SimpleTransformer if block == "ex1_burgers" else FourierTransformer2DLite
    model = cls.from_config(port_utils.load_config(block), device="cpu")
    assert port_utils.get_num_params(model) == want
    assert port_utils.get_num_params(model.state_dict()) >= want   # buffers count too
    params = {k: v for k, v in model.named_parameters()}
    assert port_utils.get_num_params(params) == want
    assert port_utils.get_num_params({"a": params}) == want


def test_get_num_params_counts_complex_double():
    tree = {"w": torch.zeros(3, 4, dtype=torch.complex64), "b": torch.zeros(5)}
    jtree = {"w": np.zeros((3, 4), np.complex64), "b": np.zeros(5, np.float32)}
    assert port_utils.get_num_params(tree) == jax_utils.get_num_params(jtree) == 29


def test_get_seed_seeds_what_jax_seeds():
    draws = {}
    for name, get_seed in (("jax", jax_utils.get_seed), ("port", port_utils.get_seed)):
        kwargs = {"device": "cpu"} if name == "port" else {}
        get_seed(1234, **kwargs)
        draws[name] = (np.random.rand(5), random.random(), os.environ["PYTHONHASHSEED"])
    assert np.array_equal(draws["jax"][0], draws["port"][0])
    assert draws["jax"][1:] == draws["port"][1:]
    g = port_utils.get_seed(1234, device="cpu")
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(1234)))


def test_get_seed_cudnn_flag():
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        port_utils.get_seed(1, cudnn=False, device="cpu")
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (
            False, True)
        port_utils.get_seed(1, device="cpu")
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (
            True, False)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench


def test_get_seed_on_the_gpu_by_default_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_utils.get_seed(1)


def test_split_like_keeps_the_tree_and_is_deterministic():
    tree = {"a": torch.zeros(2), "b": [torch.zeros(3), {"c": torch.zeros(1)}]}
    one = port_utils.split_like(torch.Generator().manual_seed(0), tree)
    two = port_utils.split_like(torch.Generator().manual_seed(0), tree)
    assert isinstance(one["b"][1]["c"], torch.Generator)
    assert set(one) == {"a", "b"} and len(one["b"]) == 2
    draws = lambda t: [torch.rand(3, generator=g) for g in (t["a"], t["b"][0], t["b"][1]["c"])]
    d1, d2 = draws(one), draws(two)
    assert all(torch.equal(x, y) for x, y in zip(d1, d2))
    assert not torch.equal(d1[0], d1[1])   # one stream per leaf
    sd = {"w": torch.zeros(2), "v": torch.zeros(2)}
    assert set(port_utils.split_like(torch.Generator().manual_seed(0), sd)) == {"w", "v"}


LINE = {"timer": re.compile(r"^(.*) - done in (\d+\.\d{2}) s, mem delta ([+-]\d+\.\d{3}) GB$"),
        "simple_timer": re.compile(r"^(.*) - done in (\d+\.\d{4}) s$")}


@pytest.mark.parametrize("name", ["timer", "simple_timer"])
def test_timers_print_the_jax_line(name, capsys):
    lines = {}
    for pkg, mod in (("jax", jax_utils), ("port", port_utils)):
        with getattr(mod, name)("Loading x.mat"):
            sum(range(1000))
        lines[pkg] = capsys.readouterr().out.strip()
    for pkg, line in lines.items():
        m = LINE[name].match(line)
        assert m and m.group(1) == "Loading x.mat", (pkg, line)
        assert all(np.isfinite(float(g)) for g in m.groups()[1:]), (pkg, line)


def test_rss_without_psutil_reads_proc(monkeypatch):
    import builtins

    from galerkin_transformer_torch.utils import timing
    with_psutil = timing.rss_bytes()
    real = builtins.__import__

    def no_psutil(name, *args, **kwargs):
        if name == "psutil":
            raise ImportError("no psutil here")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_psutil)
    without = timing.rss_bytes()
    assert without > 0 and abs(without - with_psutil) <= 0.1 * with_psutil
    assert np.isfinite(port_utils.get_memory("MB"))
    assert port_utils.get_system(device="cpu")["ram_gb"] > 0


def test_get_system_keys():
    got = port_utils.get_system(device="cpu")
    want = jax_utils.get_system()
    shared = {"platform", "platform_release", "architecture", "processor", "python",
              "cpu_count", "backend", "devices", "ram_gb"}
    assert shared <= set(got) and shared <= set(want)
    for key in ("platform", "platform_release", "architecture", "python", "cpu_count"):
        assert got[key] == want[key]
    assert got["torch_version"] == torch.__version__
    assert got["backend"] == "cpu" and isinstance(got["devices"], list) and got["devices"]


def test_file_helpers_match_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    for name in ("a_ckpt.pt", "sub/b_ckpt.pt", "c.txt"):
        (tmp_path / name).write_bytes(b"x" * 2048)
    for fn in ("find_files",):
        assert sorted(getattr(port_utils, fn)("ckpt", str(tmp_path))) == sorted(
            getattr(jax_utils, fn)("ckpt", str(tmp_path)))
    path = str(tmp_path / "c.txt")
    for unit in ("B", "KB", "MB"):
        assert port_utils.get_file_size(path, unit) == jax_utils.get_file_size(path, unit)
    obj = {"a": [1, 2, (3, "x")], "b": {"c": 1.5}}
    assert port_utils.get_size(obj) == jax_utils.get_size(obj)
    assert port_utils.is_interactive() == jax_utils.is_interactive() is False
