"""The port's ``utils/plotting.py`` on matplotlib's Agg backend (the CPU
machine only: the GPU machine has no matplotlib), and importing
``galerkin_transformer_torch.utils`` imports neither matplotlib nor psutil
(checked in a subprocess, whose imports are its own)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_importing_utils_imports_no_matplotlib_or_psutil():
    code = ("import sys, galerkin_transformer_torch.utils, "
            "galerkin_transformer_torch.utils.plotting, galerkin_transformer_torch.utils.profiling;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'psutil')];"
            "assert not bad, bad; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _mesh(n=5):
    x, y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    node = np.stack([x.ravel(), y.ravel()], 1)
    elem = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            elem += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return node, np.asarray(elem)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("name", ["showmesh", "showsolution", "showsurf", "showcontour",
                                  "showresult"])
def test_plot_returns_an_axis(name, as_tensor):
    pytest.importorskip("matplotlib")
    from galerkin_transformer_torch.utils import plotting
    import matplotlib.pyplot as plt

    wrap = torch.as_tensor if as_tensor else np.asarray
    node, elem = _mesh()
    x, y = node[:, 0].reshape(5, 5), node[:, 1].reshape(5, 5)
    z = np.sin(x) * np.cos(y)
    args = {"showmesh": (wrap(node), wrap(elem)),
            "showsolution": (wrap(node), wrap(elem), wrap(z.ravel())),
            "showsurf": (wrap(x), wrap(y), wrap(z)),
            "showcontour": (wrap(z),),
            "showresult": ({"loss_train": wrap(np.array([[1.0, 0.5], [0.5, 0.2]])),
                            "loss_val": wrap(np.array([0.9, 0.4]))},)}[name]
    ax = getattr(plotting, name)(*args)
    assert hasattr(ax, "figure") and ax.figure is not None
    assert plt.get_backend().lower() == "agg"
    again = getattr(plotting, name)(*args, ax=ax)
    assert again is ax
    plt.close("all")
