"""Plots (counterpart of ``utils/plotting.py``; reference
libs/utils_ft.py:309-449): showmesh, showsolution, showsurf, showcontour
and showresult on matplotlib's ``Agg`` backend.  Each takes numpy arrays
or tensors (on any device), accepts ``ax=`` and returns the axis.

matplotlib is imported inside each function, never with the module: the
GPU machine has no matplotlib, so these run on the CPU machine only."""
from __future__ import annotations

import numpy as np


def _np(x):
    if hasattr(x, "detach"):   # a tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _require_plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def showmesh(node, elem, ax=None, **kwargs):
    """Triangulation wireframe (utils_ft.py:309-324)."""
    plt = _require_plt()
    node = _np(node)
    ax = ax or plt.subplots(figsize=kwargs.pop("figsize", (6, 6)))[1]
    ax.triplot(node[:, 0], node[:, 1], _np(elem), lw=0.4, color=kwargs.pop("color", "k"))
    ax.set_aspect("equal")
    ax.axis("off")
    return ax


def showsolution(node, elem, u, ax=None, cmap="RdBu_r", **kwargs):
    """P1 FEM solution on a triangulation (utils_ft.py:327-356)."""
    plt = _require_plt()
    node = _np(node)
    ax = ax or plt.subplots(figsize=kwargs.pop("figsize", (6, 5)))[1]
    tpc = ax.tripcolor(node[:, 0], node[:, 1], _np(elem), _np(u).ravel(),
                       shading="gouraud", cmap=cmap)
    plt.colorbar(tpc, ax=ax, shrink=0.8)
    ax.set_aspect("equal")
    return ax


def showsurf(x, y, z, ax=None, cmap="viridis", **kwargs):
    """Surface plot of gridded data (utils_ft.py:359-387)."""
    plt = _require_plt()
    if ax is None:
        fig = plt.figure(figsize=kwargs.pop("figsize", (7, 5)))
        ax = fig.add_subplot(projection="3d")
    ax.plot_surface(_np(x), _np(y), _np(z), cmap=cmap, linewidth=0, antialiased=True)
    return ax


def showcontour(z, ax=None, levels=20, cmap="RdBu_r", **kwargs):
    """Filled contour of a 2D field (utils_ft.py:390-419)."""
    plt = _require_plt()
    ax = ax or plt.subplots(figsize=kwargs.pop("figsize", (6, 5)))[1]
    cs = ax.contourf(_np(z), levels=levels, cmap=cmap)
    plt.colorbar(cs, ax=ax, shrink=0.8)
    ax.set_aspect("equal")
    return ax


def showresult(result: dict, ax=None, **kwargs):
    """Training and validation curves from a `run_train` result dict
    (utils_ft.py:422-449)."""
    plt = _require_plt()
    ax = ax or plt.subplots(figsize=kwargs.pop("figsize", (7, 4)))[1]
    loss_train = _np(result["loss_train"])
    if loss_train.ndim > 1:
        loss_train = loss_train[:, 0]
    ax.semilogy(loss_train, label="train")
    ax.semilogy(_np(result["loss_val"]), label="valid")
    ax.grid(True, which="both", ls="--", alpha=0.4)
    ax.set_xlabel("epoch")
    ax.set_ylabel("relative error")
    ax.legend()
    return ax
