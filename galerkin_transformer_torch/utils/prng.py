"""Explicit seeding (counterpart of ``utils/prng.py``).

The reference framework pushes one global seed (1127802) into the Python,
numpy and torch generators (reference: libs/utils.py:123-152).  As in the
JAX package, `get_seed` seeds the host generators that the data pipeline
uses and returns an explicit generator for parameter init and dropout:
here a ``torch.Generator`` where JAX returns a ``jax.random`` key.
"""
from __future__ import annotations

import os
import random
from typing import Any, Optional, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .device import resolve_device

SEED = int(os.environ.get("SEED", 1127802))


def get_seed(seed: int = SEED, printout: bool = False, cudnn: bool = True,
             device: Optional[Union[str, torch.device]] = None) -> torch.Generator:
    """Seed ``PYTHONHASHSEED``, Python's `random` and numpy's global
    generator with `seed`, and return a ``torch.Generator`` on `device`
    (None is the GPU, as for the port's entry points; without one it
    raises unless ``device="cpu"``) seeded with `seed`.

    `cudnn`: True (the reference's default) sets
    ``torch.backends.cudnn.deterministic = True`` and
    ``torch.backends.cudnn.benchmark = False``, as the reference's
    ``get_seed`` does, so that cuDNN picks deterministic algorithms; False
    leaves cuDNN's settings as they are.  (The JAX package accepts it and
    does nothing: XLA has no cuDNN switch.)  Torch's global generators are
    not seeded: the port draws from explicit generators.
    """
    dev = resolve_device(device)
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    if cudnn:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if printout:
        print(f"seed = {seed} (host numpy/python seeded; torch generator on {dev} returned)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def split_like(generator: torch.Generator, tree: Any):
    """One generator per leaf of `tree` (a state dict, or nested mappings,
    lists and tuples), returned in the tree's structure.  Each is seeded
    from a draw of `generator` (on its device), so the same generator state
    gives the same generators."""
    leaves, spec = tree_flatten(tree)
    seeds = torch.randint(0, 2 ** 62, (len(leaves),), generator=generator,
                          device=generator.device, dtype=torch.int64).tolist()
    gens = []
    for s in seeds:
        g = torch.Generator(device=generator.device)
        g.manual_seed(s)
        gens.append(g)
    return tree_unflatten(gens, spec)
