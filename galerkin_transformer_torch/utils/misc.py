"""Small generic helpers (reference: libs/utils.py:258-268, libs/layers.py:14-18)."""
from __future__ import annotations

from typing import Mapping, Union

import torch


def default(value, d):
    """None-coalescing helper (reference: libs/layers.py:14-18)."""
    return d if value is None else value


def get_num_params(params: Union[torch.nn.Module, Mapping]) -> int:
    """Total parameter count of a module (its parameters) or of a state
    dict (every tensor in it, nested mappings included).

    Complex tensors count double, as in the JAX package and the reference
    (libs/utils.py:258-268 counts complex parameters twice).
    """
    if isinstance(params, torch.nn.Module):
        leaves = list(params.parameters())
    else:
        leaves, stack = [], [params]
        while stack:
            node = stack.pop()
            if isinstance(node, Mapping):
                stack.extend(node.values())
            elif torch.is_tensor(node):
                leaves.append(node)
    return int(sum(t.numel() * (2 if t.is_complex() else 1) for t in leaves))
