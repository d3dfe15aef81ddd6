"""Small generic helpers (reference: libs/layers.py:14-18)."""
from __future__ import annotations


def default(value, d):
    """None-coalescing helper (reference: libs/layers.py:14-18)."""
    return d if value is None else value
