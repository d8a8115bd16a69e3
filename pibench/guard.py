"""The check that a run loaded no JAX and not the JAX package.

Names are compared whole at the top level (the part before the first
dot): ``repro_torch``, the program under test, begins with ``repro``,
the JAX package it was ported from, and must not match it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (default: ``sys.modules``) that
    are JAX's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
