"""The check that nothing the run loaded is JAX or the JAX package: each
module's top-level name (before the first dot) compared whole, so the
port, convectionkernels_tpu_torch, passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "convectionkernels_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among `names` (default: sys.modules)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
