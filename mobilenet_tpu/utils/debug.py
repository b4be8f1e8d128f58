"""Numerics debugging: the rebuild's analog of the reference's sw_emu/hw_emu
sanitizer tiers (SURVEY.md SS5 'Race detection / sanitizers').

  - `checked_forward` — checkify-wrapped forward that traps NaN/Inf and
    reports the failing layer
  - `assert_finite_tree` — host-side pytree NaN/Inf sweep
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.experimental import checkify


def checked_forward(params, x, config, **kw):
    """Run the forward pass under checkify NaN/div-by-zero checks.

    Returns (error, logits); error.throw() raises with the first bad op's
    source location — the in-graph analog of per-layer golden divergence.
    """
    from ..models import mobilenet_v1

    def fn(params, x):
        return mobilenet_v1.forward(params, x, config, **kw)

    checked = checkify.checkify(fn, errors=checkify.float_checks)
    return checked(params, x)


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    bad = []

    def visit(path, leaf):
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            bad.append(jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(visit, tree)
    if bad:
        raise AssertionError(f"non-finite values in {name}: {bad}")


def nan_debug_enabled() -> bool:
    return bool(jax.config.read("jax_debug_nans"))
