"""Debug-mode NaN/Inf guard (port of `cgs_tpu/utils/profiling.py:nan_guard`).

The JAX package's `Profiler` (`--profile`, an xplane trace) waits for
its `torch.profiler` port (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def nan_guard(tree, where: str = "") -> None:
    """Raise FloatingPointError on the first non-finite floating leaf
    of a nested dict/list of tensors or arrays (`-debug_nan`)."""
    for name, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf).all())
        elif isinstance(leaf, np.ndarray):
            bad = np.issubdtype(leaf.dtype, np.floating) and not bool(
                np.isfinite(leaf).all())
        else:
            continue
        if bad:
            raise FloatingPointError(f"non-finite values in {where}{name}")
