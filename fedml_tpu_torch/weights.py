"""Conversion between flax variables and the port's variables.

Both sides are nested numpy dicts ``{"params": ..., "batch_stats": ...}``
with the same keys; only layouts differ:

- Conv kernels: flax HWIO <-> torch OIHW;
- Dense kernels: flax ``(in, out)`` <-> torch ``(out, in)``;
- BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` and Dense ``bias`` as
  they are.

The two directions are exact inverses, so aggregated state can be compared
leaf by leaf.  :func:`to_torch` / :func:`to_numpy` move a converted tree
between numpy and tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _convert(tree, leaf_fn):
    if isinstance(tree, dict):
        return {k: (leaf_fn(k, v) if not isinstance(v, dict) else _convert(v, leaf_fn))
                for k, v in tree.items()}
    raise TypeError(f"expected a dict of variables, got {type(tree).__name__}")


# kernel rank -> axis order: conv HWIO -> OIHW, dense (in, out) -> (out, in)
_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}
_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0)}


def _relayout(axes: dict):
    def leaf(name: str, a) -> np.ndarray:
        a = np.asarray(a)
        if name == "kernel" and a.ndim in axes:
            return np.ascontiguousarray(a.transpose(axes[a.ndim]))
        return a.copy()

    return leaf


def flax_to_torch(variables: dict) -> dict:
    """flax variables (numpy leaves) -> the port's layout (numpy leaves)."""
    return _convert(variables, _relayout(_TO_TORCH))


def torch_to_flax(variables: dict) -> dict:
    """The port's layout (numpy leaves) -> flax variables (numpy leaves)."""
    return _convert(variables, _relayout(_TO_FLAX))


def to_torch(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32 if tree.is_floating_point() else tree.dtype).numpy()
