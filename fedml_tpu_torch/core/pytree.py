"""Tree utilities over nested dicts of tensors.

The port's model state is a nested ``dict`` mirroring the flax variable tree
(``{"params": {...}, "batch_stats": {...}}``), so the JAX package's pytree
helpers (``fedml_tpu/core/pytree.py``) become recursions over dicts.  Leaves
are visited in JAX's order: sorted keys at every level, which is the order
the wire format and the flat-vector helpers depend on.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten_like(template: Tree, leaves) -> Tree:
    """Rebuild ``template``'s structure from ``leaves`` in JAX order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_weighted_mean(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted mean over a leading "clients" axis (``fedml_tpu`` L68):
    ``weights`` is normalised internally, the sum runs in f32 and each leaf
    keeps its dtype."""
    w = weights.to(torch.float32)
    w = w / torch.clamp(w.sum(), min=1e-12)

    def avg(leaf):
        wb = w.reshape((-1,) + (1,) * (leaf.ndim - 1))
        return (leaf.to(torch.float32) * wb).sum(0).to(leaf.dtype)

    return tree_map(avg, stacked)


def tree_stack(trees: Sequence[Tree]) -> Tree:
    """Stack identically-structured trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *trees)


def tree_flatten_to_vector(tree: Tree) -> tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """Flatten a tree into one f32 vector (JAX leaf order) + an unravel
    closure restoring shapes and dtypes."""
    leaves = tree_leaves(tree)
    shapes = [leaf.shape for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    flat = (torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
            if leaves else torch.zeros(0, dtype=torch.float32))

    def unravel(vec: torch.Tensor) -> Tree:
        out, offset = [], 0
        for shape, dtype in zip(shapes, dtypes):
            size = 1
            for d in shape:
                size *= d
            out.append(vec[offset:offset + size].reshape(shape).to(dtype))
            offset += size
        return tree_unflatten_like(tree, out)

    return flat, unravel
