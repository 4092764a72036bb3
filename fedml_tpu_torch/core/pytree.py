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

# kernel rank -> axis order between the port's layouts and flax's, for a
# leaf named "kernel": conv OIHW <-> HWIO, dense (out, in) <-> (in, out)
KERNEL_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0)}
KERNEL_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}


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


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_axpy(a, x: Tree, y: Tree) -> Tree:
    """``a * x + y``, elementwise over the tree (``a`` a scalar or a tensor
    that broadcasts against every leaf)."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def _leaf_sums(a: Tree, b: Tree, reduce) -> torch.Tensor:
    # the reference's tree_reduce(add, ..., 0.0): leaves folded in JAX order
    total = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        total = total + reduce(x.to(torch.float32) * y.to(torch.float32))
    return torch.as_tensor(total, dtype=torch.float32)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Inner product over all leaves, in f32 (a 0-d tensor)."""
    return _leaf_sums(a, b, torch.sum)


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    return tree_dot(tree, tree)


def tree_dot_lanes(a: Tree, b: Tree) -> torch.Tensor:
    """:func:`tree_dot` of each lane: every leaf's leading axis is the lane
    axis (one side may lack it and broadcast); returns ``(L,)``."""
    return _leaf_sums(a, b, lambda t: t.reshape(t.shape[0], -1).sum(1))


def tree_sq_norm_lanes(tree: Tree) -> torch.Tensor:
    return tree_dot_lanes(tree, tree)


def per_lane(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A 0-d ``v``, or one value a lane ``(L,)`` for a lane-stacked
    ``leaf``, shaped to broadcast against ``leaf``."""
    return v.reshape(v.shape + (1,) * (leaf.ndim - v.ndim))


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


def tree_take(tree: Tree, lanes: torch.Tensor) -> Tree:
    """Rows ``lanes`` of every leaf's leading axis, as new tensors (the
    reference's ``jnp.take(leaf, lanes, axis=0)``)."""
    return tree_map(lambda t: t.index_select(0, lanes), tree)


@torch.no_grad()
def tree_scatter_(tree: Tree, lanes: torch.Tensor, updates: Tree) -> None:
    """``leaf.at[lanes].set(update)`` for every leaf, in place: rows
    ``lanes`` (distinct) of each leaf's leading axis take ``updates``'
    rows."""
    tree_map(lambda full, upd: full.index_copy_(0, lanes, upd.to(full.dtype)), tree, updates)


def tree_head(tree: Tree, n: int) -> Tree:
    """The first ``n`` rows of every leaf's leading axis (views)."""
    return tree_map(lambda t: t[:n], tree)


@torch.no_grad()
def tree_set_head_(tree: Tree, n: int, updates: Tree) -> None:
    """The first ``n`` rows of every leaf's leading axis take ``updates``,
    in place."""
    tree_map(lambda full, upd: full[:n].copy_(upd), tree, updates)


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


def named_leaves(tree, name=None):
    """``(key, leaf)`` pairs in JAX leaf order (sorted keys at every level)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], k)
    else:
        yield name, tree


def _flax_lane_axes(name, leaf: torch.Tensor):
    """The permutation that puts a lane-stacked leaf's kernel in flax
    layout behind its lane axis, or None."""
    axes = KERNEL_TO_FLAX.get(leaf.ndim - 1) if name == "kernel" else None
    return None if axes is None else (0,) + tuple(a + 1 for a in axes)


def stacked_tree_to_matrix(stacked: Tree) -> torch.Tensor:
    """``(m, *)`` lane-stacked tree -> ``(m, d)`` f32 matrix (reference
    L128): each row the reference's flat vector of that lane (flax kernels,
    JAX leaf order), so row ``i`` is bitwise the reference's row for the
    same values.  A structured contribution (SCAFFOLD's ``{"delta_c",
    "variables"}``, FedNova's ``{"a", "d", "rest"}``) flattens wholesale."""
    named = list(named_leaves(stacked))
    m = named[0][1].shape[0]
    parts = []
    for name, leaf in named:
        axes = _flax_lane_axes(name, leaf)
        parts.append((leaf.permute(axes) if axes else leaf).reshape(m, -1).to(torch.float32))
    return torch.cat(parts, 1)


def matrix_to_stacked_tree(mat: torch.Tensor, template_stacked: Tree) -> Tree:
    """Inverse of :func:`stacked_tree_to_matrix` (reference L135): the
    template's structure, layouts and dtypes."""
    out, offset = [], 0
    for name, leaf in named_leaves(template_stacked):
        axes = _flax_lane_axes(name, leaf)
        shape = leaf.permute(axes).shape if axes else leaf.shape
        size = leaf[0].numel()
        part = mat[:, offset:offset + size].reshape(shape)
        if axes:
            part = part.permute((0,) + tuple(a + 1 for a in KERNEL_TO_TORCH[leaf.ndim - 1]))
        out.append(part.to(leaf.dtype).contiguous())
        offset += size
    return tree_unflatten_like(template_stacked, out)


def same_structure(a: Tree, b: Tree) -> bool:
    """True when two trees have the same nested keys (JAX's
    ``tree_structure`` equality for dict trees)."""
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if not isinstance(a, dict):
        return True
    return sorted(a) == sorted(b) and all(same_structure(a[k], b[k]) for k in a)
