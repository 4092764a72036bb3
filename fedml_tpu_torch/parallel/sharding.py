"""Parameter sharding rules over a mesh of ranks (the port of
``fedml_tpu/parallel/sharding.py``).

The reference shards an LLM's parameters with ``PartitionSpec`` rules
(path regex -> spec): sharding a leaf over the ``data`` axis is ZeRO-3 and
GSPMD inserts the gathers; the ``model`` axis is tensor parallelism.  Here
a spec is a plain tuple, one entry a dim (an axis name or None), equal
entry by entry to the reference's ``PartitionSpec``, and the rules, the
degrade rules and the path strings are the reference's:

- an axis absent from the mesh or of size 1 becomes None;
- an entry whose axis does not divide its dim becomes None;
- a spec is cut or padded with None to the leaf's rank; a leaf no rule
  matches is replicated (``()``).

What GSPMD does with the specs is done here by hand, over host copies
(``parallel/multihost.py``): :func:`shard_params` keeps a rank's block of
every leaf (its coordinates on each axis a spec names), and
:func:`gather_params` all-gathers the blocks back into whole leaves.  The
``model`` axis is storage only: the trainer computes each product whole
(``llm/train.py``, ROADMAP Queue 3).
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from .mesh import AXIS_DATA, AXIS_MODEL, Mesh

# (regex over 'layer_0/attn/wq/kernel'-style paths, spec builder); kernels
# are (in, out) or (in, heads, head_dim)
TRANSFORMER_RULES = [
    (r".*attn/w[qkv]/kernel", lambda dp, tp: (dp, tp, None)),
    (r".*attn/wo/kernel", lambda dp, tp: (tp, None, dp)),
    (r".*mlp/w_(gate|up)/kernel", lambda dp, tp: (dp, tp)),
    (r".*mlp/w_down/kernel", lambda dp, tp: (tp, dp)),
    (r".*embed/embedding", lambda dp, tp: (tp, dp)),
    (r".*lm_head/kernel", lambda dp, tp: (dp, tp)),
    (r".*norm.*/scale", lambda dp, tp: ()),
]


def map_with_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def partition_specs(params, rules=TRANSFORMER_RULES, dp_axis: Optional[str] = AXIS_DATA,
                    tp_axis: Optional[str] = AXIS_MODEL, mesh: Optional[Mesh] = None):
    """A tree of spec tuples for ``params`` by the first rule that matches
    each leaf's path (the reference's ``partition_specs``)."""
    def axis_or_none(name):
        if name is None or mesh is None:
            return name
        return name if (name in mesh.shape and mesh.shape[name] > 1) else None

    dp = axis_or_none(dp_axis)
    tp = axis_or_none(tp_axis)

    def spec_for(path, leaf):
        ndim = len(leaf.shape)
        for pattern, builder in rules:
            if re.fullmatch(pattern, path):
                entries = list(builder(dp, tp))[:ndim]
                entries += [None] * (ndim - len(entries))
                return tuple(
                    e if e is not None and leaf.shape[i] % (mesh.shape[e] if mesh else 1) == 0
                    else None
                    for i, e in enumerate(entries))
        return ()

    return map_with_path(spec_for, params)


def batch_sharding(mesh: Mesh, dp_axis: str = AXIS_DATA, seq_axis: Optional[str] = None):
    """The ``(batch, seq)`` spec of the activations: the batch over ``dp``,
    the sequence over ``seq`` (each None where the axis is absent or of
    size 1)."""
    dp = dp_axis if dp_axis in mesh.shape and mesh.shape[dp_axis] > 1 else None
    sp = seq_axis if seq_axis and seq_axis in mesh.shape and mesh.shape[seq_axis] > 1 else None
    return (dp, sp)


def block_index(shape, spec: tuple, mesh: Mesh, rank: int) -> tuple:
    """The slices of a leaf of ``shape`` that rank ``rank`` owns under
    ``spec``: a contiguous block on each dim the spec shards."""
    coords = mesh.coords(rank)
    out = []
    for i, dim in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        if axis is None:
            out.append(slice(None))
        else:
            per = dim // mesh.shape[axis]
            out.append(slice(coords[axis] * per, (coords[axis] + 1) * per))
    return tuple(out)


def shard_params(params, specs, mesh: Mesh, rank: int):
    """Rank ``rank``'s block of every leaf, a copy of its own (ZeRO-3
    storage)."""
    return map_with_path(
        lambda path, leaf: leaf[block_index(leaf.shape, spec_at(specs, path), mesh,
                                            rank)].clone(), params)


def spec_at(specs, path: str) -> tuple:
    node = specs
    for key in path.split("/"):
        node = node[key]
    return node


def gather_params(local, specs, shapes, mesh: Mesh):
    """Whole leaves from every rank's blocks (``shapes`` the leaves' whole
    shapes, a tree like ``specs``): each leaf's block is all-gathered over
    the world and every rank's block written at its place (ranks that
    replicate a block hold the same values)."""
    from .multihost import all_gather

    def gather(path, block):
        spec = spec_at(specs, path)
        if not any(spec):
            return block
        shape = spec_at(shapes, path)
        full = block.new_empty(shape)
        for r, got in enumerate(all_gather(block)):  # the mesh holds every rank
            full[block_index(shape, spec, mesh, r)] = got
        return full

    return map_with_path(gather, local)


def leaf_shapes(params):
    """The tree of the leaves' shapes."""
    return map_with_path(lambda path, leaf: tuple(leaf.shape), params)


def local_block(t: torch.Tensor, spec: tuple, mesh: Mesh, rank: int) -> torch.Tensor:
    """``t``'s block of rank ``rank`` under ``spec`` (a view)."""
    return t[block_index(t.shape, spec, mesh, rank)]
