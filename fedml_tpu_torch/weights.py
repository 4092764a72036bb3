"""Conversion between flax variables and the port's variables.

Both sides are nested numpy dicts ``{"params": ..., "batch_stats": ...}``
with the same keys; only layouts differ:

- Conv kernels: flax HWIO <-> torch OIHW;
- Dense kernels: flax ``(in, out)`` <-> torch ``(out, in)``;
- BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` and the Dense and
  Conv ``bias`` as they are.

So every model of the port carries its flax weights across leaf by leaf:
the ResNets, the small models of ``models/simple.py``, the zoo of
``models/cnn_zoo.py`` (a depthwise kernel is flax ``(kh, kw, 1, C)``, torch
``(C, 1, kh, kw)``; GroupNorm's ``scale`` / ``bias`` as they are) and the
LSTMs of ``models/rnn.py`` (each gate kernel a Dense kernel, transposed;
``Embed_0/embedding`` is not a kernel and stays as it is), the GAN pair,
the DARTS supernet (its ``alphas`` are not a kernel and stay as they are)
and the UNet (a ``ConvTranspose`` kernel takes the generic relayout of a
conv kernel, flax ``(kh, kw, I, O)`` to ``(O, I, kh, kw)``; the model flips
it where it applies it).  Stacked trees (``lanes=True``: per-client
bottoms and heads, per-party towers) keep their leading axis.  The
transformer (``models/transformer.py``) keeps flax's layouts, and so do
LoRA adapter trees: :func:`tree_from_flax` and :func:`to_numpy` copy them
leaf for leaf and transpose nothing (:func:`flax_to_torch` would
transpose the 2-D ``lm_head`` and MLP kernels).

The two directions are exact inverses, so aggregated state can be compared
leaf by leaf.  :func:`to_torch` / :func:`to_numpy` move a converted tree
between numpy and tensors; :func:`tensors_to_flax` / :func:`tensors_from_flax`
relayout a tree of tensors where it lies (the cross-silo upload's delta and
the server's fold are in flax layout on the card).

:func:`flatten_reference` flattens the port's tree on its own device into
the flat f32 vector the JAX package's ``tree_flatten_to_vector`` gives for
the same weights in flax layout.  Block-wise operators on flat vectors
(``qsgd_int8``'s 1024-element blocks) see the reference's elements in the
reference's order only through it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .core.pytree import (KERNEL_TO_FLAX as _TO_FLAX, KERNEL_TO_TORCH as _TO_TORCH,
                          named_leaves as _named_leaves, tree_unflatten_like)


def _convert(tree, leaf_fn):
    if isinstance(tree, dict):
        return {k: (leaf_fn(k, v) if not isinstance(v, dict) else _convert(v, leaf_fn))
                for k, v in tree.items()}
    raise TypeError(f"expected a dict of variables, got {type(tree).__name__}")


def _relayout(axes: dict, lanes: bool):
    def leaf(name: str, a) -> np.ndarray:
        a = np.asarray(a)
        rank = a.ndim - int(lanes)
        if name == "kernel" and rank in axes:
            perm = (0,) + tuple(i + 1 for i in axes[rank]) if lanes else axes[rank]
            return np.ascontiguousarray(a.transpose(perm))
        return a.copy()

    return leaf


def flax_to_torch(variables: dict, lanes: bool = False) -> dict:
    """flax variables (numpy leaves) -> the port's layout (numpy leaves).
    ``lanes``: every leaf has a leading stack axis (per-client bottoms and
    heads, per-party towers) that each kernel keeps in front."""
    return _convert(variables, _relayout(_TO_TORCH, lanes))


def torch_to_flax(variables: dict) -> dict:
    """The port's layout (numpy leaves) -> flax variables (numpy leaves)."""
    return _convert(variables, _relayout(_TO_FLAX, False))


def _permute_kernels(axes: dict):
    def leaf(name: str, t: torch.Tensor) -> torch.Tensor:
        if name == "kernel" and t.ndim in axes:
            return t.permute(axes[t.ndim]).contiguous()
        return t

    return leaf


def tensors_to_flax(variables: dict) -> dict:
    """The port's tree of tensors -> flax layouts, on the tensors' own
    device (kernels permuted into fresh contiguous tensors, the other leaves
    as they are)."""
    return _convert(variables, _permute_kernels(_TO_FLAX))


def tensors_from_flax(variables: dict) -> dict:
    """Inverse of :func:`tensors_to_flax`."""
    return _convert(variables, _permute_kernels(_TO_TORCH))


def flatten_reference(tree) -> tuple[torch.Tensor, Callable[[torch.Tensor], dict]]:
    """The port's tree (tensors) -> one f32 vector in the reference's flat
    layout (flax kernels, JAX leaf order) on the tree's device, and the
    inverse ``unravel(vec)`` back to the port's layouts and dtypes."""
    named = list(_named_leaves(tree))
    axes = [(_TO_FLAX.get(t.ndim) if name == "kernel" else None) for name, t in named]
    flax_leaves = [t.permute(a) if a else t for (_, t), a in zip(named, axes)]

    def unravel(vec: torch.Tensor) -> dict:
        out, offset = [], 0
        for leaf, a in zip(flax_leaves, axes):
            part = vec[offset:offset + leaf.numel()].reshape(leaf.shape)
            if a:
                part = part.permute(_TO_TORCH[leaf.ndim])
            out.append(part.to(leaf.dtype).contiguous())
            offset += leaf.numel()
        return tree_unflatten_like(tree, out)

    return torch.cat([t.reshape(-1).to(torch.float32) for t in flax_leaves]), unravel


def to_torch(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32 if tree.is_floating_point() else tree.dtype).numpy()



def tree_from_flax(tree, device="cpu") -> dict:
    """A flax tree whose layouts the port keeps (the transformer's
    ``params``, a LoRA adapter tree ``{path: {"a", "b"}}``; numpy or jax
    leaves) -> f32 tensors on ``device``.  :func:`to_numpy` is the
    inverse."""
    return to_torch(_convert(tree, lambda _, a: np.asarray(a, np.float32)), device)
