"""LoRA as a pure parameter transform (the port of
``fedml_tpu/llm/lora.py``).

Adapters are a flat dict ``{"layer_0/attn/wq/kernel": {"a": (d_in, r),
"b": (r, d_out)}}`` keyed by the flax path of the leaf they adapt, in the
reference's traversal order (sorted keys), with ``d_in = shape[0]`` and
``d_out = prod(shape[1:])``: for ``wo`` ``(heads, head_dim, d_model)`` that
is ``a: (heads, r)``, ``b: (r, head_dim * d_model)``, the reference's own
factorization.  ::

    merged = base + (alpha / r) * reshape(a @ b)

is differentiable in the adapters only, so autograd of
``loss(merge(base, lora))`` trains the adapters with the base frozen.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch

from ..core import rng

DEFAULT_TARGETS = r".*attn/w[qkvo]/kernel"


def _paths(tree: dict, prefix: str = ""):
    """``(path, leaf)`` pairs in sorted-key order, paths joined by ``/``."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], path)
        else:
            yield path, tree[k]


def _match_paths(params: dict, targets: str):
    return [(p, leaf) for p, leaf in _paths(params)
            if re.fullmatch(targets, p) and leaf.ndim >= 2]


def init_lora(params: dict, rank: int, key: rng.Key, targets: str = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32) -> dict:
    """Adapters for every leaf of ``params`` whose path matches ``targets``:
    ``a`` normal with variance ``1 / d_in`` from ``fold_in(key, 2 i)`` on
    the leaf's device, ``b`` zero (the merge starts as the identity)."""
    lora = {}
    for i, (path, leaf) in enumerate(_match_paths(params, targets)):
        d_in, d_out = leaf.shape[0], math.prod(leaf.shape[1:])
        g = rng.generator(rng.fold_in(key, 2 * i), leaf.device)
        a = torch.randn((d_in, rank), generator=g, device=leaf.device, dtype=dtype)
        lora[path] = {"a": a * (1.0 / max(1, d_in)) ** 0.5,
                      "b": torch.zeros((rank, d_out), dtype=dtype, device=leaf.device)}
    if not lora:
        raise ValueError(f"no parameters matched LoRA targets {targets!r}")
    return lora


def merge(base_params: dict, lora: dict, alpha: float = 16.0,
          rank: Optional[int] = None) -> dict:
    """``base + (alpha / r) * (a @ b).reshape(shape)`` cast to the leaf's
    dtype, on every adapted leaf; the other leaves as they are."""
    if rank is None:
        rank = next(iter(lora.values()))["a"].shape[1]
    scale = alpha / rank

    def update(tree: dict, prefix: str) -> dict:
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = update(v, path)
            elif path in lora:
                ab = lora[path]
                out[k] = v + ((ab["a"] @ ab["b"]).reshape(v.shape) * scale).to(v.dtype)
            else:
                out[k] = v
        return out

    return update(base_params, "")


def lora_size(lora: dict) -> int:
    return sum(ab[k].numel() for ab in lora.values() for k in ab)
