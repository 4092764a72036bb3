"""The DARTS supernet that FedNAS searches (the port of
``fedml_tpu/models/darts.py``).

A cell is two mixed edges in a row; an edge (``MixedOp``) is the
``softmax(alpha)``-weighted sum of four candidate ops over its input:
``conv3`` (3x3 conv + bias, ReLU), ``conv5`` (5x5, ReLU), ``skip`` (the
input, or a 1x1 conv when the widths differ) and ``zero``.  The zero op's
weight stays in the softmax; its term is zero and is left out of the sum.
The supernet: a 3x3 stem conv with ReLU, ``n_cells`` cells with a 2x2
max-pool between two, the spatial mean and ``Dense(num_classes)``.  The
architecture ``alphas`` ``(n_cells, 2, 4)`` live in ``params`` beside the
weights (``split_arch_params`` separates them), so FedNAS aggregates the
two with its own rules.

The port's model interface (``models/simple.py``): ``init(generator,
device)``, ``apply(variables, x, train) -> (logits, {})`` over the flax
tree in torch layouts (``Conv_0``, ``cell{c}_op{e}`` with ``Conv_k``,
``Dense_0``, ``alphas``).  ``alphas`` of rank 4 mark lane-stacked variables
and ``x`` is then ``(L, N, H, W, C)``: each conv one grouped conv over the
lanes (``models/resnet.conv2d_lanes``), each lane its own softmax.  The
products are plain ``F.conv2d`` / ``torch.bmm``: the reference computes them
outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.pytree import tree_map
from .simple import _conv_init, _dense, _dense_init, conv_bias_lanes, max_pool_lanes, single_lane

OPS = ("conv3", "conv5", "skip", "zero")


def mixed_op(p: dict, x: torch.Tensor, alpha: torch.Tensor, features: int) -> torch.Tensor:
    """``MixedOp`` (reference L29) of the lanes: ``x`` ``(L, N, H, W, C)``,
    ``alpha`` ``(L, 4)`` this edge's logits."""
    w = torch.softmax(alpha, -1)[:, :, None, None, None, None]
    c3 = torch.relu(conv_bias_lanes(p["Conv_0"], x))
    c5 = torch.relu(conv_bias_lanes(p["Conv_1"], x))
    skip = x if x.shape[-1] == features else conv_bias_lanes(p["Conv_2"], x)
    return w[:, 0] * c3 + w[:, 1] * c5 + w[:, 2] * skip


def _mixed_op_init(in_ch: int, features: int, generator: torch.Generator) -> dict:
    p = {"Conv_0": _conv_init(in_ch, features, 3, generator),
         "Conv_1": _conv_init(in_ch, features, 5, generator)}
    if in_ch != features:
        p["Conv_2"] = _conv_init(in_ch, features, 1, generator)
    return p


@dataclass(frozen=True)
class DARTSSuperNet:
    """``DARTSSuperNet`` (reference L44); ``in_channels`` is the images'
    channel count."""

    num_classes: int
    n_cells: int = 2
    features: int = 16
    in_channels: int = 3

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"alphas": torch.zeros((self.n_cells, 2, len(OPS))),
                  "Conv_0": _conv_init(self.in_channels, self.features, 3, generator)}
        for c in range(self.n_cells):
            for e in range(2):
                params[f"cell{c}_op{e}"] = _mixed_op_init(self.features, self.features, generator)
        params["Dense_0"] = _dense_init(self.features, self.num_classes, generator)
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["alphas"].ndim == 3:
            return single_lane(self, variables, x, train)
        alphas = p["alphas"]
        x = torch.relu(conv_bias_lanes(p["Conv_0"], x.to(torch.float32)))
        for c in range(self.n_cells):
            x = mixed_op(p[f"cell{c}_op0"], x, alphas[:, c, 0], self.features)
            x = mixed_op(p[f"cell{c}_op1"], x, alphas[:, c, 1], self.features)
            if c < self.n_cells - 1:
                x = max_pool_lanes(x)
        return _dense(p["Dense_0"], x.mean(dim=(-3, -2))), {}


def split_arch_params(params: dict):
    """``(weights, alphas)`` of the supernet's ``params`` (reference L70):
    FedNAS aggregates them by separate rules."""
    return {k: v for k, v in params.items() if k != "alphas"}, params["alphas"]


def derive_genotype(alphas) -> list[list[str]]:
    """The argmax op of each edge, the zero op excluded (reference L77);
    ties go to the first op, as ``jnp.argmax``."""
    a = alphas.detach().cpu().numpy() if torch.is_tensor(alphas) else np.asarray(alphas)
    picks = np.argmax(a[..., : len(OPS) - 1], axis=-1)
    return [[OPS[int(op)] for op in cell] for cell in picks]
