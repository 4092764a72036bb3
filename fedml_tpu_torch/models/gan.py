"""The GAN pair that FedGAN trains (the port of ``fedml_tpu/models/gan.py``).

``Generator``: ``z`` through ``Dense(hidden)`` and ``Dense(hidden)`` with
ReLU, then ``Dense(prod(out_shape))`` and tanh, shaped as images in [-1,
1].  ``Discriminator``: the flattened image through ``Dense(hidden)`` and
``Dense(hidden // 2)`` with ``leaky_relu(0.2)``, then ``Dense(1)``: one
logit a sample.  Both follow the port's model interface
(``models/simple.py``): ``init(generator, device)``, ``apply(variables, x,
train) -> (out, {})`` over the flax tree in torch layouts, f32 as the
reference's simulator runs them.  A kernel with a leading lane axis marks
lane-stacked variables (``x`` then ``(L, N, ...)``), each Dense layer one
``torch.bmm``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.pytree import tree_map
from .simple import _dense, _dense_init, leaky_relu, single_lane


@dataclass(frozen=True)
class Generator:
    """``Generator`` (reference L12)."""

    out_shape: tuple = (28, 28, 1)
    z_dim: int = 64
    hidden: int = 256

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": _dense_init(self.z_dim, self.hidden, generator),
                  "Dense_1": _dense_init(self.hidden, self.hidden, generator),
                  "Dense_2": _dense_init(self.hidden, math.prod(self.out_shape), generator)}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, z: torch.Tensor, train: bool = True):
        """``z`` ``(N, z_dim)`` -> ``((N, *out_shape), {})``."""
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, z, train)
        h = torch.relu(_dense(p["Dense_0"], z))
        h = torch.relu(_dense(p["Dense_1"], h))
        x = torch.tanh(_dense(p["Dense_2"], h))
        return x.reshape(x.shape[:2] + tuple(self.out_shape)), {}


@dataclass(frozen=True)
class Discriminator:
    """``Discriminator`` (reference L31); ``in_features`` is the flattened
    image's length."""

    in_features: int = 784
    hidden: int = 256

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": _dense_init(self.in_features, self.hidden, generator),
                  "Dense_1": _dense_init(self.hidden, self.hidden // 2, generator),
                  "Dense_2": _dense_init(self.hidden // 2, 1, generator)}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        """Images ``(N, ...)`` -> ``((N,) logits, {})``."""
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, x, train)
        h = x.reshape(x.shape[0], x.shape[1], -1)
        h = leaky_relu(_dense(p["Dense_0"], h))
        h = leaky_relu(_dense(p["Dense_1"], h))
        return _dense(p["Dense_2"], h)[..., 0], {}
