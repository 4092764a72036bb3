"""Small models (the port of ``fedml_tpu/models/simple.py``): the logistic
regression of the ``lr`` recipes, the FedAvg CNN (``cnn``), the CIFAR CNN
(``simple-cnn``), the MLP (``mlp``) and the hub's MNIST GAN pair
(``MnistGanGenerator`` / ``MnistGanDiscriminator``, which no simulator of
the reference trains).

A model here follows the port's model interface (``models/resnet.py``): a
frozen description with ``init(generator, device)`` and ``apply(variables,
x, train) -> (logits, new_batch_stats)`` over the flax variable tree in
torch layouts, ``{"params": {"Dense_0": {"kernel": (out, in), "bias":
(out,)}, "Conv_0": {"kernel": (O, I, H, W), "bias": (O,)}}}``.

Semantics kept from flax:
- the reference's ``Dense`` and ``Conv`` have no ``dtype``, so they compute
  in the promoted dtype of their input and their f32 parameters, which is
  f32 (a bf16 input, as local training casts it, is widened);
- a Dense layer's product comes first and the bias is added after it;
- ``Conv(padding="SAME")`` with a bias, on NHWC activations; ``max_pool``
  2x2 with stride 2 and no padding; an image flattens in ``(H, W, C)``
  order, so ``Dense_0``'s rows are the reference's;
- ``Dropout(0.5)`` keeps an element where its mask is set and scales it by
  ``1 / keep_prob``, as flax's ``select(mask, x / keep_prob, 0)``;
- init is ``lecun_normal`` for every kernel and zeros for every bias.
The products are plain ``torch.bmm`` and ``F.conv2d``: the reference
computes them outside any Pallas kernel.

Dropout (``FedAvgCNN``): the model draws nothing of its own.  Training
passes its keep-mask as ``apply(..., dropout=mask)``, a bool ``(N, 512)``,
or ``(L, N, 512)`` for lanes; :meth:`FedAvgCNN.dropout_shape` tells local
training the shape to draw (``fl/local_sgd.py``), and a model without it
has no dropout.

Lanes (the simulator's MESH round): a kernel with a leading lane axis,
``(L, out, in)`` or ``(L, O, I, H, W)``, marks lane-stacked variables, and
``x`` is then ``(L, N, ...)``.  The lane form is decided from the
parameters, not from ``x``: the input is flattened, so a lane batch of
images and a single batch of higher rank look alike.  A conv of the lanes
is one grouped conv (``models/resnet.conv2d_lanes``), a Dense layer one
``torch.bmm``.  One model alone is the lane form with one lane, so every
lane computes what it computes alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.pytree import tree_map
from .resnet import _lecun_normal, conv2d_lanes


def _dense_init(in_features: int, out_features: int, generator: torch.Generator) -> dict:
    return {"kernel": _lecun_normal((out_features, in_features), in_features, generator),
            "bias": torch.zeros(out_features)}


def _conv_init(in_ch: int, out_ch: int, k: int, generator: torch.Generator) -> dict:
    return {"kernel": _lecun_normal((out_ch, in_ch, k, k), in_ch * k * k, generator),
            "bias": torch.zeros(out_ch)}


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense`` of the lanes: ``(L, N, in)`` -> f32 ``(L, N, out)``."""
    kernel = p["kernel"]
    return torch.bmm(x.to(kernel.dtype), kernel.transpose(1, 2)) + p["bias"][:, None, :]


def conv_bias_lanes(p: dict, x: torch.Tensor) -> torch.Tensor:
    """flax ``Conv(padding="SAME")`` with its bias, of the lanes: lane-major
    NHWC ``(L, N, H, W, C)`` in the kernel's dtype."""
    kernel = p["kernel"]
    return conv2d_lanes(x, kernel, 1, kernel.dtype) + p["bias"][:, None, None, None, :]


def max_pool_lanes(y: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool((2, 2), strides=(2, 2))`` of lane-major NHWC ``y``
    (no padding: an odd edge is dropped)."""
    lanes, n, h, w, c = y.shape
    y = F.max_pool2d(y.reshape(lanes * n, h, w, c).permute(0, 3, 1, 2), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 1).reshape(lanes, n, h // 2, w // 2, c)


def _conv_relu_pool(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``max_pool(relu(Conv(x)))`` of the lanes: lane-major NHWC ``(L, N, H,
    W, C)`` in, ``(L, N, H // 2, W // 2, O)`` out, in f32."""
    return max_pool_lanes(torch.relu(conv_bias_lanes(p, x)))


def single_lane(model, variables: dict, x: torch.Tensor, train: bool, **kw):
    """One model as the lane form with one lane: ``(logits, new stats)``
    of the lane (``kw``: per-lane inputs such as a dropout mask)."""
    lane_vars = tree_map(lambda t: t[None], variables)
    extra = {k: (None if v is None else v[None]) for k, v in kw.items()}
    logits, stats = model.apply(lane_vars, x[None], train, **extra)
    return logits[0], tree_map(lambda t: t[0], stats)


@dataclass(frozen=True)
class LogisticRegression:
    """``LogisticRegression`` (reference L16): one Dense layer over the
    flattened input."""

    num_classes: int = 10
    in_features: int = 60

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        dense = _dense_init(self.in_features, self.num_classes, generator)
        return {"params": {"Dense_0": {k: v.to(device) for k, v in dense.items()}}}

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        """``x`` -> ``(logits, {})``: f32 ``(N, classes)``, or ``(L, N,
        classes)`` for lane-stacked variables."""
        if variables["params"]["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, x, train)
        return _dense(variables["params"]["Dense_0"], x.reshape(x.shape[0], x.shape[1], -1)), {}


@dataclass(frozen=True)
class MLP:
    """``MLP`` (reference L69): ``Dense(hidden)``, ReLU, ``Dense(classes)``
    over the flattened input."""

    hidden: int = 128
    num_classes: int = 10
    in_features: int = 60

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": _dense_init(self.in_features, self.hidden, generator),
                  "Dense_1": _dense_init(self.hidden, self.num_classes, generator)}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, x, train)
        h = torch.relu(_dense(p["Dense_0"], x.reshape(x.shape[0], x.shape[1], -1)))
        return _dense(p["Dense_1"], h), {}


def _image_lanes(x: torch.Tensor) -> torch.Tensor:
    """Lane-major images with their channel axis: ``(L, N, H, W)`` gains
    one (the reference's ``x[..., None]`` of a 3-D batch)."""
    return x[..., None] if x.ndim == 4 else x


@dataclass(frozen=True)
class FedAvgCNN:
    """``FedAvgCNN`` (reference L25), the FedAvg paper's CNN: two 5x5 convs
    (32, 64) each with ReLU and a 2x2 max-pool, ``Dense(512)``, ReLU,
    ``Dropout(0.5)``, ``Dense(10 if only_digits else num_classes)``.
    ``input_shape`` is one sample's ``(H, W, C)`` (or ``(H, W)``), which
    sizes ``Dense_0``."""

    num_classes: int = 62
    only_digits: bool = False
    input_shape: tuple = (28, 28, 1)
    keep_prob: float = 0.5

    @property
    def n_out(self) -> int:
        return 10 if self.only_digits else self.num_classes

    def dropout_shape(self, batch: int) -> tuple:
        """The shape of one step's keep-mask for a batch of ``batch``."""
        return (batch, 512)

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        h, w = self.input_shape[:2]
        c = self.input_shape[2] if len(self.input_shape) > 2 else 1
        params = {"Conv_0": _conv_init(c, 32, 5, generator),
                  "Conv_1": _conv_init(32, 64, 5, generator),
                  "Dense_0": _dense_init((h // 4) * (w // 4) * 64, 512, generator),
                  "Dense_1": _dense_init(512, self.n_out, generator)}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True,
              dropout: Optional[torch.Tensor] = None):
        """NHWC ``x`` -> ``(logits, {})``.  In train mode ``dropout`` is the
        step's keep-mask (module docstring); the model draws none."""
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, x, train, dropout=dropout)
        y = _image_lanes(x)
        y = _conv_relu_pool(p["Conv_1"], _conv_relu_pool(p["Conv_0"], y))
        h = torch.relu(_dense(p["Dense_0"], y.reshape(y.shape[0], y.shape[1], -1)))
        if train:
            if dropout is None:
                raise ValueError("FedAvgCNN draws no dropout of its own: pass the step's "
                                 "keep-mask as apply(..., dropout=mask)")
            h = torch.where(dropout, h / self.keep_prob, torch.zeros_like(h))
        return _dense(p["Dense_1"], h), {}


@dataclass(frozen=True)
class CifarCNN:
    """``CifarCNN`` (reference L50): two 3x3 convs (32, 64) each with ReLU
    and a 2x2 max-pool, ``Dense(128)``, ReLU, ``Dense(classes)``."""

    num_classes: int = 10
    input_shape: tuple = (32, 32, 3)

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        h, w, c = self.input_shape
        params = {"Conv_0": _conv_init(c, 32, 3, generator),
                  "Conv_1": _conv_init(32, 64, 3, generator),
                  "Dense_0": _dense_init((h // 4) * (w // 4) * 64, 128, generator),
                  "Dense_1": _dense_init(128, self.num_classes, generator)}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, x, train)
        y = _conv_relu_pool(p["Conv_1"], _conv_relu_pool(p["Conv_0"], x))
        h = torch.relu(_dense(p["Dense_0"], y.reshape(y.shape[0], y.shape[1], -1)))
        return _dense(p["Dense_1"], h), {}


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """flax ``leaky_relu``: ``where(x >= 0, x, slope * x)``."""
    return torch.where(x >= 0, x, slope * x)


def _dense_stack(p: dict, x: torch.Tensor, names, act) -> torch.Tensor:
    """``Dense`` layers ``names`` of the lanes in turn, ``act`` after every
    one but the last."""
    for i, name in enumerate(names):
        x = _dense(p[name], x)
        if i < len(names) - 1:
            x = act(x)
    return x


@dataclass(frozen=True)
class MnistGanGenerator:
    """``MnistGanGenerator`` (reference L83): ``Dense(256)``, ``Dense(512)``
    with ``leaky_relu(0.2)``, ``Dense(784)``, tanh, as ``(N, 28, 28, 1)``
    images."""

    latent_dim: int = 100

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": _dense_init(self.latent_dim, 256, generator),
                  "Dense_1": _dense_init(256, 512, generator),
                  "Dense_2": _dense_init(512, 784, generator)}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, z: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, z, train)
        x = _dense_stack(p, z, ("Dense_0", "Dense_1", "Dense_2"), leaky_relu)
        return torch.tanh(x).reshape(x.shape[:2] + (28, 28, 1)), {}


@dataclass(frozen=True)
class MnistGanDiscriminator:
    """``MnistGanDiscriminator`` (reference L98): the flattened image
    through ``Dense(512)``, ``Dense(256)`` with ``leaky_relu(0.2)``, then
    ``Dense(1)``: ``(N, 1)`` logits."""

    in_features: int = 784

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": _dense_init(self.in_features, 512, generator),
                  "Dense_1": _dense_init(512, 256, generator),
                  "Dense_2": _dense_init(256, 1, generator)}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return single_lane(self, variables, x, train)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        return _dense_stack(p, x, ("Dense_0", "Dense_1", "Dense_2"), leaky_relu), {}
