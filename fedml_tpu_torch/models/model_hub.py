"""Model factory (the port of ``fedml_tpu/models/model_hub.py``): the CIFAR
ResNet family, the logistic regression, the FedAvg and CIFAR CNNs and the
MLP; other models belong to later slices."""

from __future__ import annotations

import math

import torch

from ..arguments import Config
from ..core.flags import cfg_extra
from . import resnet, simple

_RESNETS = {
    "resnet20": resnet.resnet20,
    "resnet32": resnet.resnet32,
    "resnet44": resnet.resnet44,
    "resnet56": resnet.resnet56,
}
_PORTED = sorted(_RESNETS) + ["lr", "cnn", "cnn_dropout", "simple-cnn", "cifar_cnn",
                              "cnn_web", "mlp"]


def create(cfg: Config, output_dim: int, in_features: int = 0, input_shape: tuple = ()):
    """The model ``cfg.model`` names.  One sample's shape sizes the first
    dense layer, which flax infers from its first input: ``input_shape``
    (the CNNs need it), or ``in_features`` (its flattened size) for the
    regression and the MLP."""
    name = cfg.model.lower()
    in_features = in_features or math.prod(input_shape)
    if name in ("lr", "logistic_regression"):
        return simple.LogisticRegression(num_classes=output_dim, in_features=in_features)
    if name in ("cnn", "cnn_dropout"):
        only_digits = cfg.dataset in ("mnist", "fashionmnist")
        return simple.FedAvgCNN(num_classes=output_dim, only_digits=only_digits,
                                input_shape=tuple(input_shape))
    if name in ("simple-cnn", "cifar_cnn", "cnn_web"):
        return simple.CifarCNN(num_classes=output_dim, input_shape=tuple(input_shape))
    if name == "mlp":
        # extra.mlp_hidden widens the hidden layer; the default is upstream's
        return simple.MLP(hidden=int(cfg_extra(cfg, "mlp_hidden")), num_classes=output_dim,
                          in_features=in_features)
    if name not in _RESNETS:
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet: the first port "
                                  f"slice built the ResNets, later ones the rest of {_PORTED}")
    if getattr(cfg, "norm", "batch") != "batch":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported yet: the first port slice builds "
            "BatchNorm ResNets only")
    # compute dtype threads into the conv/dense path (params stay f32)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return _RESNETS[name](output_dim, dtype, fused=bool(cfg_extra(cfg, "fused_blocks")))
