"""Model factory (the port of ``fedml_tpu/models/model_hub.py``): the CIFAR
ResNet family and the logistic regression; other models belong to later
slices."""

from __future__ import annotations

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


def create(cfg: Config, output_dim: int, in_features: int = 0):
    """The model ``cfg.model`` names; ``in_features`` (the flattened sample
    size) sizes the logistic regression, whose flax ``Dense`` infers it from
    its first input."""
    name = cfg.model.lower()
    if name in ("lr", "logistic_regression"):
        return simple.LogisticRegression(num_classes=output_dim, in_features=in_features)
    if name not in _RESNETS:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet: the first port slice built "
            f"{sorted(_RESNETS)}, a later one 'lr'")
    if getattr(cfg, "norm", "batch") != "batch":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported yet: the first port slice builds "
            "BatchNorm ResNets only")
    # compute dtype threads into the conv/dense path (params stay f32)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return _RESNETS[name](output_dim, dtype, fused=bool(cfg_extra(cfg, "fused_blocks")))
