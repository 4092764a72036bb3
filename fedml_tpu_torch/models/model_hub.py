"""Model factory (the port of ``fedml_tpu/models/model_hub.py``) for the
CIFAR ResNet family; other models belong to later slices."""

from __future__ import annotations

import torch

from ..arguments import Config
from ..core.flags import cfg_extra
from . import resnet

_RESNETS = {
    "resnet20": resnet.resnet20,
    "resnet32": resnet.resnet32,
    "resnet44": resnet.resnet44,
    "resnet56": resnet.resnet56,
}


def create(cfg: Config, output_dim: int) -> resnet.CifarResNet:
    name = cfg.model.lower()
    if name not in _RESNETS:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet: the first port slice builds "
            f"only {sorted(_RESNETS)}")
    if getattr(cfg, "norm", "batch") != "batch":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported yet: the first port slice builds "
            "BatchNorm ResNets only")
    # compute dtype threads into the conv/dense path (params stay f32)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return _RESNETS[name](output_dim, dtype, fused=bool(cfg_extra(cfg, "fused_blocks")))
