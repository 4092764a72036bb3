"""Model factory (the port of ``fedml_tpu/models/model_hub.py``): every
model of the reference's hub, keyed by ``cfg.model`` and ``cfg.dataset``.
Unknown names raise ``ValueError``, as in the reference."""

from __future__ import annotations

import math

import torch

from ..arguments import Config
from ..core.flags import cfg_extra
from . import cnn_zoo, resnet, rnn, simple

_RESNETS = {
    "resnet20": resnet.resnet20,
    "resnet32": resnet.resnet32,
    "resnet44": resnet.resnet44,
    "resnet56": resnet.resnet56,
}


def create(cfg: Config, output_dim: int, in_features: int = 0, input_shape: tuple = ()):
    """The model ``cfg.model`` names.  One sample's shape sizes the first
    dense layer, which flax infers from its first input: ``input_shape``
    (the CNNs need it), or ``in_features`` (its flattened size) for the
    regression and the MLP."""
    name = cfg.model.lower()
    norm = getattr(cfg, "norm", "batch")
    # compute dtype threads into the conv/dense path (params stay f32)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
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
    if name in _RESNETS:
        # extra.fused_blocks routes the epilogues through the fused kernels;
        # the GroupNorm variant ignores it, as the reference does
        return _RESNETS[name](output_dim, dtype, fused=bool(cfg_extra(cfg, "fused_blocks")),
                              norm=norm)
    if name in ("resnet18_gn", "resnet_gn"):
        # the BN-free variant (reference model/cv/resnet_gn.py)
        return resnet.resnet20(output_dim, dtype, norm="group")
    if name in ("rnn", "char_lstm", "rnn_originalfedavg"):
        return rnn.CharLSTM(vocab_size=output_dim)
    if name in ("rnn_stackoverflow", "word_lstm"):
        return rnn.WordLSTM(vocab_size=output_dim)
    # the zoo: small_input picks the CIFAR stride-1 stem for small images,
    # from the dataset's spec shape (reference L59-65)
    from ..data.loader import dataset_spec

    spec = dataset_spec(cfg.dataset)
    small = spec is not None and len(spec[0]) == 3 and spec[0][0] <= 36
    zoo = dict(num_classes=output_dim, norm=norm, dtype=dtype,
               in_channels=input_shape[-1] if len(input_shape) == 3 else 3)
    if name == "mobilenet":
        return cnn_zoo.MobileNetV1(**zoo, small_input=small)
    if name in ("mobilenet_v3", "mobilenetv3"):
        return cnn_zoo.MobileNetV3Small(**zoo, small_input=small)
    if name in ("efficientnet", "efficientnet_b0"):
        return cnn_zoo.EfficientNetB0(**zoo, small_input=small)
    if name in ("vgg11", "vgg"):
        return cnn_zoo.VGG(**zoo, depth=11)
    if name == "vgg16":
        return cnn_zoo.VGG(**zoo, depth=16)
    raise ValueError(f"unknown model {cfg.model!r} (dataset {cfg.dataset!r})")
