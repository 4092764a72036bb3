"""CIFAR ResNets (resnet20/32/44/56) as plain functions over a variable dict.

The port of ``fedml_tpu/models/resnet.py``.  A model is a small frozen
description with ``init(generator, device)`` and ``apply(variables, x,
train)``; its variables are the flax tree with torch layouts::

    {"params": {"Conv_0": {"kernel": (O, I, H, W)}, "BatchNorm_0": {"scale", "bias"},
                "BasicBlock_k": {"Conv_0", "BatchNorm_0", "Conv_1", "BatchNorm_1"},
                "Dense_0": {"kernel": (out, in), "bias"}},
     "batch_stats": {"BatchNorm_0": {"mean", "var"}, "BasicBlock_k": {...}}}

so FedAvg averages the same leaves as the reference and ``weights.py``
converts leaf by leaf.  Activations are NHWC at every public function, as in
the JAX package; a conv runs on the channels_last NCHW view.

Semantics kept from flax:
- ``padding="SAME"``: with stride 2 flax pads (0, 1) per spatial dim, so
  asymmetric padding is applied explicitly before the conv;
- option-A shortcut: ``[:, ::s, ::s, :]`` then zero channels
  ``(pad // 2, pad - pad // 2)``;
- BatchNorm: fast variance ``max(0, E[x^2] - E[x]^2)`` in f32, running stats
  with momentum 0.9 and the biased variance, eps 1e-5, no
  ``num_batches_tracked``;
- ``dtype=bfloat16``: the input and each Conv/Dense kernel are cast to bf16,
  parameters stay f32, the BN math runs in f32;
- init: ``lecun_normal`` (truncated normal in +-2 std, fan-in scaled) for
  Conv/Dense kernels, zero Dense bias, BN scale 1 / bias 0 / mean 0 / var 1.

``fused=True`` (recipe flag ``extra.fused_blocks``) routes the stem
epilogue and both epilogues of every block through ``ops/fused_block.py``;
the variable tree is identical to the unfused model's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.pytree import tree_map
from ..ops.fused_block import fused_bn_relu, fused_bn_residual_relu

_MOMENTUM = 0.9
_EPS = 1e-5


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, kernel: torch.Tensor, stride: int, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False, dtype=dtype)`` on NHWC
    ``x`` with an OIHW ``kernel``; returns a contiguous NHWC tensor."""
    w = kernel.to(dtype).contiguous(memory_format=torch.channels_last)
    (ph0, ph1), (pw0, pw1) = (_same_pads(x.shape[1], w.shape[2], stride),
                              _same_pads(x.shape[2], w.shape[3], stride))
    x = x.to(dtype)
    if ph0 == ph1 and pw0 == pw1:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=(ph0, pw0))
    else:
        x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _batch_stats(x: torch.Tensor, stats: dict, train: bool):
    """(mean, var, new_stats) of flax BatchNorm with fast variance."""
    if not train:
        return stats["mean"], stats["var"], stats
    xf = x.to(torch.float32)
    axes = tuple(range(x.ndim - 1))
    mean = xf.mean(axes)
    var = torch.clamp_min(xf.square().mean(axes) - mean.square(), 0.0)
    new = {
        "mean": _MOMENTUM * stats["mean"] + (1.0 - _MOMENTUM) * mean.detach(),
        "var": _MOMENTUM * stats["var"] + (1.0 - _MOMENTUM) * var.detach(),
    }
    return mean, var, new


def batch_norm(x, params: dict, stats: dict, train: bool):
    """``_norm_layer``'s flax ``nn.BatchNorm`` (reference L52), unfused:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, cast back to
    ``x``'s dtype."""
    mean, var, new = _batch_stats(x, stats, train)
    mul = torch.rsqrt(var + _EPS) * params["scale"]
    y = (x.to(torch.float32) - mean) * mul + params["bias"]
    return y.to(x.dtype), new


def bn_scale_shift(x, params: dict, stats: dict, train: bool):
    """``_FusedBNScaleShift`` (reference L58): the BN affine folded to per-channel
    ``(scale, shift)`` with ``normalized = x * scale + shift``; gradients of
    the fused kernel's d_scale / d_shift flow back through mean/var into
    ``x`` by ordinary autograd."""
    mean, var, new = _batch_stats(x, stats, train)
    scale = params["scale"] * torch.rsqrt(var + _EPS)
    return scale, params["bias"] - mean * scale, new


def option_a_shortcut(residual: torch.Tensor, stride: int, filters: int) -> torch.Tensor:
    residual = residual[:, ::stride, ::stride, :]
    pad = filters - residual.shape[-1]
    return F.pad(residual, (pad // 2, pad - pad // 2)).contiguous()


def basic_block(p: dict, st: dict, x, stride: int, filters: int, train: bool, dtype):
    """``BasicBlock`` (reference L29): conv-BN-ReLU-conv-BN, option-A
    shortcut, ReLU.  Returns ``(out, new_batch_stats)``."""
    residual = x
    y = conv2d_nhwc(x, p["Conv_0"]["kernel"], stride, dtype)
    y, s0 = batch_norm(y, p["BatchNorm_0"], st["BatchNorm_0"], train)
    y = torch.relu(y)
    y = conv2d_nhwc(y, p["Conv_1"]["kernel"], 1, dtype)
    y, s1 = batch_norm(y, p["BatchNorm_1"], st["BatchNorm_1"], train)
    if residual.shape != y.shape:
        residual = option_a_shortcut(residual, stride, filters)
    return torch.relu(y + residual), {"BatchNorm_0": s0, "BatchNorm_1": s1}


def fused_basic_block(p: dict, st: dict, x, stride: int, filters: int, train: bool, dtype):
    """``FusedBasicBlock`` (reference L105): both epilogues through the fused
    kernels; same variables as :func:`basic_block`."""
    residual = x
    y = conv2d_nhwc(x, p["Conv_0"]["kernel"], stride, dtype)
    sc, sh, s0 = bn_scale_shift(y, p["BatchNorm_0"], st["BatchNorm_0"], train)
    y = fused_bn_relu(y, sc, sh)
    y = conv2d_nhwc(y, p["Conv_1"]["kernel"], 1, dtype)
    sc, sh, s1 = bn_scale_shift(y, p["BatchNorm_1"], st["BatchNorm_1"], train)
    if residual.shape != y.shape:
        residual = option_a_shortcut(residual, stride, filters)
    return fused_bn_residual_relu(y, sc, sh, residual), {"BatchNorm_0": s0, "BatchNorm_1": s1}


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    # flax variance_scaling(1.0, "fan_in", "truncated_normal"): a standard
    # normal truncated to [-2, 2], scaled by sqrt(1/fan_in) / .8796...
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                generator=generator)
    return t


def _bn_init(c: int):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


@dataclass(frozen=True)
class CifarResNet:
    """``CifarResNet`` (reference L132): 3-stage CIFAR ResNet, depth 6n+2,
    widths 16/32/64."""

    num_blocks: int  # n per stage
    num_classes: int = 10
    dtype: torch.dtype = torch.float32
    fused: bool = False

    def _blocks(self):
        in_ch = 16
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(self.num_blocks):
                yield filters, (2 if (stage > 0 and block == 0) else 1), in_ch
                in_ch = filters

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        """Fresh variables drawn on the CPU from ``generator``, then moved
        to ``device`` (the same draw on every device)."""
        params, stats = {}, {}
        params["Conv_0"] = {"kernel": _lecun_normal((16, 3, 3, 3), 27, generator)}
        params["BatchNorm_0"], stats["BatchNorm_0"] = _bn_init(16)
        for idx, (filters, _, in_ch) in enumerate(self._blocks()):
            p, s = {}, {}
            p["Conv_0"] = {"kernel": _lecun_normal((filters, in_ch, 3, 3), 9 * in_ch, generator)}
            p["BatchNorm_0"], s["BatchNorm_0"] = _bn_init(filters)
            p["Conv_1"] = {"kernel": _lecun_normal((filters, filters, 3, 3), 9 * filters, generator)}
            p["BatchNorm_1"], s["BatchNorm_1"] = _bn_init(filters)
            params[f"BasicBlock_{idx}"], stats[f"BasicBlock_{idx}"] = p, s
        params["Dense_0"] = {"kernel": _lecun_normal((self.num_classes, 64), 64, generator),
                             "bias": torch.zeros(self.num_classes)}
        return tree_map(lambda t: t.to(device), {"params": params, "batch_stats": stats})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        """NHWC ``x`` -> ``(logits, new_batch_stats)``; logits in ``dtype``.
        In eval mode the batch stats come back unchanged."""
        p, st = variables["params"], variables["batch_stats"]
        new_stats = {}
        x = conv2d_nhwc(x.to(self.dtype), p["Conv_0"]["kernel"], 1, self.dtype)
        if self.fused:
            sc, sh, new_stats["BatchNorm_0"] = bn_scale_shift(x, p["BatchNorm_0"], st["BatchNorm_0"], train)
            x = fused_bn_relu(x, sc, sh)
        else:
            x, new_stats["BatchNorm_0"] = batch_norm(x, p["BatchNorm_0"], st["BatchNorm_0"], train)
            x = torch.relu(x)
        block_fn = fused_basic_block if self.fused else basic_block
        for idx, (filters, stride, _) in enumerate(self._blocks()):
            name = f"BasicBlock_{idx}"
            x, new_stats[name] = block_fn(p[name], st[name], x, stride, filters, train, self.dtype)
        x = x.mean(dim=(1, 2))
        dense = p["Dense_0"]
        logits = F.linear(x, dense["kernel"].to(self.dtype)) + dense["bias"].to(self.dtype)
        return logits, new_stats


def resnet20(num_classes: int = 10, dtype=torch.float32, fused: bool = False) -> CifarResNet:
    return CifarResNet(num_blocks=3, num_classes=num_classes, dtype=dtype, fused=fused)


def resnet32(num_classes: int = 10, dtype=torch.float32, fused: bool = False) -> CifarResNet:
    return CifarResNet(num_blocks=5, num_classes=num_classes, dtype=dtype, fused=fused)


def resnet44(num_classes: int = 10, dtype=torch.float32, fused: bool = False) -> CifarResNet:
    return CifarResNet(num_blocks=7, num_classes=num_classes, dtype=dtype, fused=fused)


def resnet56(num_classes: int = 10, dtype=torch.float32, fused: bool = False) -> CifarResNet:
    return CifarResNet(num_blocks=9, num_classes=num_classes, dtype=dtype, fused=fused)
