"""The UNet that FedSeg trains, and its metrics (the port of
``fedml_tpu/models/segmentation.py``).

``UNet``: two levels down (``_ConvBlock``: twice a 3x3 conv without bias,
``GroupNorm(4)`` and ReLU; then a 2x2 max-pool), a middle block, two levels
up (a 2x2 ``ConvTranspose`` with stride 2 and its bias, the skip
connection concatenated after it in the channels, a block), then a 1x1
conv with bias to per-pixel logits ``(N, H, W, classes)``.

flax's ``ConvTranspose`` does not flip its kernel (``transpose_kernel=
False``): with ``SAME`` padding and kernel 2, stride 2, each axis gives
``out[2m] = x[m] k[1]`` and ``out[2m + 1] = x[m] k[0]``.
``F.conv_transpose2d``, the adjoint of a conv, gives ``out[2m + t] = x[m]
w[t]``; so :func:`conv_transpose_lanes` flips both spatial axes of the
kernel and swaps its in and out axes.  The stored kernel keeps the generic
relayout of every conv kernel (flax HWIO -> ``(O, I, kh, kw)``,
``weights.py``).

The port's model interface (``models/simple.py``), f32; a conv kernel of
rank 5 marks lane-stacked variables (``x`` then ``(L, N, H, W, C)``), each
conv one grouped conv over the lanes.

:func:`segmentation_metrics`: pixel accuracy, mIoU over the classes present
in the labels, and frequency-weighted IoU, from an f32 confusion matrix
built by scatter-add (counts exact below 2**24 pixels).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.pytree import tree_map
from .resnet import GN_EPS, _lecun_normal, conv2d_lanes, group_norm
from .simple import conv_bias_lanes, max_pool_lanes, single_lane

SEG_GN_GROUPS = 4  # _ConvBlock's GroupNorm(num_groups=4) (reference L19)


def conv_transpose_lanes(p: dict, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """flax ``ConvTranspose(O, (k, k), strides=(k, k), padding="SAME")``
    with its bias, of the lanes: lane-major NHWC ``(L, N, H, W, I)`` ->
    ``(L, N, k H, k W, O)``; the kernel stored ``(L, O, I, k, k)``.  One
    grouped ``F.conv_transpose2d`` over the lanes side by side in the
    channels, with each kernel flipped (module docstring)."""
    kernel = p["kernel"]
    lanes, n, h, w, cin = x.shape
    out_ch, k = kernel.shape[1], kernel.shape[-1]
    wt = kernel.transpose(1, 2).flip(-2, -1).reshape(lanes * cin, out_ch, k, k)
    xg = x.permute(1, 0, 4, 2, 3).reshape(n, lanes * cin, h, w)
    y = F.conv_transpose2d(xg, wt, stride=stride, groups=lanes)
    ho, wo = y.shape[2], y.shape[3]
    y = y.reshape(n, lanes, out_ch, ho, wo).permute(1, 0, 3, 4, 2)
    return y + p["bias"][:, None, None, None, :]


def _block_init(in_ch: int, features: int, generator: torch.Generator) -> dict:
    p = {}
    for k, c in enumerate((in_ch, features)):
        p[f"Conv_{k}"] = {"kernel": _lecun_normal((features, c, 3, 3), 9 * c, generator)}
        p[f"GroupNorm_{k}"] = {"scale": torch.ones(features), "bias": torch.zeros(features)}
    return p


def conv_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``_ConvBlock`` (reference L13) of the lanes."""
    for k in range(2):
        x = conv2d_lanes(x, p[f"Conv_{k}"]["kernel"], 1, torch.float32)
        x = torch.relu(group_norm(x, p[f"GroupNorm_{k}"], SEG_GN_GROUPS, GN_EPS))
    return x


@dataclass(frozen=True)
class UNet:
    """``UNet`` (reference L26); ``in_channels`` is the images' channel
    count."""

    num_classes: int
    base: int = 16
    in_channels: int = 3

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        b, g = self.base, generator
        params = {"_ConvBlock_0": _block_init(self.in_channels, b, g),
                  "_ConvBlock_1": _block_init(b, 2 * b, g),
                  "_ConvBlock_2": _block_init(2 * b, 4 * b, g),
                  "ConvTranspose_0": {"kernel": _lecun_normal((2 * b, 4 * b, 2, 2), 16 * b, g),
                                      "bias": torch.zeros(2 * b)},
                  "_ConvBlock_3": _block_init(4 * b, 2 * b, g),
                  "ConvTranspose_1": {"kernel": _lecun_normal((b, 2 * b, 2, 2), 8 * b, g),
                                      "bias": torch.zeros(b)},
                  "_ConvBlock_4": _block_init(2 * b, b, g),
                  "Conv_0": {"kernel": _lecun_normal((self.num_classes, b, 1, 1), b, g),
                             "bias": torch.zeros(self.num_classes)}}
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        """NHWC images -> ``(logits (N, H, W, classes), {})``."""
        p = variables["params"]
        if p["Conv_0"]["kernel"].ndim == 4:
            return single_lane(self, variables, x, train)
        x = x.to(torch.float32)
        d1 = conv_block(p["_ConvBlock_0"], x)
        d2 = conv_block(p["_ConvBlock_1"], max_pool_lanes(d1))
        mid = conv_block(p["_ConvBlock_2"], max_pool_lanes(d2))
        u2 = conv_transpose_lanes(p["ConvTranspose_0"], mid)
        u2 = conv_block(p["_ConvBlock_3"], torch.cat([u2, d2], -1))
        u1 = conv_transpose_lanes(p["ConvTranspose_1"], u2)
        u1 = conv_block(p["_ConvBlock_4"], torch.cat([u1, d1], -1))
        return conv_bias_lanes(p["Conv_0"], u1), {}


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 ``(classes, classes)`` counts, row the label, column the
    prediction, by scatter-add."""
    flat = labels.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    conf = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=preds.device)
    conf.index_put_((flat,), torch.ones_like(flat, dtype=torch.float32), accumulate=True)
    return conf.reshape(num_classes, num_classes)


def segmentation_metrics(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> dict:
    """``pixel_acc``, ``miou`` and ``fwiou`` (reference L48) as 0-d
    tensors."""
    conf = confusion_matrix(logits.argmax(-1), labels, num_classes)
    tp = torch.diagonal(conf)
    rows, total = conf.sum(1), conf.sum()
    iou = tp / torch.clamp_min(conf.sum(0) + rows - tp, 1.0)
    present = (rows > 0).to(torch.float32)
    freq = rows / torch.clamp_min(total, 1.0)
    return {"pixel_acc": tp.sum() / torch.clamp_min(total, 1.0),
            "miou": (iou * present).sum() / torch.clamp_min(present.sum(), 1.0),
            "fwiou": (freq * iou).sum()}
