"""The CNN zoo: MobileNet v1 / v3-small, EfficientNet-B0 and VGG-11 / 16
(the port of ``fedml_tpu/models/cnn_zoo.py``).

Each model follows the port's model interface (``models/resnet.py``): a
frozen description with ``init(generator, device)`` and ``apply(variables,
x, train) -> (logits, new_batch_stats)`` over the flax variable tree in
torch layouts.  Names are flax's auto-names in creation order, numbered per
type within each module: ``Conv_k``, ``BatchNorm_k`` / ``GroupNorm_k``
(``make_norm()`` numbers them per module), ``Dense_k``,
``DepthwiseSeparable_k``, ``MBConv_k``, ``SqueezeExcite_0``.

Semantics kept from flax:
- ``norm="batch"``: ``nn.BatchNorm`` (momentum 0.9, eps 1e-5; running
  statistics in ``batch_stats``); ``norm="group"``: ``nn.GroupNorm(8)``
  (eps 1e-6, no statistics); both compute in f32 and return the compute
  dtype (``resnet.batch_norm`` / ``resnet.group_norm``);
- convs ``padding="SAME"`` without bias in the compute dtype; a depthwise
  conv (``feature_group_count=C``) has the OIHW kernel ``(C, 1, kh, kw)``;
- Dense layers in the compute dtype, the last one in f32;
- ``hswish(x) = x * relu6(x + 3) / 6`` and ``swish(x) = x * sigmoid(x)``
  with ``sigmoid(x) = 1 / (1 + exp(-x))``, rounded op by op as jax lowers
  them; SqueezeExcite's width is ``max(C // 4, 4)``; the
  MBConv residual applies only when the stride is 1 and C is unchanged;
- ``small_input`` (CIFAR-sized images) takes a stride-1 stem.

Lanes: lane-major ``(L, N, H, W, C)`` input with lane-stacked variables
(the conv kernels 5-D) run ``L`` models at once: every conv one grouped
conv (``resnet.conv2d_lanes``, ``L * C`` groups for a depthwise conv), the
norms per lane, every Dense one ``torch.bmm``.  One model alone is the lane
form with one lane.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.pytree import tree_map
from .resnet import _lecun_normal, conv2d_lanes, norm_init, norm_layer
from .simple import single_lane

ZOO_GN_GROUPS = 8  # the zoo's GroupNorm(num_groups=8) (reference L28)


def relu(x):
    return torch.relu(x)


def hswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def sigmoid(x):
    # jax lowers jax.nn.sigmoid to 1 / (1 + exp(-x)) rounded op by op; in
    # bf16 torch.sigmoid rounds once and differs
    return 1.0 / (1.0 + torch.exp(-x))


def swish(x):
    return x * sigmoid(x)


_ACTS = {"relu": relu, "hswish": hswish, "swish": swish}


class _Init:
    """Fresh parameters drawn in creation order from one generator."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def conv(self, c_in: int, c_out: int, k: int, groups: int = 1) -> dict:
        fan_in = (c_in // groups) * k * k
        return {"kernel": _lecun_normal((c_out, c_in // groups, k, k), fan_in, self.g)}

    def dense(self, c_in: int, c_out: int) -> dict:
        return {"kernel": _lecun_normal((c_out, c_in), c_in, self.g), "bias": torch.zeros(c_out)}


def _conv(p: dict, x: torch.Tensor, stride: int, dtype, groups: int = 1) -> torch.Tensor:
    return conv2d_lanes(x, p["kernel"], stride, dtype, groups)


def _dense(p: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)`` of the lanes: ``(L, N, in)`` -> ``(L, N,
    out)``, input, kernel and bias cast to ``dtype``."""
    kernel, bias = p["kernel"].to(dtype), p["bias"].to(dtype)
    return torch.bmm(x.to(dtype), kernel.transpose(1, 2)) + bias[:, None, :]


def _spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of each lane: ``(L, N, C)``."""
    return x.mean(dim=(2, 3))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool((2, 2), strides=(2, 2))`` (VALID) of each lane."""
    lanes, n, h, w, c = x.shape
    y = F.max_pool2d(x.reshape(lanes * n, h, w, c).permute(0, 3, 1, 2), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 1).reshape(lanes, n, h // 2, w // 2, c)


class _Norm:
    """A module's norms, numbered in creation order (``make_norm()``)."""

    def __init__(self, kind: str, p: dict, st: dict, train: bool):
        self.kind, self.p, self.st, self.train, self.k = kind, p, dict(st), train, 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = norm_layer(self.kind, x, self.p, self.st, self.k, self.train, ZOO_GN_GROUPS)
        self.k += 1
        return y


class _NormInit:
    def __init__(self, kind: str, p: dict, st: dict):
        self.kind, self.p, self.st, self.k = kind, p, st, 0

    def __call__(self, c: int) -> None:
        norm_init(self.kind, self.p, self.st, self.k, c)
        self.k += 1


def _child(parent_st: dict, name: str, child_st: dict) -> None:
    if child_st:
        parent_st[name] = child_st


@dataclass(frozen=True)
class _Zoo:
    """Shared init / apply frame: subclasses define ``_build(init, c_in)``
    (fresh ``(params, stats)``) and ``_forward(p, st, x, train)`` (lane
    form)."""

    num_classes: int = 10
    norm: str = "batch"
    dtype: torch.dtype = torch.float32
    small_input: bool = True
    in_channels: int = 3  # one image's channels (flax infers them from the input)

    @property
    def stem_stride(self) -> int:
        return 1 if self.small_input else 2

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        """Fresh variables drawn on the CPU from ``generator``, then moved
        to ``device``."""
        params, stats = self._build(_Init(generator), self.in_channels)
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        return tree_map(lambda t: t.to(device), variables)

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        """NHWC ``x`` -> ``(logits, new_batch_stats)``: f32 logits ``(N,
        classes)``; lane-major ``x`` with lane-stacked variables gives ``(L,
        N, classes)`` and lane-stacked stats.  Eval mode returns the stats
        unchanged; GroupNorm has none (``{}``)."""
        p, st = variables["params"], variables.get("batch_stats", {})
        if p["Conv_0"]["kernel"].ndim == 4:
            return single_lane(self, variables, x, train)
        return self._forward(p, st, x.to(self.dtype), train)


def _depthwise_separable_build(init: _Init, p: dict, st: dict, kind: str, c_in: int,
                               features: int) -> None:
    norm = _NormInit(kind, p, st)
    p["Conv_0"] = init.conv(c_in, c_in, 3, groups=c_in)
    norm(c_in)
    p["Conv_1"] = init.conv(c_in, features, 1)
    norm(features)


def _depthwise_separable(p: dict, st: dict, x, stride: int, kind: str, dtype, train: bool):
    """``DepthwiseSeparable`` (reference L33): 3x3 depthwise, norm, ReLU,
    1x1 pointwise, norm, ReLU."""
    norm = _Norm(kind, p, st, train)
    x = relu(norm(_conv(p["Conv_0"], x, stride, dtype, groups=x.shape[-1])))
    x = relu(norm(_conv(p["Conv_1"], x, 1, dtype)))
    return x, norm.st


_MOBILENET_V1_PLAN = ([(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)]
                      + [(512, 1)] * 5 + [(1024, 2), (1024, 1)])


@dataclass(frozen=True)
class MobileNetV1(_Zoo):
    """``MobileNetV1`` (reference L54, width 1.0): a 32-channel stem and 13
    depthwise-separable blocks, mean pool, ``Dense(classes)`` in f32."""

    def _build(self, init: _Init, c_in: int):
        p, st = {}, {}
        norm = _NormInit(self.norm, p, st)
        p["Conv_0"] = init.conv(c_in, 32, 3)
        norm(32)
        c = 32
        for i, (feats, _) in enumerate(_MOBILENET_V1_PLAN):
            bp, bs = {}, {}
            _depthwise_separable_build(init, bp, bs, self.norm, c, feats)
            p[f"DepthwiseSeparable_{i}"] = bp
            _child(st, f"DepthwiseSeparable_{i}", bs)
            c = feats
        p["Dense_0"] = init.dense(c, self.num_classes)
        return p, st

    def _forward(self, p, st, x, train):
        norm = _Norm(self.norm, p, st, train)
        x = relu(norm(_conv(p["Conv_0"], x, self.stem_stride, self.dtype)))
        for i, (_, stride) in enumerate(_MOBILENET_V1_PLAN):
            name = f"DepthwiseSeparable_{i}"
            x, bs = _depthwise_separable(p[name], st.get(name, {}), x, stride, self.norm,
                                         self.dtype, train)
            _child(norm.st, name, bs)
        return _dense(p["Dense_0"], _spatial_mean(x), torch.float32), norm.st


def _se_width(c: int) -> int:
    return max(c // 4, 4)


def _squeeze_excite(p: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """``SqueezeExcite`` (reference L74): the channels rescaled by
    ``sigmoid(Dense(relu(Dense(mean))))``."""
    s = relu(_dense(p["Dense_0"], _spatial_mean(x), dtype))
    s = sigmoid(_dense(p["Dense_1"], s, dtype))
    return x * s[:, :, None, None, :]


def _mbconv_build(init: _Init, p: dict, st: dict, kind: str, c_in: int, features: int,
                  expand: int, kernel: int, use_se: bool) -> None:
    norm = _NormInit(kind, p, st)
    mid = c_in * expand
    conv = 0
    if expand != 1:
        norm(mid)  # make_norm() is built before the Conv it wraps
        p["Conv_0"] = init.conv(c_in, mid, 1)
        conv = 1
    p[f"Conv_{conv}"] = init.conv(mid, mid, kernel, groups=mid)
    norm(mid)
    if use_se:
        p["SqueezeExcite_0"] = {"Dense_0": init.dense(mid, _se_width(mid)),
                                "Dense_1": init.dense(_se_width(mid), mid)}
    norm(features)
    p[f"Conv_{conv + 1}"] = init.conv(mid, features, 1)


def _mbconv(p: dict, st: dict, x, features: int, expand: int, stride: int, use_se: bool,
            act: str, kind: str, dtype, train: bool):
    """``MBConv`` (reference L85): 1x1 expand (unless ``expand`` is 1),
    depthwise ``kernel`` x ``kernel``, optional SqueezeExcite, 1x1 project,
    the residual when the stride is 1 and the width is unchanged."""
    norm, f = _Norm(kind, p, st, train), _ACTS[act]
    h, conv = x, 0
    if expand != 1:
        h = f(norm(_conv(p["Conv_0"], h, 1, dtype)))
        conv = 1
    h = f(norm(_conv(p[f"Conv_{conv}"], h, stride, dtype, groups=h.shape[-1])))
    if use_se:
        h = _squeeze_excite(p["SqueezeExcite_0"], h, dtype)
    h = norm(_conv(p[f"Conv_{conv + 1}"], h, 1, dtype))
    if stride == 1 and x.shape[-1] == features:
        h = h + x
    return h, norm.st


# (features, expand, kernel, stride, se, act)
_MOBILENET_V3_PLAN = [
    (16, 1, 3, 2, True, "relu"),
    (24, 4, 3, 2, False, "relu"),
    (24, 3, 3, 1, False, "relu"),
    (40, 3, 5, 2, True, "hswish"),
    (40, 3, 5, 1, True, "hswish"),
    (48, 3, 5, 1, True, "hswish"),
    (96, 6, 5, 2, True, "hswish"),
    (96, 6, 5, 1, True, "hswish"),
]


def _mbconv_stack_build(init: _Init, p: dict, st: dict, kind: str, c: int, plan) -> int:
    for i, (feats, expand, kernel, _, se, _) in enumerate(plan):
        bp, bs = {}, {}
        _mbconv_build(init, bp, bs, kind, c, feats, expand, kernel, se)
        p[f"MBConv_{i}"] = bp
        _child(st, f"MBConv_{i}", bs)
        c = feats
    return c


def _mbconv_stack(p: dict, st: dict, norm: _Norm, x, plan, kind: str, dtype, train: bool):
    for i, (feats, expand, _, stride, se, act) in enumerate(plan):
        name = f"MBConv_{i}"
        x, bs = _mbconv(p[name], st.get(name, {}), x, feats, expand, stride, se, act, kind,
                        dtype, train)
        _child(norm.st, name, bs)
    return x


@dataclass(frozen=True)
class MobileNetV3Small(_Zoo):
    """``MobileNetV3Small`` (reference L126, the 'small' profile): a
    16-channel hswish stem, 8 MBConv blocks, a 576-channel 1x1 conv,
    ``Dense(1024)`` with hswish, ``Dense(classes)`` in f32."""

    def _build(self, init: _Init, c_in: int):
        p, st = {}, {}
        norm = _NormInit(self.norm, p, st)
        p["Conv_0"] = init.conv(c_in, 16, 3)
        norm(16)
        c = _mbconv_stack_build(init, p, st, self.norm, 16, _MOBILENET_V3_PLAN)
        p["Conv_1"] = init.conv(c, 576, 1)
        norm(576)
        p["Dense_0"] = init.dense(576, 1024)
        p["Dense_1"] = init.dense(1024, self.num_classes)
        return p, st

    def _forward(self, p, st, x, train):
        norm = _Norm(self.norm, p, st, train)
        x = hswish(norm(_conv(p["Conv_0"], x, self.stem_stride, self.dtype)))
        x = _mbconv_stack(p, st, norm, x, _MOBILENET_V3_PLAN, self.norm, self.dtype, train)
        x = hswish(norm(_conv(p["Conv_1"], x, 1, self.dtype)))
        x = hswish(_dense(p["Dense_0"], _spatial_mean(x), self.dtype))
        return _dense(p["Dense_1"], x, torch.float32), norm.st


# (features, expand, kernel, stride, repeats), every block with SE and swish
_EFFICIENTNET_B0_STAGES = [
    (16, 1, 3, 1, 1), (24, 6, 3, 2, 2), (40, 6, 5, 2, 2),
    (80, 6, 3, 2, 3), (112, 6, 5, 1, 3), (192, 6, 5, 2, 4), (320, 6, 3, 1, 1),
]
_EFFICIENTNET_B0_PLAN = [(feats, expand, kernel, stride if r == 0 else 1, True, "swish")
                         for feats, expand, kernel, stride, repeats in _EFFICIENTNET_B0_STAGES
                         for r in range(repeats)]


@dataclass(frozen=True)
class EfficientNetB0(_Zoo):
    """``EfficientNetB0`` (reference L169): a 32-channel swish stem, 16
    MBConv blocks with SE and swish, a 1280-channel 1x1 conv, mean pool,
    ``Dense(classes)`` in f32."""

    def _build(self, init: _Init, c_in: int):
        p, st = {}, {}
        norm = _NormInit(self.norm, p, st)
        norm(32)  # make_norm() is built before the stem Conv it wraps
        p["Conv_0"] = init.conv(c_in, 32, 3)
        c = _mbconv_stack_build(init, p, st, self.norm, 32, _EFFICIENTNET_B0_PLAN)
        norm(1280)
        p["Conv_1"] = init.conv(c, 1280, 1)
        p["Dense_0"] = init.dense(1280, self.num_classes)
        return p, st

    def _forward(self, p, st, x, train):
        norm = _Norm(self.norm, p, st, train)
        x = swish(norm(_conv(p["Conv_0"], x, self.stem_stride, self.dtype)))
        x = _mbconv_stack(p, st, norm, x, _EFFICIENTNET_B0_PLAN, self.norm, self.dtype, train)
        x = swish(norm(_conv(p["Conv_1"], x, 1, self.dtype)))
        return _dense(p["Dense_0"], _spatial_mean(x), torch.float32), norm.st


_VGG_PLANS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"),
}


@dataclass(frozen=True)
class VGG(_Zoo):
    """``VGG`` 11 / 16 with norm (reference L206): 3x3 conv, norm, ReLU per
    plan entry, 2x2 max-pools, mean pool, ``Dense(512)`` with ReLU,
    ``Dense(classes)`` in f32.  Has no stem stride (``small_input`` is not
    read)."""

    depth: int = 11

    def _build(self, init: _Init, c_in: int):
        p, st = {}, {}
        norm = _NormInit(self.norm, p, st)
        c, k = c_in, 0
        for step in _VGG_PLANS[self.depth]:
            if step != "M":
                p[f"Conv_{k}"] = init.conv(c, step, 3)
                norm(step)
                c, k = step, k + 1
        p["Dense_0"] = init.dense(c, 512)
        p["Dense_1"] = init.dense(512, self.num_classes)
        return p, st

    def _forward(self, p, st, x, train):
        norm, k = _Norm(self.norm, p, st, train), 0
        for step in _VGG_PLANS[self.depth]:
            if step == "M":
                x = _max_pool(x)
            else:
                x = relu(norm(_conv(p[f"Conv_{k}"], x, 1, self.dtype)))
                k += 1
        x = relu(_dense(p["Dense_0"], _spatial_mean(x), self.dtype))
        return _dense(p["Dense_1"], x, torch.float32), norm.st
