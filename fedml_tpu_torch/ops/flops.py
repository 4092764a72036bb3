"""Analytical FLOPs accounting and the card's peak, for MFU reporting.

The port of ``fedml_tpu/ops/flops.py``.  MFU = (model FLOPs per second) /
(the device's peak FLOPs per second): the nominal FLOPs of the training
computation (forward + backward = 3x forward for matmul-dominated nets),
not the executed FLOPs, as in the reference (the PaLM-appendix convention).
:func:`transformer_train_flops_per_token` and
:func:`resnet20_cifar_train_flops_per_sample` are the reference's as they
are.

:func:`device_peak_flops` is rewritten for the card: the reference's table
lists TPU peaks only, none of which applies here.  As in the reference the
denominator is always the dense bf16 tensor-core peak, here NVIDIA's data
sheet figure for the H100 SXM: 989 TFLOP/s dense (the sheet's 1,979 is with
sparsity), at the part's full 700 W power limit; a card set below it runs
slower, so reports print its power limit beside an MFU.
"""

from __future__ import annotations

from typing import Optional

# dense bf16 tensor-core peak FLOP/s per card by name substring (first match
# wins), from NVIDIA's data sheets, at the part's full power limit
_PEAK_TABLE = [
    ("h100 80gb hbm3", 989e12),   # H100 SXM5, 700 W
]


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of one card, or None for the CPU or an
    unlisted card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for needle, peak in _PEAK_TABLE:
        if needle in name:
            return peak
    return None


def grouped_conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                                _dilation, transposed, _output_padding, _groups, output_mask,
                                out_shape, **kwargs) -> int:
    """FLOPs of ``aten.convolution_backward``: torch's count of the input
    gradient, and the weight gradient counted as the forward's FLOPs.
    ``torch.utils.flop_counter`` counts a grouped conv's weight gradient as
    if every group saw every channel (``groups`` times over), which on the
    lane-batched conv (one group a lane) inflates a MESH round's count by
    the lane count."""
    from torch.utils.flop_counter import conv_flop_count, get_shape

    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, get_shape(out_shape[0]),
                                 not transposed)
    if output_mask[1]:
        flops += conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return flops


def flop_counter():
    """A ``FlopCounterMode`` (no display) with the grouped conv's backward
    counted right (:func:`grouped_conv_backward_flops`)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: grouped_conv_backward_flops})


def transformer_train_flops_per_token(
    n_params: int, n_embed_params: int, n_layers: int, d_model: int, seq_len: int
) -> float:
    """Nominal train FLOPs per token: 6*(matmul params) + attention term.

    ``n_embed_params`` (the gather-only embedding table) is excluded from the
    6N term; the lm_head projection participates in matmuls and stays in.
    The attention score/value matmuls add 12 * L * s * d (fwd 4*s*d per layer,
    x3 for fwd+bwd; counted un-halved since the dense kernel computes the full
    s^2 score matrix).
    """
    return 6.0 * (n_params - n_embed_params) + 12.0 * n_layers * seq_len * d_model


def resnet20_cifar_train_flops_per_sample() -> float:
    """ResNet-20 CIFAR-10 at 32x32: ~40.8M MACs fwd => 81.7 MFLOPs fwd,
    x3 for fwd+bwd.  (Conv MACs from the standard He et al. arch: 3 stages x
    3 blocks x 2 convs at 16/32/64 channels + stem + fc.)"""
    fwd = 81.7e6
    return 3.0 * fwd
