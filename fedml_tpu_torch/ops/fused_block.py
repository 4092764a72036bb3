"""Fused BasicBlock epilogue: ``relu(y * scale + shift [+ residual])``.

The port of ``fedml_tpu/ops/pallas/fused_block.py``.  Four hand-written CUDA
kernels (``csrc/fused_block.cu``; its header note names the TPU kernels they
replace, their bound and their design) apply the BN affine folded by
``models/resnet._bn_scale_shift``, the shortcut add and the ReLU in one pass
over an NHWC activation, and compute the backward in one pass plus a small
fixed-order reduction.  ``torch.autograd.Function`` wrappers save
``(y, scale, out)``: the ReLU mask is recovered as ``out > 0``.

Beside the kernels, their plain PyTorch versions:
:func:`fused_block_reference` (mirrors the JAX reference at L289) and
:func:`fused_block_bwd_reference`.  A wrapper takes them only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises.  Each kernel
counts its launches on the card (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_fwd": (_I, [_I, _P, _P, _P, _P, _P, _I, _I, _P]),
    "fused_bwd": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P]),
}
# rows of the backward's per-output scratch: kMaxRowBlocks in the .cu source
_MAX_ROW_BLOCKS = 1024

FWD = build.Kernel("fused_bn_relu_fwd", "fedml_tpu/ops/pallas/fused_block.py:91")
FWD_RES = build.Kernel("fused_bn_residual_relu_fwd", "fedml_tpu/ops/pallas/fused_block.py:85")
BWD = build.Kernel("fused_bn_relu_bwd", "fedml_tpu/ops/pallas/fused_block.py:142")
BWD_RES = build.Kernel("fused_bn_residual_relu_bwd", "fedml_tpu/ops/pallas/fused_block.py:126")
KERNELS = (FWD, FWD_RES, BWD, BWD_RES)
SOURCE = "fedml_tpu_torch/csrc/fused_block.cu"


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()


def _lib():
    return build.load_library("fused_block", _SIGNATURES)


# -- plain PyTorch versions (the CPU path and the kernels' oracle) -----------

def fused_block_reference(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    z = y.to(torch.float32) * scale.to(torch.float32) + shift.to(torch.float32)
    if residual is not None:
        z = z + residual.to(torch.float32)
    return torch.relu(z).to(y.dtype)


def fused_block_bwd_reference(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                              out: torch.Tensor, with_residual: bool):
    """``(dy, d_scale, d_shift, dr)`` with the kernel's explicit mask
    ``out > 0`` (never autograd through a max, which splits at a tie)."""
    gm = g.to(torch.float32) * (out > 0).to(torch.float32)
    dy = (gm * scale.to(torch.float32)).to(y.dtype)
    axes = tuple(range(gm.ndim - 1))
    d_scale = (gm * y.to(torch.float32)).sum(axes)
    d_shift = gm.sum(axes)
    dr = gm.to(y.dtype) if with_residual else None
    return dy, d_scale, d_shift, dr


# -- kernel launches ---------------------------------------------------------

def _check(y: torch.Tensor, vectors, others) -> None:
    if y.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused block kernel takes float32 or bfloat16, got {y.dtype}")
    if y.ndim != 4 or not y.is_contiguous():
        raise ValueError("fused block kernel takes a contiguous NHWC tensor, got shape "
                         f"{tuple(y.shape)} with strides {y.stride()}")
    if y.numel() == 0 or y.numel() >= 2**31:
        raise ValueError(f"fused block kernel takes 1 <= numel < 2**31, got {y.numel()}")
    c = y.shape[-1]
    for v in vectors:
        if v.device != y.device:
            raise ValueError(f"operands on {v.device} and {y.device}")
        if v.dtype != torch.float32 or v.shape != (c,) or not v.is_contiguous():
            raise ValueError(f"per-channel vector must be contiguous float32 ({c},), "
                             f"got {v.dtype} {tuple(v.shape)}")
    for t in others:
        if t is None:
            continue
        if t.dtype != y.dtype or t.shape != y.shape or not t.is_contiguous():
            raise ValueError("operand must match y's dtype/shape and be contiguous, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != y.device:
            raise ValueError(f"operands on {t.device} and {y.device}")


def _fwd_cuda(y, scale, shift, residual):
    _check(y, (scale, shift), (residual,))
    kernel = FWD_RES if residual is not None else FWD
    out = torch.empty_like(y)
    err = _lib().fused_fwd(
        _DTYPE_CODES[y.dtype], y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        y.numel(), y.shape[-1], build.current_stream(y.device, "fused block kernel"))
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.count_launch()
    return out


def _bwd_cuda(g, y, scale, out, with_residual: bool):
    _check(y, (scale,), (g, out))
    kernel = BWD_RES if with_residual else BWD
    n, c = y.numel(), y.shape[-1]
    partial = torch.empty((2, _MAX_ROW_BLOCKS, c), dtype=torch.float32, device=y.device)
    d_scale = torch.empty(c, dtype=torch.float32, device=y.device)
    d_shift = torch.empty(c, dtype=torch.float32, device=y.device)
    dy = torch.empty_like(y)
    dr = torch.empty_like(y) if with_residual else None
    err = _lib().fused_bwd(
        _DTYPE_CODES[y.dtype], g.data_ptr(), y.data_ptr(), scale.data_ptr(),
        out.data_ptr(), dy.data_ptr(), dr.data_ptr() if dr is not None else None,
        partial.data_ptr(), d_scale.data_ptr(), d_shift.data_ptr(), n, c,
        build.current_stream(y.device, "fused block kernel"))
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.count_launch()
    return dy, d_scale, d_shift, dr


def fused_block_forward(y, scale, shift, residual=None):
    """One forward pass: the CUDA kernel on the card, the plain version on
    the CPU; any other device raises."""
    if y.is_cuda:
        return _fwd_cuda(y, scale, shift, residual)
    if y.device.type == "cpu":
        return fused_block_reference(y, scale, shift, residual)
    raise RuntimeError(f"fused block has no kernel for device {y.device}")


def fused_block_backward(g, y, scale, out, with_residual: bool):
    """One backward pass: ``(dy, d_scale, d_shift, dr)``, dispatched like
    :func:`fused_block_forward`."""
    if y.is_cuda:
        return _bwd_cuda(g.contiguous(), y, scale, out, with_residual)
    if y.device.type == "cpu":
        return fused_block_bwd_reference(g, y, scale, out, with_residual)
    raise RuntimeError(f"fused block has no kernel for device {y.device}")


class _FusedBNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift):
        out = fused_block_forward(y, scale, shift)
        ctx.save_for_backward(y, scale, out)
        return out

    @staticmethod
    def backward(ctx, g):
        y, scale, out = ctx.saved_tensors
        dy, d_scale, d_shift, _ = fused_block_backward(g, y, scale, out, False)
        return dy, d_scale, d_shift


class _FusedBNResidualReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift, residual):
        out = fused_block_forward(y, scale, shift, residual)
        ctx.save_for_backward(y, scale, out)
        return out

    @staticmethod
    def backward(ctx, g):
        y, scale, out = ctx.saved_tensors
        dy, d_scale, d_shift, dr = fused_block_backward(g, y, scale, out, True)
        return dy, d_scale, d_shift, dr


def fused_bn_relu(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``relu(y * scale + shift)`` with a per-channel (last-axis) affine, in
    one fused pass; differentiable (fused backward)."""
    return _FusedBNReLU.apply(y, scale, shift)


def fused_bn_residual_relu(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                           residual: torch.Tensor) -> torch.Tensor:
    """``relu(y * scale + shift + residual)``: the whole BasicBlock epilogue
    (BN apply, shortcut add, activation) in one fused pass; differentiable."""
    return _FusedBNResidualReLU.apply(y, scale, shift, residual)
