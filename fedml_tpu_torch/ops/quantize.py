"""Block-scaled stochastic int8 quantization of a flat f32 vector.

The port of ``fedml_tpu/ops/pallas/quantize.py``.  The vector is cut into
blocks of 1024 elements (the TPU's (8, 128) f32 tile, zero past its end);
each block gets ``scale = max|x| / 127 + 1e-12`` and int8 values
``clip(floor(x / scale + u), -127, 127)``, with ``u ~ U[0, 1)`` of shape
``(blocks, 8, 128)`` as an explicit argument (the reference draws it inside
from a key).  ``E[dequantize(quantize(x))] = x``.

Two hand-written CUDA kernels (``csrc/quantize.cu``; its header note names
the TPU kernels they replace, their bound and their design) and beside them
their plain PyTorch versions: :func:`quantize_int8_reference` (mirrors the
reference's L123) and :func:`dequantize_int8_reference`.  A wrapper takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.  Each kernel counts its launches (:func:`launch_counts`).

Divides are IEEE-rounded on both routes.  The plain version divides by a
device tensor, never by a Python number: on CUDA, PyTorch turns a division
by a host scalar into a multiply by its reciprocal, which differs by an ulp.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

BLOCK = 1024
_SUB, _LANE = 8, 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "quantize_int8": (_I, [_P, _P, _P, _P, _I, _I, _P]),
    "dequantize_int8": (_I, [_P, _P, _P, _I, _P]),
}

QUANTIZE = build.Kernel("quantize_int8", "fedml_tpu/ops/pallas/quantize.py:37")
DEQUANTIZE = build.Kernel("dequantize_int8", "fedml_tpu/ops/pallas/quantize.py:50")
KERNELS = (QUANTIZE, DEQUANTIZE)
SOURCE = "fedml_tpu_torch/csrc/quantize.cu"


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()


def noise_shape(length: int) -> tuple:
    """Shape of the uniform draw for a vector of ``length`` elements."""
    return (-(-length // BLOCK), _SUB, _LANE)


def _lib():
    return build.load_library("quantize", _SIGNATURES)


# -- plain PyTorch versions (the CPU path and the kernels' oracle) -----------

def quantize_int8_reference(vec: torch.Tensor, noise: torch.Tensor):
    """``(int8 values (B, 8, 128), f32 scales (B,), length)``."""
    n = vec.shape[0]
    x = F.pad(vec.to(torch.float32), (0, (-n) % BLOCK)).reshape(-1, _SUB, _LANE)
    amax = x.abs().amax(dim=(1, 2), keepdim=True)
    scale = amax / amax.new_full((), 127.0) + 1e-12
    q = torch.floor(x / scale + noise).clamp(-127.0, 127.0).to(torch.int8)
    return q, scale[:, 0, 0], n


def dequantize_int8_reference(values: torch.Tensor, scales: torch.Tensor,
                              length: int) -> torch.Tensor:
    return (values.to(torch.float32) * scales[:, None, None]).reshape(-1)[:length]


# -- kernel launches ---------------------------------------------------------

def _check_device(t: torch.Tensor, device: torch.device, what: str) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, the vector on {device}")


def _quantize_cuda(vec: torch.Tensor, noise: torch.Tensor):
    if vec.ndim != 1 or not 0 < vec.numel() < 2**31:
        raise ValueError(f"quantize kernel takes a flat vector of 1 <= n < 2**31, got "
                         f"shape {tuple(vec.shape)}")
    x = vec.to(torch.float32).contiguous()
    n = x.numel()
    shape = noise_shape(n)
    _check_device(noise, x.device, "noise")
    if noise.dtype != torch.float32 or tuple(noise.shape) != shape or not noise.is_contiguous():
        raise ValueError(f"noise must be contiguous float32 {shape}, got {noise.dtype} "
                         f"{tuple(noise.shape)}")
    values = torch.empty(shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(shape[0], dtype=torch.float32, device=x.device)
    err = _lib().quantize_int8(x.data_ptr(), noise.data_ptr(), values.data_ptr(),
                               scales.data_ptr(), n, shape[0],
                               build.current_stream(x.device, "quantize kernel"))
    if err != 0:
        raise RuntimeError(f"{QUANTIZE.name}: CUDA launch failed with error {err}")
    QUANTIZE.count_launch()
    return values, scales, n


def _dequantize_cuda(values: torch.Tensor, scales: torch.Tensor, length: int) -> torch.Tensor:
    blocks = -(-length // BLOCK)
    if length <= 0 or values.dtype != torch.int8 or not values.is_contiguous() \
            or values.numel() != blocks * BLOCK:
        raise ValueError(f"dequantize kernel takes contiguous int8 ({blocks}, 8, 128) values "
                         f"for length {length}, got {values.dtype} {tuple(values.shape)}")
    _check_device(scales, values.device, "scales")
    if scales.dtype != torch.float32 or scales.shape != (blocks,) or not scales.is_contiguous():
        raise ValueError(f"scales must be contiguous float32 ({blocks},), got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    out = torch.empty(length, dtype=torch.float32, device=values.device)
    err = _lib().dequantize_int8(values.data_ptr(), scales.data_ptr(), out.data_ptr(), length,
                                 build.current_stream(values.device, "dequantize kernel"))
    if err != 0:
        raise RuntimeError(f"{DEQUANTIZE.name}: CUDA launch failed with error {err}")
    DEQUANTIZE.count_launch()
    return out


def quantize_int8_stochastic(vec: torch.Tensor, noise: torch.Tensor):
    """flat vector -> ``(int8 values (B, 8, 128), f32 scales (B,), length)``
    given the uniform draw ``noise`` of shape :func:`noise_shape`: the CUDA
    kernel on the card, the plain version on the CPU; any other device
    raises."""
    if vec.is_cuda:
        return _quantize_cuda(vec, noise)
    if vec.device.type == "cpu":
        return quantize_int8_reference(vec, noise)
    raise RuntimeError(f"quantize has no kernel for device {vec.device}")


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor, length: int) -> torch.Tensor:
    """The first ``length`` elements of ``values * scale[block]`` (f32),
    dispatched like :func:`quantize_int8_stochastic`."""
    if values.is_cuda:
        return _dequantize_cuda(values, scales, length)
    if values.device.type == "cpu":
        return dequantize_int8_reference(values, scales, length)
    raise RuntimeError(f"dequantize has no kernel for device {values.device}")


def qsgd_int8(vec: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Quantize + dequantize round trip: the simulation path's compressor
    (dense in, dense out)."""
    values, scales, n = quantize_int8_stochastic(vec, noise)
    return dequantize_int8(values, scales, n)
