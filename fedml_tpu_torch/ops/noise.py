"""Gaussian noise on a flat f32 vector: ``x + noise * sigma``.

The port of ``fedml_tpu/ops/pallas/noise.py``.  Streaming Shamir SecAgg
adds central-DP noise exactly once, at finalize, to the unmasked aggregate
(``cross_silo/secagg_shamir.py``); the simulator's trust pipeline adds each
of its Gaussian draws through it too (``trust/dp/dp.py`` names the sites).  The N(0, 1) draw is an explicit argument
of shape :func:`noise_shape` (the reference pads the vector to ``(blocks, 8,
128)`` and draws that shape from the round key) or flat ``(n,)`` (the trust
pipeline's draws, local DP's m client draws laid end to end); only its
first ``n`` elements meet the vector.

A hand-written CUDA kernel (``csrc/noise.cu``; its header note names the TPU
kernel it replaces, its bound and its design: 16-byte accesses contiguous
across the warp, every load of a thread issued before the arithmetic) and
beside it the plain PyTorch version :func:`apply_gaussian_noise_reference`
(mirrors the reference's L81).  :func:`apply_gaussian_noise` takes the plain
version only for a vector on the CPU; for a CUDA vector it launches the
kernel or raises.  It picks the kernel's vector variant when x, the draw and
the output are 16-byte aligned, else its scalar one; the C entry sizes the
launch from the length.  The kernel counts its launches
(:func:`launch_counts`), by variant too (:func:`variant_counts`).

Both round the multiply, then the add.  The plain version multiplies by
``sigma`` as a device tensor, never a Python number: on CUDA, PyTorch can
turn arithmetic with a host scalar into a fused or reciprocal form.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .build import aligned16

BLOCK = 1024
_SUB, _LANE = 8, 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gaussian_noise": (_I, [_P, _P, ctypes.c_float, _P, _I, _I, _P])}

NOISE = build.Kernel("gaussian_noise", "fedml_tpu/ops/pallas/noise.py:33")
KERNELS = (NOISE,)
SOURCE = "fedml_tpu_torch/csrc/noise.cu"
VARIANTS = ("vector", "scalar")


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def variant_counts() -> dict:
    """Launches on the card by kernel and variant since the last reset:
    ``{kernel name: {"vector": n, "scalar": m}}``."""
    return {k.name: {v: k.variant_counts().get(v, 0) for v in VARIANTS} for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()


def noise_shape(length: int) -> tuple:
    """Shape of the N(0, 1) draw for a vector of ``length`` elements."""
    return (-(-length // BLOCK), _SUB, _LANE)


def _check(vec: torch.Tensor, noise: torch.Tensor) -> None:
    if vec.ndim != 1 or not 0 < vec.numel() < 2**31:
        raise ValueError(f"noise takes a flat vector of 1 <= n < 2**31, got shape "
                         f"{tuple(vec.shape)}")
    shapes = (noise_shape(vec.numel()), (vec.numel(),))
    if noise.device != vec.device:
        raise ValueError(f"noise on {noise.device}, the vector on {vec.device}")
    if noise.dtype != torch.float32 or tuple(noise.shape) not in shapes \
            or not noise.is_contiguous():
        raise ValueError(f"noise must be contiguous float32 {shapes[0]} or {shapes[1]}, got "
                         f"{noise.dtype} {tuple(noise.shape)}")


def apply_gaussian_noise_reference(vec: torch.Tensor, noise: torch.Tensor,
                                   sigma: float) -> torch.Tensor:
    """The plain version (the CPU path and the kernel's oracle)."""
    x = vec.to(torch.float32)
    return x + noise.reshape(-1)[:x.shape[0]] * x.new_full((), sigma)


def _noise_cuda(vec: torch.Tensor, noise: torch.Tensor, sigma: float) -> torch.Tensor:
    x = vec.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), noise.data_ptr(), out.data_ptr())
    aligned = aligned16(ptrs)
    lib = build.load_library("noise", _SIGNATURES)
    err = lib.gaussian_noise(ptrs[0], ptrs[1], sigma, ptrs[2], x.numel(), aligned,
                             build.current_stream(x.device, "noise kernel"))
    if err != 0:
        raise RuntimeError(f"{NOISE.name}: CUDA launch failed with error {err}")
    NOISE.count_launch("vector" if aligned else "scalar")
    return out


def apply_gaussian_noise(vec: torch.Tensor, noise: torch.Tensor, sigma: float) -> torch.Tensor:
    """flat vector + ``noise * sigma`` (f32) given the N(0, 1) draw ``noise``
    of shape :func:`noise_shape` or flat ``(n,)`` (the kernel reads the first
    ``n`` draws either way): the CUDA kernel on the card, the plain version
    on the CPU; any other device raises."""
    _check(vec, noise)
    if vec.is_cuda:
        return _noise_cuda(vec, noise, float(sigma))
    if vec.device.type == "cpu":
        return apply_gaussian_noise_reference(vec, noise, float(sigma))
    raise RuntimeError(f"noise has no kernel for device {vec.device}")
