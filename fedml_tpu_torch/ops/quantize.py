"""Block-scaled stochastic int8 quantization of a flat f32 vector.

The port of ``fedml_tpu/ops/pallas/quantize.py``.  The vector is cut into
blocks of 1024 elements (the TPU's (8, 128) f32 tile, zero past its end);
each block gets ``scale = max|x| / 127 + 1e-12`` and int8 values
``clip(floor(x / scale + u), -127, 127)``, with ``u ~ U[0, 1)`` of shape
``(blocks, 8, 128)`` as an explicit argument (the reference draws it inside
from a key).  ``E[dequantize(quantize(x))] = x``.

Two hand-written CUDA kernels (``csrc/quantize.cu``; its header note names
the TPU kernels they replace, their bound and their design: a thread block
per quantization block with every load issued before the max, a warp per
128 dequantized values, 16-byte accesses) and beside them their plain
PyTorch versions: :func:`quantize_int8_reference` (mirrors the reference's
L123) and :func:`dequantize_int8_reference`.  A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.  It picks the kernel's vector variant when the operands
are 16-byte aligned, else its scalar one; the C entry sizes the launch
from the length.  Each kernel counts its launches (:func:`launch_counts`),
by variant too (:func:`variant_counts`).

Lanes: :func:`quantize_int8_lanes` and :func:`dequantize_int8_lanes` (and
:func:`qsgd_int8_lanes`, both) take ``L`` vectors (the simulator's batched
round, one a client) in one launch of each kernel: each vector padded with
zeros to whole blocks, as the reference pads one (``_pad_blocks``), and the
lanes laid end to end, so each lane's blocks and values are bitwise its own
call's.  Those launches count under kernels of
their own (``*_lanes``, :data:`LANE_KERNELS`).

Divides are IEEE-rounded on both routes.  The plain version divides by a
device tensor, never by a Python number: on CUDA, PyTorch turns a division
by a host scalar into a multiply by its reciprocal, which differs by an ulp.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, timing
from .build import aligned16

BLOCK = 1024
_SUB, _LANE = 8, 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "quantize_int8": (_I, [_P, _P, _P, _P, _I, _I, _P, _P, _P]),
    "dequantize_int8": (_I, [_P, _P, _P, _I, _I, _P, _P, _P]),
}

# timing labels (ops/timing.py): the reference's names of the observed calls
# (fedml_tpu/ops/pallas/quantize.py:66/98)
QUANTIZE = build.Kernel("quantize_int8", "fedml_tpu/ops/pallas/quantize.py:37",
                        "quantize_int8_stochastic")
DEQUANTIZE = build.Kernel("dequantize_int8", "fedml_tpu/ops/pallas/quantize.py:50",
                          "dequantize_int8")
KERNELS = (QUANTIZE, DEQUANTIZE)
# the same kernels launched once for the L lanes of qsgd_int8_lanes
QUANTIZE_LANES = build.Kernel("quantize_int8_lanes", QUANTIZE.replaces, QUANTIZE.label)
DEQUANTIZE_LANES = build.Kernel("dequantize_int8_lanes", DEQUANTIZE.replaces, DEQUANTIZE.label)
LANE_KERNELS = (QUANTIZE_LANES, DEQUANTIZE_LANES)
SOURCE = "fedml_tpu_torch/csrc/quantize.cu"
VARIANTS = ("vector", "scalar")


def launch_counts() -> dict:
    """Launches on the card by kernel since the last reset, the lane-batched
    ones (``*_lanes``) apart."""
    return {k.name: k.launches for k in KERNELS + LANE_KERNELS}


def variant_counts() -> dict:
    """Launches on the card by kernel and variant since the last reset:
    ``{kernel name: {"vector": n, "scalar": m}}``."""
    return {k.name: {v: k.variant_counts().get(v, 0) for v in VARIANTS}
            for k in KERNELS + LANE_KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS + LANE_KERNELS:
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


def _quantize_cuda(vec: torch.Tensor, noise: torch.Tensor, kernel: build.Kernel = QUANTIZE):
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
    ptrs = (x.data_ptr(), noise.data_ptr(), values.data_ptr())
    aligned = aligned16(ptrs)
    stream = build.current_stream(x.device, "quantize kernel")
    start, stop, _ = token = timing.launch_begin(kernel.label)
    err = _lib().quantize_int8(*ptrs, scales.data_ptr(), n, aligned, stream, start, stop)
    timing.launch_end(token, err)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.count_launch("vector" if aligned else "scalar", start is not None)
    return values, scales, n


def _dequantize_cuda(values: torch.Tensor, scales: torch.Tensor, length: int,
                     kernel: build.Kernel = DEQUANTIZE) -> torch.Tensor:
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
    v_ptr, o_ptr = values.data_ptr(), out.data_ptr()
    aligned = aligned16((v_ptr, o_ptr))
    stream = build.current_stream(values.device, "dequantize kernel")
    start, stop, _ = token = timing.launch_begin(kernel.label)
    err = _lib().dequantize_int8(v_ptr, scales.data_ptr(), o_ptr, length, aligned, stream, start,
                                 stop)
    timing.launch_end(token, err)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.count_launch("vector" if aligned else "scalar", start is not None)
    return out


def quantize_int8_stochastic(vec: torch.Tensor, noise: torch.Tensor):
    """flat vector -> ``(int8 values (B, 8, 128), f32 scales (B,), length)``
    given the uniform draw ``noise`` of shape :func:`noise_shape`: the CUDA
    kernel on the card, the plain version on the CPU; any other device
    raises."""
    if vec.is_cuda:
        return _quantize_cuda(vec, noise)
    if vec.device.type == "cpu":
        return timing.observe_eager(QUANTIZE.label, quantize_int8_reference, vec, noise)
    raise RuntimeError(f"quantize has no kernel for device {vec.device}")


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor, length: int) -> torch.Tensor:
    """The first ``length`` elements of ``values * scale[block]`` (f32),
    dispatched like :func:`quantize_int8_stochastic`."""
    if values.is_cuda:
        return _dequantize_cuda(values, scales, length)
    if values.device.type == "cpu":
        return timing.observe_eager(DEQUANTIZE.label, dequantize_int8_reference, values, scales,
                                    length)
    raise RuntimeError(f"dequantize has no kernel for device {values.device}")


def qsgd_int8(vec: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Quantize + dequantize round trip: the simulation path's compressor
    (dense in, dense out)."""
    values, scales, n = quantize_int8_stochastic(vec, noise)
    return dequantize_int8(values, scales, n)


def lanes_end_to_end(vecs: torch.Tensor, noise: torch.Tensor):
    """``L`` vectors (``(L, n)``) and their draws (``(L,) + noise_shape(n)``)
    as one vector and one draw: each vector padded with zeros to whole
    blocks, the lanes laid end to end (one copy).  Returns ``(x, u,
    (L,) + noise_shape(n))``."""
    lanes, n = vecs.shape
    shape = (lanes,) + noise_shape(n)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise must be {shape} for {lanes} lanes of {n}, got "
                         f"{tuple(noise.shape)}")
    x = F.pad(vecs.to(torch.float32), (0, shape[1] * BLOCK - n)).reshape(-1)
    return x, noise.reshape((-1,) + shape[2:]), shape


def quantize_int8_lanes_reference(vecs: torch.Tensor, noise: torch.Tensor):
    """The plain version of :func:`quantize_int8_lanes`."""
    x, u, shape = lanes_end_to_end(vecs, noise)
    values, scales, _ = quantize_int8_reference(x, u)
    return values.view(shape), scales.view(shape[:2]), vecs.shape[1]


def dequantize_int8_lanes_reference(values: torch.Tensor, scales: torch.Tensor,
                                    length: int) -> torch.Tensor:
    """The plain version of :func:`dequantize_int8_lanes`."""
    out = dequantize_int8_reference(values.reshape((-1,) + values.shape[2:]), scales.reshape(-1),
                                    values.numel())
    return out.view(values.shape[0], -1)[:, :length]


def quantize_int8_lanes(vecs: torch.Tensor, noise: torch.Tensor):
    """:func:`quantize_int8_stochastic` of each row of ``vecs`` (``(L, n)``)
    with its row of ``noise`` (``(L,) + noise_shape(n)``) in one launch on
    the card: the rows padded with zeros to whole blocks and laid end to end
    (one copy).  Returns ``(int8 values (L, B, 8, 128), f32 scales (L, B),
    n)``.  The plain version on the CPU; any other device raises."""
    if vecs.is_cuda:
        x, u, shape = lanes_end_to_end(vecs, noise)
        values, scales, _ = _quantize_cuda(x, u.contiguous(), QUANTIZE_LANES)
        return values.view(shape), scales.view(shape[:2]), vecs.shape[1]
    if vecs.device.type == "cpu":
        return timing.observe_eager(QUANTIZE.label, quantize_int8_lanes_reference, vecs, noise)
    raise RuntimeError(f"quantize has no kernel for device {vecs.device}")


def dequantize_int8_lanes(values: torch.Tensor, scales: torch.Tensor, length: int) -> torch.Tensor:
    """The first ``length`` elements of each lane's ``values * scale[block]``
    (``(L, B, 8, 128)`` values, ``(L, B)`` scales) in one launch on the card:
    a ``(L, length)`` view.  Dispatched like :func:`quantize_int8_lanes`."""
    if values.is_cuda:
        out = _dequantize_cuda(values.reshape((-1,) + values.shape[2:]), scales.reshape(-1),
                               values.numel(), DEQUANTIZE_LANES)
        return out.view(values.shape[0], -1)[:, :length]
    if values.device.type == "cpu":
        return timing.observe_eager(DEQUANTIZE.label, dequantize_int8_lanes_reference, values,
                                    scales, length)
    raise RuntimeError(f"dequantize has no kernel for device {values.device}")


def qsgd_int8_lanes(vecs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """:func:`qsgd_int8` of each row of ``vecs`` (``(L, n)``) with its row of
    ``noise``: one quantize and one dequantize launch for all rows on the
    card, a ``(L, n)`` result."""
    return dequantize_int8_lanes(*quantize_int8_lanes(vecs, noise))
