"""Gradient compression operators of the FedSGD path (the port of
``fedml_tpu/ops/compression.py``).

Each operator is a function of the flat f32 vector (in the reference's flat
layout, ``weights.flatten_reference``) and keeps it dense: a masked or
quantized vector of the same length.  Error-feedback residuals are explicit
state, threaded as the FedSGD client state.  Randomness is an explicit
``U[0, 1)`` draw: ``(n,)`` for ``qsgd``, :func:`quantize.noise_shape` for
``qsgd_int8``; :func:`draw_shape` says which.

Lanes: each operator also takes ``L`` vectors as the rows of an ``(L, n)``
tensor (the simulator's batched round, one a client), with ``(L, ...)``
draws and residuals, and treats each row as it treats one vector, with
torch ops along the last axis (``qsgd_int8``: one quantize and one
dequantize launch for all rows).

Rounding follows the reference op for op: ``torch.round`` and ``jnp.round``
both round half to even, and every division is by a device tensor, which
keeps it an IEEE divide on the card (see ``ops/quantize.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import quantize


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return like.new_full((), value)


def top_k_mask(vec: torch.Tensor, ratio: float) -> torch.Tensor:
    """Keep the entries with ``|v| >=`` the k-th largest ``|v|``, ``k =
    max(1, int(ratio * n))`` (ties at the threshold are all kept); zero the
    rest.  Per row of an ``(L, n)`` vec."""
    k = max(1, int(ratio * vec.shape[-1]))
    thresh = torch.topk(vec.abs(), k, dim=-1).values[..., -1:]
    return torch.where(vec.abs() >= thresh, vec, 0.0)


def ef_top_k(vec: torch.Tensor, residual: torch.Tensor, ratio: float):
    """Error-feedback top-k: add the residual, compress, keep what was
    dropped as the next residual.  Returns ``(compressed, new_residual)``."""
    corrected = vec + residual
    compressed = top_k_mask(corrected, ratio)
    return compressed, corrected - compressed


def quantize_naive(vec: torch.Tensor, levels: int = 256) -> torch.Tensor:
    """Uniform quantization to ``levels`` steps of the vector's range (of
    each row's range of an ``(L, n)`` vec)."""
    vmax = vec.abs().amax(-1, keepdim=True) + 1e-12
    step = 2.0 * vmax / _full(vmax, levels - 1)
    return torch.round(vec / step) * step


def qsgd(vec: torch.Tensor, noise: torch.Tensor, levels: int = 256) -> torch.Tensor:
    """QSGD: scale by the l2 norm and round stochastically to ``levels``
    buckets (unbiased), given the ``(n,)`` uniform draw ``noise`` (per row of
    an ``(L, n)`` vec, with ``(L, n)`` noise)."""
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 1e-12
    scaled = vec.abs() / norm * levels
    floor = torch.floor(scaled)
    prob = scaled - floor
    q = floor + (noise < prob).to(vec.dtype)
    return torch.sign(vec) * q * norm / _full(norm, levels)


def qsgd_int8_fused(vec: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Block-scaled stochastic int8 quantize + dequantize through the CUDA
    kernels on the card (``ops/quantize.py``), their plain versions on the
    CPU; the rows of an ``(L, n)`` vec in one launch of each."""
    if vec.ndim == 2:
        return quantize.qsgd_int8_lanes(vec, noise)
    return quantize.qsgd_int8(vec, noise)


def draw_shape(name: str, n: int) -> Optional[tuple]:
    """Shape of the uniform draw that ``compress(name, ...)`` takes for a
    vector of ``n`` elements, or None if it takes none (a lane's: ``L``
    vectors take ``(L,) + shape``)."""
    if name == "qsgd":
        return (n,)
    if name == "qsgd_int8":
        return quantize.noise_shape(n)
    return None


def compress(name: Optional[str], vec: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None, ratio: float = 0.01,
             quantize_level: int = 8):
    """Dispatch on the reference's ``compression`` values (``no | topk |
    eftopk | quantize | qsgd``, plus ``qsgd_int8``) for one vector or the
    rows of an ``(L, n)`` one.  Returns ``(vec, new_residual)``."""
    if name in ("no", "", None):
        return vec, residual
    if name == "topk":
        return top_k_mask(vec, ratio), residual
    if name == "eftopk":
        return ef_top_k(vec, residual, ratio)
    if name == "quantize":
        return quantize_naive(vec, 2 ** quantize_level), residual
    if name == "qsgd":
        return qsgd(vec, noise, 2 ** quantize_level), residual
    if name == "qsgd_int8":
        return qsgd_int8_fused(vec, noise), residual
    raise ValueError(f"unknown compression {name!r}")
