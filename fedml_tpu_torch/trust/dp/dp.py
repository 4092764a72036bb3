"""Differential privacy: calibration, clipping and the central-DP facade
(the port of ``fedml_tpu/trust/dp/dp.py``).

Torch on the tensor's device.  Central DP on the cross-silo path adds its
noise once, to the aggregate: the Gaussian draw goes through the CUDA kernel
of ``ops/noise.py``, Laplace through its plain ``x + noise * scale`` (no TPU
kernel computes it).  The draws are explicit arguments from a sampler
object (:class:`NoiseSampler` by default), so tests can hand in the
reference's.
"""

from __future__ import annotations

import math

import torch

from ...core import rng

#: fold tag of the central-DP noise stream (the reference folds 0xCD9 into
#: the round key)
CDP_NOISE_TAG = 0xCD9


def gaussian_sigma(epsilon: float, delta: float, sensitivity: float) -> float:
    """Classic Gaussian mechanism: sigma = sqrt(2 ln(1.25/delta)) * S / eps."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / epsilon


def laplace_scale(epsilon: float, sensitivity: float) -> float:
    return sensitivity / epsilon


def clip_by_norm(x: torch.Tensor, clip: float) -> torch.Tensor:
    """``x * min(1, clip / max(||x||, 1e-12))``; the divide is between device
    tensors (IEEE), the norm sums in the device's order."""
    n = torch.linalg.vector_norm(x)
    return x * torch.clamp(n.new_full((), clip) / torch.clamp_min(n, 1e-12), max=1.0)


def add_laplace_noise(x: torch.Tensor, noise: torch.Tensor, scale: float) -> torch.Tensor:
    """``x + noise * scale`` given the Laplace(0, 1) draw ``noise`` (x's
    shape)."""
    return x + noise * x.new_full((), scale)


class NoiseSampler:
    """The default source of the central-DP draws: one stream per round,
    keyed ``fold_in(round_key(root, r), 0xCD9)`` as in the reference, drawn
    on ``device`` with the port's generators (``core/rng.py``)."""

    def __init__(self, seed: int):
        self.root = rng.root_key(seed)

    def _generator(self, round_idx: int, device) -> torch.Generator:
        return rng.generator(rng.fold_in(rng.round_key(self.root, round_idx), CDP_NOISE_TAG),
                             device)

    def gaussian(self, round_idx: int, shape: tuple, device) -> torch.Tensor:
        return torch.randn(shape, generator=self._generator(round_idx, device), device=device)

    def laplace(self, round_idx: int, shape: tuple, device) -> torch.Tensor:
        """Laplace(0, 1) by inversion of ``u ~ U(-1, 1)``, as
        ``jax.random.laplace`` draws it."""
        u = torch.rand(shape, generator=self._generator(round_idx, device), device=device)
        u = torch.clamp_min(u * 2.0 - 1.0, -1.0 + 2.0**-24)
        return -torch.sign(u) * torch.log1p(-u.abs())


class FedMLDifferentialPrivacy:
    """Facade with the reference's API shape (is_ldp_enabled /
    is_cdp_enabled / global_clip); the noise lands where the caller adds
    it."""

    def __init__(self, cfg):
        self.enabled = bool(getattr(cfg, "enable_dp", False))
        self.solution = getattr(cfg, "dp_solution_type", "ldp").lower()
        self.mechanism = getattr(cfg, "mechanism_type", "gaussian").lower()
        self.epsilon = float(getattr(cfg, "epsilon", 1.0))
        self.delta = float(getattr(cfg, "delta", 1e-5))
        self.sensitivity = float(getattr(cfg, "sensitivity", 1.0))
        self.clipping_norm = float(getattr(cfg, "clipping_norm", 1.0))
        if self.mechanism not in ("gaussian", "laplace"):
            raise ValueError(f"unknown mechanism {self.mechanism!r}")

    def is_ldp_enabled(self) -> bool:
        return self.enabled and self.solution in ("ldp", "nbafl")

    def is_cdp_enabled(self) -> bool:
        return self.enabled and self.solution in ("cdp", "nbafl")

    def sigma(self) -> float:
        """The Gaussian mechanism's sigma."""
        return gaussian_sigma(self.epsilon, self.delta, self.sensitivity)

    def global_clip(self, delta_flat: torch.Tensor) -> torch.Tensor:
        return clip_by_norm(delta_flat, self.clipping_norm)
