"""Differential privacy: calibration, clipping, the LDP / CDP / NbAFL facade
and the draws (the port of ``fedml_tpu/trust/dp/dp.py``).

Torch on the tensor's device.  Every Gaussian draw added to a vector goes
through the CUDA kernel of ``ops/noise.py`` (``x + noise * sigma``, the
TPU's ``_noise_kernel``); it has four sites in the simulator's trust
pipeline and one in cross-silo SecAgg:

- local DP: the (m, d) matrix of client updates in one launch on the
  flattened matrix, the m clients' draws laid end to end
  (:meth:`FedMLDifferentialPrivacy.add_local_noise`, ``trust/pipeline.py``);
- central DP: the global after aggregation, and Shamir SecAgg's aggregate at
  finalize (:meth:`FedMLDifferentialPrivacy.add_global_noise`);
- ``weak_dp``: each clipped update (``trust/defense/clipping.py``);
- ``crfl``: the clipped global (same file).

Laplace goes through its plain ``x + noise * scale`` (no TPU kernel computes
it).  The draws are explicit arguments from a sampler object
(:class:`NoiseSampler` by default), so tests can hand in the reference's.
"""

from __future__ import annotations

import math

import torch

from ...core import rng
from ...ops import noise as noise_ops

#: fold tags of the DP, attack and defense streams: the reference folds each
#: into the round key (central DP 0xCD9, local DP 0x1D9, the model attack's
#: draw 0xA77, a defense's 0xDEF)
CDP_NOISE_TAG = 0xCD9
LDP_NOISE_TAG = 0x1D9
ATTACK_TAG = 0xA77
DEFENSE_TAG = 0xDEF


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


def laplace_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Laplace(0, 1) by inversion of ``u ~ U[0, 1)``, as
    ``jax.random.laplace`` draws it (``u`` moved to ``(-1, 1)``)."""
    u = torch.clamp_min(u * 2.0 - 1.0, -1.0 + 2.0**-24)
    return -torch.sign(u) * torch.log1p(-u.abs())


class NoiseSampler:
    """The default source of the DP, attack and defense draws: one stream a
    round and tag, keyed ``fold_in(round_key(root, r), tag)`` as in the
    reference, drawn on ``device`` with the port's generators
    (``core/rng.py``).  A test hands in one that returns the reference's
    draws for the same calls."""

    def __init__(self, seed: int):
        self.root = rng.root_key(seed)

    def _generator(self, round_idx: int, device, tag: int = CDP_NOISE_TAG) -> torch.Generator:
        return rng.generator(rng.fold_in(rng.round_key(self.root, round_idx), tag), device)

    def _draw(self, round_idx: int, tag: int, kind: str, shape: tuple, device) -> torch.Tensor:
        g = self._generator(round_idx, device, tag)
        if kind == "gaussian":
            return torch.randn(shape, generator=g, device=device)
        return laplace_from_uniform(torch.rand(shape, generator=g, device=device))

    def gaussian(self, round_idx: int, shape: tuple, device) -> torch.Tensor:
        """Central DP's N(0, 1) draw."""
        return self._draw(round_idx, CDP_NOISE_TAG, "gaussian", shape, device)

    def laplace(self, round_idx: int, shape: tuple, device) -> torch.Tensor:
        """Central DP's Laplace(0, 1) draw."""
        return self._draw(round_idx, CDP_NOISE_TAG, "laplace", shape, device)

    def local(self, round_idx: int, kind: str, m: int, d: int, device) -> torch.Tensor:
        """Local DP's draws of ``m`` clients' ``d``-vectors laid end to end,
        flat ``(m * d,)``; ``kind`` is ``"gaussian"`` or ``"laplace"`` (the
        reference draws client ``i``'s row from the ``i``-th key of
        ``split(fold_in(round key, 0x1D9), m)``)."""
        return self._draw(round_idx, LDP_NOISE_TAG, kind, (m * d,), device)

    def attack(self, round_idx: int, shape: tuple, device) -> torch.Tensor:
        """The model attack's N(0, 1) draw (``byzantine_random``)."""
        return self._draw(round_idx, ATTACK_TAG, "gaussian", shape, device)

    def defense(self, round_idx: int, kind: str, shape: tuple, device) -> torch.Tensor:
        """A defense's draw: N(0, 1) (``weak_dp``, ``crfl``) or Laplace(0,
        1) (``wbc``)."""
        return self._draw(round_idx, DEFENSE_TAG, kind, shape, device)


class FedMLDifferentialPrivacy:
    """Facade with the reference's API shape (is_ldp_enabled /
    is_cdp_enabled / add_local_noise / add_global_noise / global_clip); the
    noise is the caller's draw of :attr:`mechanism`'s kind."""

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

    def _noise(self, flat: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if self.mechanism == "gaussian":
            return noise_ops.apply_gaussian_noise(flat, noise, self.sigma())
        return add_laplace_noise(flat, noise, laplace_scale(self.epsilon, self.sensitivity))

    def add_local_noise(self, updates: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """LDP (reference ldp.py, vmapped over the clients): every row of the
        ``(m, d)`` matrix plus its client's draw, ``noise`` the ``m`` draws
        laid end to end ``(m * d,)``; Gaussian in one launch of the noise
        kernel on the flattened matrix."""
        m, d = updates.shape
        return self._noise(updates.reshape(-1), noise.reshape(-1)).view(m, d)

    def add_global_noise(self, global_flat: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """CDP: noise on the aggregate (reference cdp.py / NbAFL down-link)."""
        return self._noise(global_flat, noise.reshape(-1))

    def global_clip(self, delta_flat: torch.Tensor) -> torch.Tensor:
        return clip_by_norm(delta_flat, self.clipping_norm)


def nbafl_uplink_sigma(clip: float, n_local: int, epsilon: float, delta: float) -> float:
    """NbAFL (Wei et al., frames/NbAFL.py) up-link sigma_u = c*C*L/(n*eps)
    with c = sqrt(2 ln(1.25/delta)); L=1 exposure per round."""
    c = math.sqrt(2.0 * math.log(1.25 / delta))
    return c * clip / max(n_local, 1) / epsilon


def nbafl_downlink_sigma(clip: float, n_clients: int, rounds: int, epsilon: float,
                         delta: float) -> float:
    """NbAFL down-link sigma_d; zero when rounds <= sqrt(N) (paper Thm 2)."""
    if rounds <= math.sqrt(n_clients):
        return 0.0
    c = math.sqrt(2.0 * math.log(1.25 / delta))
    return 2.0 * c * clip * math.sqrt(rounds**2 - n_clients) / (max(n_clients, 1) * epsilon)
