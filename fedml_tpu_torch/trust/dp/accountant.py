"""RDP budget accountant.

The port of ``fedml_tpu/trust/dp/accountant.py`` (numpy, a copy: the
port imports nothing of the JAX package).  Parity with
``core/dp/budget_accountant/rdp_accountant.py`` (the standard
moments-accountant math from Abadi et al. / Mironov): compute Renyi-DP of the
subsampled Gaussian mechanism at a grid of orders, compose across rounds, and
convert to (epsilon, delta)-DP.  Pure numpy (host-side bookkeeping).
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_ORDERS = tuple([1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 16.0, 32.0, 64.0] + list(range(2, 64)))


def _log_add(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    return max(a, b) + math.log1p(math.exp(-abs(a - b)))


def _compute_log_a_int(q: float, sigma: float, alpha: int) -> float:
    """RDP of subsampled Gaussian for integer alpha (binomial expansion)."""
    log_a = -np.inf
    for i in range(alpha + 1):
        log_coef = (
            math.lgamma(alpha + 1) - math.lgamma(i + 1) - math.lgamma(alpha - i + 1)
            + i * math.log(q) + (alpha - i) * math.log(1 - q)
        )
        log_term = log_coef + (i * i - i) / (2.0 * sigma**2)
        log_a = _log_add(log_a, log_term)
    return log_a


def compute_rdp(q: float, noise_multiplier: float, steps: int, orders=DEFAULT_ORDERS) -> np.ndarray:
    """RDP epsilon at each order for `steps` compositions of the subsampled
    Gaussian with sampling rate q and noise multiplier sigma."""
    rdp = []
    for a in orders:
        if q == 0:
            rdp.append(0.0)
        elif q == 1.0:
            rdp.append(a / (2.0 * noise_multiplier**2))
        elif float(a).is_integer():
            rdp.append(_compute_log_a_int(q, noise_multiplier, int(a)) / (a - 1))
        else:
            # fractional orders: conservative bound via floor/ceil interpolation
            lo = _compute_log_a_int(q, noise_multiplier, int(math.floor(a)))
            hi = _compute_log_a_int(q, noise_multiplier, int(math.ceil(a)))
            rdp.append(max(lo, hi) / (a - 1))
    return np.array(rdp) * steps


def get_privacy_spent(orders, rdp: np.ndarray, delta: float) -> tuple[float, float]:
    """Convert composed RDP to (epsilon, best_order) at target delta."""
    orders = np.asarray(orders, dtype=float)
    eps = rdp - math.log(delta) / (orders - 1)
    idx = int(np.argmin(eps))
    return float(eps[idx]), float(orders[idx])


class RDPAccountant:
    """Stateful accountant (reference class shape): ``step()`` per round,
    ``get_epsilon(delta)`` any time."""

    def __init__(self, q: float, noise_multiplier: float, orders=DEFAULT_ORDERS):
        self.q = q
        self.noise_multiplier = noise_multiplier
        self.orders = orders
        self.steps = 0

    def step(self, n: int = 1) -> None:
        self.steps += n

    def get_epsilon(self, delta: float) -> float:
        if self.steps == 0:
            return 0.0
        rdp = compute_rdp(self.q, self.noise_multiplier, self.steps, self.orders)
        eps, _ = get_privacy_spent(self.orders, rdp, delta)
        return eps
