"""Clipping / noise defenses: norm-diff clipping, centered clip, weak DP,
SLSGD, robust learning rate, CRFL (the port of
``fedml_tpu/trust/defense/clipping.py``).

Reference: ``core/security/defense/norm_diff_clipping_defense.py``,
``cclip_defense.py``, ``weak_dp_defense.py``, ``slsgd_defense.py``,
``robust_learning_rate_defense.py``, ``crfl_defense.py``.  ``weak_dp`` and
``crfl`` add their Gaussian draws through the noise kernel
(``ops/noise.py``): ``weak_dp`` over the whole ``(m, d)`` matrix in one
launch, ``crfl`` over the global.
"""

from __future__ import annotations

import torch

from ...ops import noise as noise_ops
from .base import Defense, DrawingDefense, clip_scale, row_norms, scalar, vec_norm, weighted_mean


class NormDiffClippingDefense(Defense):
    """Clip each client's update delta (w_i - w_global) to a norm bound
    (norm_diff_clipping_defense.py)."""

    name = "norm_diff_clipping"

    def __init__(self, cfg=None, norm_bound: float = 5.0):
        super().__init__(cfg)
        self.norm_bound = getattr(cfg, "norm_bound", norm_bound) if cfg else norm_bound

    def before(self, updates, weights, global_flat):
        delta = updates - global_flat[None, :]
        scale = clip_scale(row_norms(delta, keepdim=True), self.norm_bound)
        return global_flat[None, :] + delta * scale, weights


class CClipDefense(Defense):
    """Centered clipping (Karimireddy et al.): clip deltas around the previous
    global model with bound tau, then average (cclip_defense.py)."""

    name = "cclip"

    def __init__(self, cfg=None, tau: float = 10.0):
        super().__init__(cfg)
        self.tau = getattr(cfg, "norm_bound", tau) if cfg else tau

    def on_agg(self, updates, weights, global_flat):
        delta = updates - global_flat[None, :]
        scale = clip_scale(row_norms(delta, keepdim=True), self.tau)
        return global_flat + weighted_mean(delta * scale, weights)


class WeakDPDefense(DrawingDefense):
    """Weak DP: clip, then add small Gaussian noise to each update
    (weak_dp_defense.py), through the noise kernel on the flattened
    matrix."""

    name = "weak_dp"

    def __init__(self, cfg=None, norm_bound: float = 5.0, stddev: float = 0.002):
        super().__init__(cfg)
        self.norm_bound = getattr(cfg, "norm_bound", norm_bound) if cfg else norm_bound
        self.stddev = stddev

    def before(self, updates, weights, global_flat):
        m, d = updates.shape
        delta = updates - global_flat[None, :]
        scale = clip_scale(row_norms(delta, keepdim=True), self.norm_bound)
        clipped = global_flat[None, :] + delta * scale
        noise = self.draw("gaussian", (m, d)).reshape(-1)
        return noise_ops.apply_gaussian_noise(clipped.reshape(-1), noise,
                                              self.stddev).view(m, d), weights


class SLSGDDefense(Defense):
    """SLSGD: trimmed-mean aggregate mixed with the previous global:
    w' = (1-a) w + a agg (slsgd_defense.py)."""

    name = "slsgd"

    def __init__(self, cfg=None, alpha: float = 0.5, trim_b: int = 1):
        super().__init__(cfg)
        self.alpha = alpha
        self.trim_b = trim_b

    def on_agg(self, updates, weights, global_flat):
        m = updates.shape[0]
        b = min(self.trim_b, (m - 1) // 2)
        if b > 0:
            agg = torch.mean(torch.sort(updates, dim=0).values[b:m - b], dim=0)
        else:
            agg = weighted_mean(updates, weights)
        return (1.0 - self.alpha) * global_flat + self.alpha * agg


class RobustLearningRateDefense(Defense):
    """Robust LR (Ozdayi et al.): per coordinate, flip the server lr's sign
    where fewer than ``theta`` clients agree on the update direction
    (robust_learning_rate_defense.py)."""

    name = "robust_learning_rate"

    def __init__(self, cfg=None, theta: int = 1):
        super().__init__(cfg)
        self.theta = theta

    def on_agg(self, updates, weights, global_flat):
        delta = updates - global_flat[None, :]
        sign_sum = torch.abs(torch.sum(torch.sign(delta), dim=0))
        lr_sign = torch.where(sign_sum >= self.theta, scalar(delta, 1.0), scalar(delta, -1.0))
        return global_flat + lr_sign * weighted_mean(delta, weights)


class CRFLDefense(DrawingDefense):
    """CRFL (certified robustness): clip the aggregated global to a norm bound
    and add Gaussian perturbation after aggregation (crfl_defense.py),
    through the noise kernel."""

    name = "crfl"

    def __init__(self, cfg=None, norm_bound: float = 15.0, stddev: float = 0.002):
        super().__init__(cfg)
        self.norm_bound = getattr(cfg, "norm_bound", norm_bound) if cfg else norm_bound
        self.stddev = stddev

    def after(self, new_global_flat, old_global_flat):
        clipped = new_global_flat * clip_scale(vec_norm(new_global_flat), self.norm_bound)
        noise = self.draw("gaussian", tuple(clipped.shape))
        return noise_ops.apply_gaussian_noise(clipped, noise, self.stddev)
