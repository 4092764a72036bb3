"""Anomaly-detection defenses: FoolsGold, the three-sigma family, outlier
detection, residual reweighting, cross-round consistency (the port of
``fedml_tpu/trust/defense/anomaly.py``).

Reference: ``core/security/defense/foolsgold_defense.py``,
``three_sigma_defense.py`` (+ ``three_sigma_geomedian_defense.py``,
``three_sigma_krum_defense.py``), ``outlier_detection.py``,
``residual_reweight*``, ``crossround_defense.py``.  Each is vectorised over
the ``(m, d)`` update matrix on its device; the keep masks and
cross-round's "never discard everyone" are ``torch.where`` on the device (no
host sync in the round).
"""

from __future__ import annotations

import torch

from .base import Defense, full_f32_matmul, median0, row_norms, scalar, vec_norm


def _std(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.std`` (population): ``sqrt(mean((x - mean(x))^2))``."""
    if dim is None:
        c = x - torch.mean(x)
        return torch.sqrt(torch.mean(c * c))
    c = x - torch.mean(x, dim=dim, keepdim=True)
    return torch.sqrt(torch.mean(c * c, dim=dim, keepdim=keepdim))


class FoolsGoldDefense(Defense):
    """FoolsGold: down-weight clients whose updates are too similar
    (sybils); the reference's stateless variant over the current round
    (``foolsgold_defense.py:fools_gold_score``: cosine sims, the max
    similarity a client, pardoning, clamp, logit)."""

    name = "foolsgold"

    def before(self, updates, weights, global_flat):
        m = updates.shape[0]
        un = updates / torch.clamp_min(row_norms(updates, keepdim=True), 1e-12)
        with full_f32_matmul():
            cs = un @ un.T - torch.eye(m, dtype=un.dtype, device=un.device)
        v = torch.max(cs, dim=1).values  # max similarity a client
        # pardoning: scale cs rows by the v_i / v_j asymmetry
        cs = cs * torch.clamp(v[:, None] / torch.clamp_min(v[None, :], 1e-12), max=1.0)
        alpha = 1.0 - torch.max(cs, dim=1).values
        alpha = alpha / torch.clamp_min(torch.max(alpha), 1e-12)
        alpha = torch.clamp(alpha, 1e-6, 1 - 1e-6)
        wv = torch.log(alpha / (1 - alpha)) + 0.5
        return updates, weights * torch.clamp(wv, 0.0, 1.0)


class ThreeSigmaDefense(Defense):
    """3-sigma: score clients by distance to a robust center (coordinate
    median); zero-weight those beyond k sigma (three_sigma_defense.py)."""

    name = "three_sigma"

    def __init__(self, cfg=None, k: float = 3.0):
        super().__init__(cfg)
        self.k = getattr(cfg, "outlier_detection_k", k) if cfg else k

    def center(self, updates, weights):
        return median0(updates)

    def before(self, updates, weights, global_flat):
        c = self.center(updates, weights)
        d = row_norms(updates - c[None, :])
        mu, sigma = torch.mean(d), _std(d) + 1e-12
        keep = (d <= mu + self.k * sigma).to(torch.float32)
        return updates, weights * keep


class ThreeSigmaGeoMedianDefense(ThreeSigmaDefense):
    """Scored against the geometric median (three_sigma_geomedian)."""

    name = "three_sigma_geomedian"

    def center(self, updates, weights, iters: int = 8):
        m = updates.shape[0]
        w = torch.ones(m, dtype=torch.float32, device=updates.device) / scalar(updates, m)
        z = w @ updates
        for _ in range(iters):
            dist = torch.sqrt(torch.sum((updates - z[None, :]) ** 2, dim=1) + 1e-6)
            a = w / dist
            a = a / torch.clamp_min(a.sum(), 1e-12)
            z = a @ updates
        return z


class ThreeSigmaKrumDefense(ThreeSigmaDefense):
    """Scored against the Krum-selected client (three_sigma_krum)."""

    name = "three_sigma_krum"

    def center(self, updates, weights):
        from .robust_agg import krum_scores

        best = torch.argmin(krum_scores(updates, byzantine_num=1))
        return updates.index_select(0, best.view(1))[0]


class OutlierDetectionDefense(Defense):
    """Per-coordinate z-score outlier masking (outlier_detection.py): entries
    more than k sigma from the coordinate mean take the coordinate median."""

    name = "outlier_detection"

    def __init__(self, cfg=None, k: float = 3.0):
        super().__init__(cfg)
        self.k = getattr(cfg, "outlier_detection_k", k) if cfg else k

    def before(self, updates, weights, global_flat):
        mu = torch.mean(updates, dim=0, keepdim=True)
        sd = _std(updates, dim=0, keepdim=True) + 1e-12
        med = median0(updates, keepdim=True)
        mask = torch.abs(updates - mu) <= self.k * sd
        return torch.where(mask, updates, med), weights


class ResidualReweightDefense(Defense):
    """IRLS residual-based reweighting: weight clients by a Huber-style
    function of their residual to the coordinate median."""

    name = "residual_reweight"

    def __init__(self, cfg=None, delta: float = 1.0):
        super().__init__(cfg)
        self.delta = delta

    def before(self, updates, weights, global_flat):
        r = row_norms(updates - median0(updates)[None, :])
        r = r / torch.clamp_min(median0(r), 1e-12)
        delta = scalar(r, self.delta)
        wgt = torch.where(r <= delta, scalar(r, 1.0), delta / r)
        return updates, weights * wgt


class CrossRoundDefense(Defense):
    """Cross-round consistency (crossround_defense.py): down-weight clients
    whose update direction has a negative cosine to the last round's global
    delta (the history the engine threads, :meth:`set_history`)."""

    name = "cross_round"

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self._prev_delta = None

    def set_history(self, prev_delta_flat):
        self._prev_delta = prev_delta_flat

    def before(self, updates, weights, global_flat):
        if self._prev_delta is None:
            return updates, weights
        delta = updates - global_flat[None, :]
        pd = self._prev_delta / torch.clamp_min(vec_norm(self._prev_delta), 1e-12)
        cos = (delta @ pd) / torch.clamp_min(row_norms(delta), 1e-12)
        keep = (cos >= 0.0).to(torch.float32)
        # never discard everyone
        keep = torch.where(keep.sum() > 0, keep, torch.ones_like(keep))
        return updates, weights * keep
