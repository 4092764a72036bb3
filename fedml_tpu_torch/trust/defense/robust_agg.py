"""Robust aggregation defenses: Krum / MultiKrum, RFA geometric median,
coordinate-wise median, trimmed mean, Bulyan (the port of
``fedml_tpu/trust/defense/robust_agg.py``).

Reference implementations: ``core/security/defense/krum_defense.py``,
``geometric_median_defense.py``, ``coordinate_wise_median_defense.py``,
``coordinate_wise_trimmed_mean_defense.py``, ``bulyan_defense.py``.  Dense
linear algebra over the stacked ``(m, d)`` update matrix on its device:
Krum's pairwise distances are one Gram matmul (TF32 off), its selection a
stable sort into a 0/1 mask (no host sync); the geometric median is a
fixed number of Weiszfeld iterations.
"""

from __future__ import annotations

import torch

from .base import Defense, median0, pairwise_sq_dists, smallest_first


def krum_scores(updates: torch.Tensor, byzantine_num: int) -> torch.Tensor:
    """Krum score: for each client, the sum of its ``m - f - 2`` smallest
    squared distances to the other clients (lower = more central), summed
    smallest first as ``lax.top_k`` returns them."""
    m = updates.shape[0]
    d2 = pairwise_sq_dists(updates)
    d2 = d2 + torch.eye(m, dtype=d2.dtype, device=d2.device) * 1e30  # exclude self
    k = max(1, m - byzantine_num - 2)
    return torch.sort(d2, dim=1).values[:, :k].sum(1)


class KrumDefense(Defense):
    """Krum (``krum_param_m`` = 1) / Multi-Krum (> 1): keep only the m most
    central clients (zero the rest's weights)."""

    name = "krum"

    def __init__(self, cfg=None, byzantine_num: int = 1, select_m: int = 1):
        super().__init__(cfg)
        self.byzantine_num = getattr(cfg, "byzantine_client_num", byzantine_num) if cfg else \
            byzantine_num
        self.select_m = getattr(cfg, "krum_param_m", select_m) if cfg else select_m

    def before(self, updates, weights, global_flat):
        scores = krum_scores(updates, self.byzantine_num)
        m = updates.shape[0]
        best = smallest_first(scores, min(self.select_m, m))
        mask = torch.zeros(m, dtype=torch.float32, device=updates.device).index_fill_(0, best,
                                                                                        1.0)
        return updates, weights * mask


class MultiKrumDefense(KrumDefense):
    name = "multikrum"


class GeometricMedianDefense(Defense):
    """RFA (Pillutla et al.): smoothed Weiszfeld geometric median of client
    updates, weighted by sample counts, a fixed ``iters`` steps."""

    name = "geometric_median"

    def __init__(self, cfg=None, iters: int = 8, eps: float = 1e-6):
        super().__init__(cfg)
        self.iters = iters
        self.eps = eps

    def on_agg(self, updates, weights, global_flat):
        w = weights / torch.clamp_min(weights.sum(), 1e-12)
        z = w @ updates
        for _ in range(self.iters):
            dist = torch.sqrt(torch.sum((updates - z[None, :]) ** 2, dim=1) + self.eps)
            alpha = w / dist
            alpha = alpha / torch.clamp_min(alpha.sum(), 1e-12)
            z = alpha @ updates
        return z


class CoordinateWiseMedianDefense(Defense):
    name = "coordinate_median"

    def on_agg(self, updates, weights, global_flat):
        return median0(updates)


class TrimmedMeanDefense(Defense):
    """Coordinate-wise beta-trimmed mean: drop the beta*m largest and
    smallest per coordinate, average the rest."""

    name = "trimmed_mean"

    def __init__(self, cfg=None, beta: float = 0.1):
        super().__init__(cfg)
        self.beta = getattr(cfg, "trimmed_mean_beta", beta) if cfg else beta

    def on_agg(self, updates, weights, global_flat):
        m = updates.shape[0]
        b = min(int(self.beta * m), (m - 1) // 2)
        if b == 0:
            return torch.mean(updates, dim=0)
        s = torch.sort(updates, dim=0).values
        return torch.mean(s[b:m - b], dim=0)


class BulyanDefense(Defense):
    """Bulyan, the reference's variant: select theta = m - 2f clients by
    Krum score, then the coordinate-wise trimmed mean (trim f) over them."""

    name = "bulyan"

    def __init__(self, cfg=None, byzantine_num: int = 1):
        super().__init__(cfg)
        self.byzantine_num = getattr(cfg, "byzantine_client_num", byzantine_num) if cfg else \
            byzantine_num

    def on_agg(self, updates, weights, global_flat):
        m = updates.shape[0]
        f = self.byzantine_num
        theta = max(1, m - 2 * f)
        best = smallest_first(krum_scores(updates, f), theta)
        sel = updates.index_select(0, best)  # (theta, d), most central first
        b = min(f, (theta - 1) // 2)
        if b == 0:
            return torch.mean(sel, dim=0)
        s = torch.sort(sel, dim=0).values
        return torch.mean(s[b:theta - b], dim=0)

