"""Soteria and WBC in the aggregation frame (the port of the aggregation-frame
defenses of ``fedml_tpu/trust/defense/soteria.py``).

Soteria (reference ``core/security/defense/soteria_defense.py:28``, Sun et
al. CVPR'21), as the JAX package adapts it to the aggregation frame: per
client, zero the ``soteria_percentile`` percent smallest-magnitude
coordinates of the update delta (magnitude stands in for the sensitivity
ratio, which needs the client's model and data).  The percentile is
``jnp.percentile``'s linear interpolation over each row
(``base.percentile_rows``: a row of the flagship's matrix holds 271,098
coordinates, the matrix 17,350,272, past ``torch.quantile``'s limit).

WBC (reference ``wbc_defense.py:25``): perturb update coordinates with
Laplace noise wherever the update changed less than the noise since the
previous round, the previous round's global delta standing in for the
history (the engine's defense-history slot).

The client-side sensitivity functions (``soteria_sensitivity`` /
``soteria_mask``) are not ported here: they need second-order autograd
through a user's model and lie on no round path.
"""

from __future__ import annotations

import torch

from ...core.flags import cfg_extra
from .base import Defense, DrawingDefense, percentile_rows


class SoteriaDefense(Defense):
    name = "soteria"

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self.percentile = float(cfg_extra(cfg, "soteria_percentile"))

    def before(self, updates, weights, global_flat):
        delta = updates - global_flat[None, :]
        mag = torch.abs(delta)
        pruned = torch.where(mag >= percentile_rows(mag, self.percentile), delta,
                             torch.zeros_like(delta))
        return global_flat[None, :] + pruned, weights


class WBCDefense(DrawingDefense):
    name = "wbc"

    def __init__(self, cfg=None):
        super().__init__(cfg)
        self.strength = float(cfg_extra(cfg, "wbc_pert_strength"))
        self.lr = float(cfg_extra(cfg, "wbc_lr"))
        self._prev_delta = None

    def set_history(self, prev_delta_flat):
        self._prev_delta = prev_delta_flat

    def before(self, updates, weights, global_flat):
        delta = updates - global_flat[None, :]
        prev = self._prev_delta if self._prev_delta is not None else torch.zeros_like(global_flat)
        pert = self.draw("laplace", tuple(updates.shape)).view(updates.shape) * self.strength
        # perturb only where the round-over-round change is smaller than the
        # drawn noise (reference: np.where(|grad_diff| > |pert|, 0, pert))
        pert = torch.where(torch.abs(delta - prev[None, :]) > torch.abs(pert),
                           torch.zeros_like(pert), pert)
        return updates + pert * self.lr, weights
