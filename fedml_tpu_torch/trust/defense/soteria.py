"""Soteria and WBC (the port of ``fedml_tpu/trust/defense/soteria.py``).

Client-side Soteria (reference ``soteria_defense.py:28``): against gradient
leakage, prune the representation coordinates with the smallest
sensitivity ratio ``||d r_f / d x|| / |r_f|``.  :func:`soteria_sensitivity`
takes the whole Jacobian of the flattened features at once
(``torch.autograd.functional.jacobian``, first order, so it also runs
through the fused blocks) and :func:`soteria_mask` prunes below the
``percentile`` (``jnp.percentile``'s linear interpolation,
``base.percentile_rows``).

The aggregation-frame Soteria (:class:`SoteriaDefense`), as the JAX
package adapts it: per client, zero the ``soteria_percentile`` percent smallest-magnitude
coordinates of the update delta (magnitude stands in for the sensitivity
ratio, which needs the client's model and data).  The percentile is
``jnp.percentile``'s linear interpolation over each row
(``base.percentile_rows``: a row of the flagship's matrix holds 271,098
coordinates, the matrix 17,350,272, past ``torch.quantile``'s limit).

WBC (reference ``wbc_defense.py:25``): perturb update coordinates with
Laplace noise wherever the update changed less than the noise since the
previous round, the previous round's global delta standing in for the
history (the engine's defense-history slot).
"""

from __future__ import annotations

import torch

from ...core.flags import cfg_extra
from .base import Defense, DrawingDefense, percentile_rows


def soteria_sensitivity(model, variables, x: torch.Tensor, feature_fn=None) -> torch.Tensor:
    """``(features,)`` sensitivity ``||d r_f / d x|| / max(|r_f|, 1e-12)``
    of one example ``x``.  ``feature_fn(variables, x) -> (batch,
    features)`` defaults to the model's output (``model.apply(...,
    train=False)``), for a model whose output is the representation (LR:
    the logits)."""
    if feature_fn is None:
        def feature_fn(v, xx):
            return model.apply(v, xx, train=False)[0]

    def flat_features(xx):
        return feature_fn(variables, xx[None])[0]

    r = flat_features(x)
    jac = torch.autograd.functional.jacobian(flat_features, x)  # (features, *x.shape)
    grad_norms = torch.sqrt(torch.sum(jac.reshape(jac.shape[0], -1) ** 2, dim=1))
    return grad_norms / torch.clamp(torch.abs(r), min=1e-12)


def soteria_mask(model, variables, x: torch.Tensor, percentile: float = 1.0,
                 feature_fn=None) -> tuple:
    """``(0/1 mask, sensitivity)`` over the features, pruning those below
    the ``percentile``-th percentile of the sensitivity (the reference
    prunes at 1)."""
    sens = soteria_sensitivity(model, variables, x, feature_fn)
    thresh = percentile_rows(sens.detach()[None].to(torch.float32), percentile)[0, 0]
    return (sens >= thresh).to(torch.float32), sens


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
