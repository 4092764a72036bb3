"""Client contribution assessment (the port of
``fedml_tpu/trust/contribution.py``).

Parity with ``core/contribution/``: ``ContributionAssessorManager``
(``contribution_assessor_manager.py:9``), ``gtg_shapley_value.py`` (GTG
Shapley: truncated Monte-Carlo over permutations of the clients within a
round) and ``leave_one_out.py``.

``eval_fn(agg_vars) -> float`` scores a candidate model (test accuracy);
candidates are weighted means of client-contribution subsets, built with the
same ``tree_weighted_mean`` as the aggregation, on the contributions'
device.  The permutations come from numpy's ``RandomState(seed)``, as in the
reference, so the coalitions walked are the reference's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import pytree as pt


def _subset_model(stacked_contribs, weights: np.ndarray, mask: np.ndarray, empty_model=None):
    """Aggregate of the masked coalition; the empty coalition is the
    pre-round global model (``empty_model``): the weighted mean normalises
    its weights, so a near-zero mask would reproduce the full model."""
    if mask.sum() == 0:
        if empty_model is None:
            raise ValueError("empty coalition requires empty_model")
        return empty_model
    device = pt.tree_leaves(stacked_contribs)[0].device
    w = torch.as_tensor(np.asarray(weights * mask, np.float32), device=device)
    return pt.tree_weighted_mean(stacked_contribs, w)


def leave_one_out(stacked_contribs, weights: np.ndarray, eval_fn: Callable,
                  empty_model=None) -> np.ndarray:
    """v(all) - v(all \\ {i}) per client (leave_one_out.py)."""
    m = len(weights)
    full = float(eval_fn(_subset_model(stacked_contribs, weights, np.ones(m))))
    scores = np.zeros(m)
    for i in range(m):
        mask = np.ones(m)
        mask[i] = 0.0
        scores[i] = full - float(eval_fn(_subset_model(stacked_contribs, weights, mask,
                                                       empty_model)))
    return scores


def gtg_shapley(stacked_contribs, weights: np.ndarray, eval_fn: Callable, empty_model,
                rounds_cap: int = 20, eps: float = 1e-3, seed: int = 0) -> np.ndarray:
    """Truncated Monte-Carlo Shapley (gtg_shapley_value.py): sample client
    permutations, walk marginal contributions, truncate a walk once the
    running value is within eps of the full coalition's; stop when the
    estimate settles or after ``rounds_cap`` permutations.  ``empty_model``
    is the pre-round global: v(empty coalition)."""
    rng = np.random.RandomState(seed)
    m = len(weights)
    v_full = float(eval_fn(_subset_model(stacked_contribs, weights, np.ones(m))))
    v_empty = float(eval_fn(empty_model))
    shap = np.zeros(m)
    count = np.zeros(m)
    prev_est = None
    for _ in range(rounds_cap):
        perm = rng.permutation(m)
        mask = np.zeros(m)
        v_prev = v_empty
        for i in perm:
            if abs(v_full - v_prev) < eps:  # truncation: the rest contribute ~0
                marginal = 0.0
                v_curr = v_prev
            else:
                mask[i] = 1.0
                v_curr = float(eval_fn(_subset_model(stacked_contribs, weights, mask,
                                                     empty_model)))
                marginal = v_curr - v_prev
            shap[i] += marginal
            count[i] += 1
            v_prev = v_curr
        est = shap / np.maximum(count, 1)
        if prev_est is not None and np.max(np.abs(est - prev_est)) < eps / 10:
            break
        prev_est = est
    return shap / np.maximum(count, 1)


class ContributionAssessorManager:
    """Facade with the reference's shape: built from config, runs the chosen
    method after the last round."""

    def __init__(self, cfg):
        self.enabled = bool(getattr(cfg, "enable_contribution", False))
        self.method = getattr(cfg, "contribution_method", "gtg_shapley")

    def assess(self, stacked_contribs, weights, eval_fn, empty_model=None) -> np.ndarray:
        w = np.asarray(weights, dtype=np.float64)
        if self.method in ("gtg_shapley", "GTG"):
            return gtg_shapley(stacked_contribs, w, eval_fn, empty_model)
        if self.method in ("leave_one_out", "LOO"):
            return leave_one_out(stacked_contribs, w, eval_fn, empty_model)
        raise ValueError(f"unknown contribution_method {self.method!r}")
