"""Defense frame (the port of ``fedml_tpu/trust/defense/base.py``).

Reference: ``FedMLDefender`` (``core/security/fedml_defender.py:40``) threads
every defense through three hooks around aggregation
(``defend_before_aggregation`` / ``defend_on_aggregation`` /
``defend_after_aggregation``).  As in the JAX package, the hooks are
functions over the stacked client-update matrix ``(m, d)`` (each row the
reference's flat vector of one client, ``core.pytree.stacked_tree_to_matrix``)
on its device: pairwise-distance defenses (Krum, Bulyan) are one Gram matmul,
and a selection is a 0/1 weight mask that stays on the device (no host sync
in the round).

Weight semantics: a defense discards client i by zeroing its weight; the
weighted mean downstream then ignores it, and shapes stay static.

The helpers here reproduce the reference's numerics where torch's own
functions differ: :func:`median0` is ``jnp.median``'s midpoint of the two
middle values for an even count (``torch.median`` returns the lower one),
:func:`percentile_rows` is ``jnp.percentile``'s linear interpolation by
selection (``torch.quantile`` refuses inputs over 2**24 elements),
:func:`smallest_first` is ``lax.top_k``'s lower-index-first order on ties
(a stable sort), and :func:`full_f32_matmul` keeps a Gram matrix out of
TF32 on the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch


class Defense:
    """Base: identity at all three hooks.  Subclasses override any subset.

    ``before`` may modify updates and/or weights; ``on_agg`` may replace the
    aggregation (returns the aggregated flat vector); ``after`` may
    post-process the new global.  A defense that draws noise takes its draw
    from the callable the pipeline installs with :meth:`set_draw`
    (``draw(kind, shape)``, ``kind`` ``"gaussian"`` or ``"laplace"``): the
    reference's ``set_key``.
    """

    name = "identity"

    def __init__(self, cfg=None):
        self.cfg = cfg
        self._draw: Optional[Callable] = None

    def before(self, updates: torch.Tensor, weights: torch.Tensor, global_flat: torch.Tensor):
        """(m, d) updates, (m,) weights -> same shapes."""
        return updates, weights

    def on_agg(self, updates: torch.Tensor, weights: torch.Tensor,
               global_flat: torch.Tensor) -> Optional[torch.Tensor]:
        """Return the (d,) aggregate to REPLACE the weighted mean, or None."""
        return None

    def after(self, new_global_flat: torch.Tensor, old_global_flat: torch.Tensor) -> torch.Tensor:
        return new_global_flat


class DrawingDefense(Defense):
    """A defense that takes a random draw each round (the reference's
    ``set_key`` family)."""

    def set_draw(self, draw: Callable) -> None:
        self._draw = draw

    def draw(self, kind: str, shape: tuple) -> torch.Tensor:
        if self._draw is None:
            raise RuntimeError(f"defense {self.name!r} draws noise: the pipeline sets its "
                               "draw before the hooks run")
        return self._draw(kind, shape)


def scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device: arithmetic with
    it rounds as the reference's (a Python number on the left of ``/``
    becomes a reciprocal and a multiply in PyTorch)."""
    return like.new_full((), value, dtype=torch.float32)


def clip_scale(norms: torch.Tensor, bound: float) -> torch.Tensor:
    """``min(1, bound / max(norms, 1e-12))`` with an IEEE division."""
    return torch.clamp(scalar(norms, bound) / torch.clamp_min(norms, 1e-12), max=1.0)


def row_norms(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=1)``: ``sqrt(sum(x * x))`` per row."""
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=keepdim))


def vec_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def weighted_mean(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    w = weights / torch.clamp_min(weights.sum(), 1e-12)
    return w @ updates


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls in full f32 (no TF32) inside the block, whatever the
    process set: a Gram matrix decides selections."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def pairwise_sq_dists(u: torch.Tensor) -> torch.Tensor:
    """(m, d) -> (m, m) squared euclidean distances, via one Gram matmul
    (``|a|^2 + |b|^2 - 2 ab``, clamped at 0), TF32 off."""
    sq = torch.sum(u * u, dim=1)
    with full_f32_matmul():
        g = u @ u.T
    d2 = sq[:, None] + sq[None, :] - 2.0 * g
    return torch.clamp_min(d2, 0.0)


def smallest_first(x: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """Indices of the ``k`` smallest values along ``dim``, smallest first,
    the lower index first among equal values: ``lax.top_k(-x, k)``'s
    indices (``torch.topk`` promises no order among ties)."""
    return torch.argsort(x, dim=dim, stable=True).narrow(dim, 0, k)


def median0(u: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median(u, axis=0)``: the middle of the sorted column, for an
    even count ``(lo + hi) * 0.5`` in f32 (JAX's midpoint)."""
    m = u.shape[0]
    s = torch.sort(u, dim=0).values
    lo, hi = (m - 1) // 2, m // 2
    out = (s[lo] + s[hi]) * 0.5
    return out.unsqueeze(0) if keepdim else out


def percentile_rows(x: torch.Tensor, p: float) -> torch.Tensor:
    """``jnp.percentile(x, p, axis=1, keepdims=True)`` (linear method) for
    an f32 ``(m, n)`` matrix, ``(m, 1)``: JAX's arithmetic in f32 (``q = p /
    100``, position ``q * (n - 1)``, ``lo * (1 - w) + hi * w``), the two
    order statistics by selection (``kthvalue``), so any row length
    works."""
    n = x.shape[1]
    last = np.float32(n) - np.float32(1)  # JAX's n - 1, in f32 (2**24 + 1 rounds)
    q = np.float32(p) / np.float32(100) * last
    low, high = np.floor(q), np.ceil(q)
    hw = np.float32(q - low)
    lw = np.float32(np.float32(1) - hw)
    low, high = int(min(max(low, 0), last)), int(min(max(high, 0), last))
    lo_v = torch.kthvalue(x, low + 1, dim=1, keepdim=True).values
    hi_v = lo_v if high == low else torch.kthvalue(x, high + 1, dim=1, keepdim=True).values
    return lo_v * scalar(x, float(lw)) + hi_v * scalar(x, float(hw))
