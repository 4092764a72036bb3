"""Optimizers over trees of tensors: the port of the optax transformations
the JAX package builds (``fedml_tpu/fl/local_sgd.py`` ``make_optimizer``,
``fedml_tpu/fl/algorithm.py`` ``make_server_optimizer``).

Each has ``init(params, lanes=None) -> state`` and ``update(grads, state,
params) -> (new_params, new_state)`` (optax's ``update`` then
``apply_updates``), with optax 0.2.6's order of operations, one rounding
an operation:

- :class:`SGD`: ``chain(add_decayed_weights(wd), sgd(lr, momentum))``;
- :class:`Adam`: ``scale_by_adam(b1, b2, eps)``, then
  ``add_decayed_weights(wd)`` when ``wd`` is given (``adamw``, and
  :func:`adamw` with optax's defaults), then ``scale_by_learning_rate(lr)``;
- :class:`Adagrad`: ``adagrad(lr)``; :class:`Yogi`: ``yogi(lr)``.

The bias correction ``1 - b ** count`` is computed in f32 from an int32
count, as optax does.  ``lanes=L`` gives a state for ``L`` lane-stacked
trees (the batched local step): the count becomes an ``(L,)`` tensor and
each lane's bias correction its own, so a lane that stops updating keeps
its count and moments.

Under ``jax.jit`` XLA:CPU may contract ``a * b + c`` into one FMA (the
moments, the step ``p + u * (-lr)``); optax called eagerly does not, and
this module rounds as the eager optax does (``tests/test_torch_algorithms.py``
holds it bitwise there).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core import pytree as pt


def _count(params, lanes: Optional[int]) -> torch.Tensor:
    device = pt.tree_leaves(params)[0].device
    return torch.zeros(() if lanes is None else (lanes,), dtype=torch.int32, device=device)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax ``1 - decay ** count`` in f32 (``count`` int32, 0-d or per lane)."""
    return 1 - torch.pow(count.new_full((), decay, dtype=torch.float32), count.to(torch.float32))


def _corrected(mu, nu, b1: float, b2: float, eps: float, count: torch.Tensor):
    """The bias-corrected step of adam and yogi: ``mu_hat / (sqrt(nu_hat) +
    eps)``."""
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    return pt.tree_map(
        lambda m, v: (m / pt.per_lane(bc1, m)) / (torch.sqrt(v / pt.per_lane(bc2, v)) + eps),
        mu, nu)


def _step(params, updates, lr: float):
    """``scale_by_learning_rate(lr)`` then ``apply_updates``."""
    return pt.tree_map(lambda p, u: p + u * (-lr), params, updates)


class SGD:
    """optax ``chain(add_decayed_weights(wd), sgd(lr, momentum))`` over a
    params tree: ``g += wd * p``; ``t = g + momentum * t``; ``p += -lr * t``."""

    def __init__(self, learning_rate: float, momentum: float = 0.0, weight_decay: float = 0.0):
        self.lr = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params, lanes: Optional[int] = None) -> Any:
        return pt.tree_map(torch.zeros_like, params) if self.momentum else None

    @torch.no_grad()
    def update(self, grads, state, params):
        if self.weight_decay:
            grads = pt.tree_map(lambda g, p: g + self.weight_decay * p, grads, params)
        if self.momentum:
            state = pt.tree_map(lambda g, t: g + self.momentum * t, grads, state)
            grads = state
        return _step(params, grads, self.lr), state


class Adam:
    """optax ``adam(lr, b1, b2, eps)``, or with ``weight_decay`` set
    ``adamw(lr, b1, b2, eps, weight_decay=wd)``.  State ``{"count", "mu",
    "nu"}``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params, lanes: Optional[int] = None) -> dict:
        return {"count": _count(params, lanes), "mu": pt.tree_zeros_like(params),
                "nu": pt.tree_zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        b1, b2 = self.b1, self.b2
        mu = pt.tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state["mu"])
        nu = pt.tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads, state["nu"])
        count = state["count"] + 1
        updates = _corrected(mu, nu, b1, b2, self.eps, count)
        if self.weight_decay is not None:
            updates = pt.tree_map(lambda u, p: u + self.weight_decay * p, updates, params)
        return _step(params, updates, self.lr), {"count": count, "mu": mu, "nu": nu}


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Adam:
    """optax ``adamw(lr)`` with its defaults: ``scale_by_adam``, then
    ``add_decayed_weights(1e-4)`` on every leaf, then ``-lr``."""
    return Adam(learning_rate, b1, b2, eps, weight_decay=weight_decay)


class Adagrad:
    """optax ``adagrad(lr)``: initial accumulator 0.1, eps 1e-7.  State: the
    sum of squares."""

    def __init__(self, learning_rate: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        self.lr, self.init_value, self.eps = learning_rate, initial_accumulator_value, eps

    def init(self, params, lanes: Optional[int] = None):
        return pt.tree_map(lambda p: torch.full_like(p, self.init_value), params)

    @torch.no_grad()
    def update(self, grads, state, params):
        sos = pt.tree_map(lambda g, t: g * g + t, grads, state)
        updates = pt.tree_map(
            lambda t, g: torch.where(t > 0, torch.rsqrt(t + self.eps), 0.0) * g, sos, grads)
        return _step(params, updates, self.lr), sos


class Yogi:
    """optax ``yogi(lr)``: b1 0.9, b2 0.999, eps 1e-3, initial accumulators
    1e-6; the second moment ``nu - (1 - b2) * sign(nu - g^2) * g^2``.
    State ``{"count", "mu", "nu"}``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-3, initial_accumulator_value: float = 1e-6):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.init_value = initial_accumulator_value

    def init(self, params, lanes: Optional[int] = None) -> dict:
        def full(p):
            return torch.full_like(p, self.init_value)

        return {"count": _count(params, lanes), "mu": pt.tree_map(full, params),
                "nu": pt.tree_map(full, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        b1, b2 = self.b1, self.b2
        mu = pt.tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state["mu"])
        nu = pt.tree_map(lambda g, v: v - (1 - b2) * torch.sign(v - g * g) * (g * g), grads,
                         state["nu"])
        count = state["count"] + 1
        updates = _corrected(mu, nu, b1, b2, self.eps, count)
        return _step(params, updates, self.lr), {"count": count, "mu": mu, "nu": nu}
