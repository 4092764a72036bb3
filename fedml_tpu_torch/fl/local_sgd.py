"""Local training and evaluation (the port of ``fedml_tpu/fl/local_sgd.py``).

The JAX package runs a client's local SGD as one ``lax.scan`` over
``epochs * steps_per_epoch`` steps; here it is a Python loop of eager steps
on the client's device.  What stays the same:

- batches come from a per-epoch permutation of the full (cyclic-padded)
  shard; step ``s`` of epoch ``e`` slices ``perms[e, start:start+bsz]`` with
  ``start = min(step_in_epoch * bsz, cap - bsz)``;
- ``step_mode="match"``: the reference masks steps ``s >= own_steps``
  (``own_steps = epochs * ceil(count / bsz)``) to no-ops that keep params,
  optimizer state and batch_stats.  Stopping after ``own_steps`` gives the
  same state, so the loop simply ends there; the loss is averaged over the
  active steps;
- the optimizer is optax's ``chain(add_decayed_weights(wd), sgd(lr,
  momentum))``, with the same update order.

Randomness: the permutation table is an explicit ``perms`` argument
(``(epochs, cap)`` ints).  Without it, it is drawn from the client key with
the port's generators; tests pass the reference's table instead.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..core import pytree as pt
from ..core import rng
from .losses import get_loss_fn
from .types import HParams


class SGD:
    """optax ``chain(add_decayed_weights(wd), sgd(lr, momentum))`` over a
    params tree: ``g += wd * p``; ``t = g + momentum * t``; ``p += -lr * t``."""

    def __init__(self, learning_rate: float, momentum: float = 0.0, weight_decay: float = 0.0):
        self.lr = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params) -> Any:
        return pt.tree_map(torch.zeros_like, params) if self.momentum else None

    @torch.no_grad()
    def update(self, grads, state, params):
        """Returns ``(new_params, new_state)``."""
        if self.weight_decay:
            grads = pt.tree_map(lambda g, p: g + self.weight_decay * p, grads, params)
        if self.momentum:
            state = pt.tree_map(lambda g, t: g + self.momentum * t, grads, state)
            grads = state
        new_params = pt.tree_map(lambda p, g: p + g * (-self.lr), params, grads)
        return new_params, state


def make_optimizer(hp: HParams) -> SGD:
    if hp.client_optimizer == "sgd":
        return SGD(hp.learning_rate, hp.momentum, hp.weight_decay)
    if hp.client_optimizer == "adam":
        raise NotImplementedError("client_optimizer 'adam' is not ported yet "
                                  "(first port slice: sgd)")
    raise ValueError(f"unknown client optimizer {hp.client_optimizer!r}")


def split_variables(variables: dict) -> tuple[Any, dict]:
    """Split variables into (params, rest-collections e.g. batch_stats)."""
    return variables["params"], {k: v for k, v in variables.items() if k != "params"}


def epoch_permutations(key: rng.Key, epochs: int, cap: int) -> torch.Tensor:
    """The ``(epochs, cap)`` permutation table drawn from a client key (the
    reference folds ``(key, epoch, 1)``; so does this)."""
    return torch.stack([rng.permutation(rng.fold_in(rng.fold_in(key, e), 1), cap)
                        for e in range(epochs)])


def make_local_train_fn(model, hp: HParams):
    """Build ``local_train(variables, x, y, count, key, perms=None)
    -> (new_variables, metrics)``.  ``x``/``y`` are one client's padded shard
    on the device, ``count`` its true sample count (int)."""
    if hp.steps_per_epoch <= 0:
        raise ValueError(
            "HParams.steps_per_epoch must be positive (got "
            f"{hp.steps_per_epoch}); build it via algorithms.hparams_from_config"
            "(cfg, steps_per_epoch=ceil(capacity/batch)) or the simulator")
    base_loss = get_loss_fn(hp.loss)
    opt = make_optimizer(hp)
    compute_dtype = torch.bfloat16 if hp.compute_dtype == "bfloat16" else torch.float32
    bsz, spe = hp.batch_size, hp.steps_per_epoch
    total_steps = hp.epochs * spe

    def local_train(variables: dict, x: torch.Tensor, y: torch.Tensor, count: int,
                    key: rng.Key, perms: Optional[torch.Tensor] = None):
        params, rest = split_variables(variables)
        cap = x.shape[0]
        if cap < bsz:
            raise ValueError(
                f"client shard capacity {cap} is smaller than batch_size {bsz}; pad "
                "the shard (stack_clients with multiple_of=batch_size) or lower the batch size")
        if perms is None:
            perms = epoch_permutations(key, hp.epochs, cap)
        perms = perms.to(device=x.device, dtype=torch.long)
        own_steps = hp.epochs * ((int(count) + bsz - 1) // bsz)
        n_steps = min(total_steps, own_steps) if hp.step_mode == "match" else total_steps
        opt_state = opt.init(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(n_steps):
            epoch, step_in_epoch = divmod(s, spe)
            start = min(step_in_epoch * bsz, cap - bsz)
            idx = perms[epoch, start:start + bsz]
            bx, by = x.index_select(0, idx), y.index_select(0, idx)
            if bx.is_floating_point():
                bx = bx.to(compute_dtype)
            leaves = [p.detach().requires_grad_(True) for p in pt.tree_leaves(params)]
            p = pt.tree_unflatten_like(params, leaves)
            logits, new_stats = model.apply({"params": p, **rest}, bx, train=True)
            loss = base_loss(logits.to(torch.float32), by)
            grads = pt.tree_unflatten_like(params, torch.autograd.grad(loss, leaves))
            params, opt_state = opt.update(grads, opt_state, params)
            rest = {**rest, "batch_stats": new_stats} if "batch_stats" in rest else rest
            loss_sum = loss_sum + loss.detach()
        n_active = max(n_steps, 1)
        metrics = {
            "train_loss": loss_sum / n_active,
            "num_steps": float(n_active),
            "num_samples": float(count),
        }
        return {"params": params, **rest}, metrics

    return local_train


def make_full_grad_fn(model, hp: HParams):
    """Build ``full_grad(variables, x, y) -> grads``: the gradient of the
    mean loss over a client's whole cyclic-padded shard at fixed variables
    (the FedSGD client step; reference L203).  The mean runs over the
    ``cap // batch_size`` consecutive batches of the padded capacity, not
    over the true count; each batch runs in train mode (batch statistics)
    and its new running stats are thrown away.  ``x`` is used as given (no
    cast: the simulator keeps it in the compute dtype)."""
    base_loss = get_loss_fn(hp.loss)
    bsz = hp.batch_size

    def full_grad(variables: dict, x: torch.Tensor, y: torch.Tensor):
        params, rest = split_variables(variables)
        n_batches = x.shape[0] // bsz
        leaves = [p.detach().requires_grad_(True) for p in pt.tree_leaves(params)]
        p = pt.tree_unflatten_like(params, leaves)
        acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        for i in range(n_batches):
            logits, _ = model.apply({"params": p, **rest}, x[i * bsz:(i + 1) * bsz], train=True)
            loss = base_loss(logits.to(torch.float32), y[i * bsz:(i + 1) * bsz])
            acc = [a + g for a, g in zip(acc, torch.autograd.grad(loss, leaves))]
        denom = acc[0].new_full((), float(max(n_batches, 1)))
        return pt.tree_unflatten_like(params, [a / denom for a in acc])

    return full_grad


def make_eval_fn(model, hp: HParams, batch_size: int = 256):
    """Global test eval over a (padded) test set with a validity mask;
    returns ``{"test_loss", "test_acc"}`` as 0-d tensors."""

    @torch.no_grad()
    def eval_fn(variables: dict, x: torch.Tensor, y: torch.Tensor, n_valid: int):
        n_batches = x.shape[0] // batch_size
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        correct = torch.zeros((), dtype=torch.float32, device=x.device)
        pos = torch.arange(batch_size, device=x.device)
        for i in range(n_batches):
            bx = x[i * batch_size:(i + 1) * batch_size]
            by = y[i * batch_size:(i + 1) * batch_size].long()
            mask = (pos + i * batch_size < n_valid).to(torch.float32)
            logits, _ = model.apply(variables, bx, train=False)
            logits = logits.to(torch.float32)
            per = F.cross_entropy(logits, by, reduction="none")
            ok = (logits.argmax(-1) == by).to(torch.float32)
            loss_sum = loss_sum + (per * mask).sum()
            correct = correct + (ok * mask).sum()
        seen = float(max(min(n_valid, n_batches * batch_size), 1))
        return {"test_loss": loss_sum / seen, "test_acc": correct / seen}

    return eval_fn
