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
  momentum))`` or ``adamw(lr, weight_decay=wd)``, with the same update
  order (``fl/optim.py``);
- an algorithm customises the step through two hooks, as in the reference:
  ``loss_extra(params, ctx)`` is added to the loss that is differentiated
  (and to the reported ``train_loss``), ``grad_hook(grads, ctx)`` rewrites
  the gradient before the optimizer.  ``ctx`` is the pair ``(shared,
  client)`` that ``FedAlgorithm.make_ctx`` builds.

Randomness: the permutation table is an explicit ``perms`` argument
(``(epochs, cap)`` ints).  Without it, it is drawn from the client key with
the port's generators; tests pass the reference's table instead.  So is a
model's dropout (a model with ``dropout_shape``, ``models/simple.FedAvgCNN``;
the reference folds a dropout key into every step): ``dropout`` is the
client's table of keep-masks, one a step, ``(steps, *dropout_shape(batch))``
bool, drawn from the client key by :func:`dropout_masks` when not given.
Each step passes its mask to ``model.apply(..., dropout=mask)``; a model
without dropout takes none.  The full-gradient pass (FedSGD, Mime) takes its
table the same way, one keep-mask a batch of the shard, ``(cap // batch,
*dropout_shape(batch))`` (the reference folds the batch index into the
client's key, L230).

Lanes (the simulator's MESH round; the reference's ``jax.vmap`` of the
client over the sampled clients): :func:`make_batched_local_train_fn` and
:func:`make_batched_full_grad_fn` run ``L`` clients together, a client a
lane, each step one forward and one backward of the model's lane form
(``models/resnet.py``) for every lane.  Lanes are independent, so the
gradient of the sum of the lanes' losses gives each lane exactly its own
gradient.  There ``loss_extra`` returns one value a lane (added to the
lanes' losses before the sum, so no lane's gradient is scaled), and the
``client`` half of ``ctx`` is lane-stacked: it is put in the lanes' running
order and cut to the active lanes at every step, as the parameters are, and
so is the lanes' dropout table ``(L, steps, ...)``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import pytree as pt
from ..core import rng
from .losses import get_lane_loss_fn, get_loss_fn, sigmoid_binary_cross_entropy
from .optim import SGD, Adam
from .types import HParams


def make_optimizer(hp: HParams):
    """The client optimizer (reference L42): ``sgd`` is optax's
    ``chain(add_decayed_weights(wd), sgd(lr, momentum))``, ``adam`` is
    ``adamw(lr, weight_decay=wd)`` with optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8); both in ``fl/optim.py``."""
    if hp.client_optimizer == "sgd":
        return SGD(hp.learning_rate, hp.momentum, hp.weight_decay)
    if hp.client_optimizer == "adam":
        return Adam(hp.learning_rate, weight_decay=hp.weight_decay)
    raise ValueError(f"unknown client optimizer {hp.client_optimizer!r}")


def step_budgets(hp: HParams, counts) -> np.ndarray:
    """Each client's local step budget from its sample count (host ints):
    ``epochs * ceil(count / batch)`` under ``step_mode`` match (the
    reference's ``own_steps``), ``local_steps`` under fixed."""
    counts = np.asarray(counts, dtype=np.int64)
    if hp.step_mode == "match":
        return hp.epochs * ((counts + hp.batch_size - 1) // hp.batch_size)
    return np.full(counts.shape, hp.local_steps, dtype=np.int64)


def split_variables(variables: dict) -> tuple[Any, dict]:
    """Split variables into (params, rest-collections e.g. batch_stats)."""
    return variables["params"], {k: v for k, v in variables.items() if k != "params"}


# tag of the dropout stream folded into a client key ("drop")
_DROPOUT_TAG = 0x64726F70


def dropout_spec(model, batch_size: int) -> Optional[tuple]:
    """The shape of one step's dropout keep-mask of ``model`` at
    ``batch_size``, or None for a model without dropout."""
    shape = getattr(model, "dropout_shape", None)
    return None if shape is None else tuple(shape(batch_size))


def dropout_masks(key: rng.Key, n_steps: int, shape: tuple, keep_prob: float,
                  device) -> torch.Tensor:
    """A client's ``(n_steps, *shape)`` bool keep-masks drawn on ``device``
    from its client key: ``U[0, 1) < keep_prob``, flax's Bernoulli draw."""
    g = rng.generator(rng.fold_in(key, _DROPOUT_TAG), device)
    return torch.rand((int(n_steps),) + tuple(shape), generator=g, device=device) < keep_prob


def lane_dropout_table(tables: list) -> torch.Tensor:
    """The lanes' keep-mask tables, each ``(own steps, ...)``, stacked into
    one ``(L, most steps, ...)`` table; a lane's steps past its own are
    never read."""
    steps = max(t.shape[0] for t in tables)
    out = tables[0].new_zeros((len(tables), steps) + tuple(tables[0].shape[1:]))
    for lane, t in enumerate(tables):
        out[lane, :t.shape[0]] = t
    return out


def epoch_permutations(key: rng.Key, epochs: int, cap: int) -> torch.Tensor:
    """The ``(epochs, cap)`` permutation table drawn from a client key (the
    reference folds ``(key, epoch, 1)``; so does this)."""
    return torch.stack([rng.permutation(rng.fold_in(rng.fold_in(key, e), 1), cap)
                        for e in range(epochs)])


def make_local_train_fn(model, hp: HParams, loss_extra: Optional[Callable] = None,
                        grad_hook: Optional[Callable] = None,
                        data_parallel: Optional[tuple] = None):
    """Build ``local_train(variables, x, y, count, key, perms=None, ctx=None,
    dropout=None) -> (new_variables, metrics)``.  ``x``/``y`` are one
    client's padded shard on the device, ``count`` its true sample count
    (int), ``ctx`` what the hooks read, ``dropout`` the client's keep-masks
    (module docstring).

    ``data_parallel=(rank, world)``: a silo spanning ``world`` processes
    (``cross_silo/silo_dist.py``).  Every rank draws the same minibatch and
    trains on its contiguous ``batch / world`` rows of it (the rows GSPMD's
    ``data`` sharding gives the reference); its loss is its rows' share of
    the global batch's mean, the gradients and that loss are summed over
    the ranks (one all-reduce a step), and BatchNorm takes its moments over
    the global batch (``models/resnet.global_batch_stats``)."""
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
    drop_shape = dropout_spec(model, bsz)
    span = None
    if data_parallel is not None:
        from ..models.resnet import global_batch_stats
        from ..parallel.multihost import AllReduceSum, all_reduce_sum

        rank, world = data_parallel
        if bsz % world:
            raise ValueError(f"batch_size {bsz} does not split over {world} processes")
        if loss_extra is not None or grad_hook is not None or drop_shape is not None:
            raise NotImplementedError("a silo spanning processes trains plain local SGD "
                                      "without dropout (the cross-silo client's)")
        local = bsz // world
        span = (rank * local, (rank + 1) * local, local / bsz)

    def local_train(variables: dict, x: torch.Tensor, y: torch.Tensor, count: int,
                    key: rng.Key, perms: Optional[torch.Tensor] = None, ctx=None,
                    dropout: Optional[torch.Tensor] = None):
        params, rest = split_variables(variables)
        cap = x.shape[0]
        if cap < bsz:
            raise ValueError(
                f"client shard capacity {cap} is smaller than batch_size {bsz}; pad "
                "the shard (stack_clients with multiple_of=batch_size) or lower the batch size")
        if perms is None:
            perms = epoch_permutations(key, hp.epochs, cap)
        perms = perms.to(device=x.device, dtype=torch.long)
        n_steps = min(total_steps, int(step_budgets(hp, count)))
        if drop_shape is not None and dropout is None:
            dropout = dropout_masks(key, n_steps, drop_shape, model.keep_prob, x.device)
        opt_state = opt.init(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(n_steps):
            epoch, step_in_epoch = divmod(s, spe)
            start = min(step_in_epoch * bsz, cap - bsz)
            idx = perms[epoch, start:start + bsz]
            if span is not None:  # this rank's rows of the global minibatch
                idx = idx[span[0]:span[1]]
            bx, by = x.index_select(0, idx), y.index_select(0, idx)
            if bx.is_floating_point():
                bx = bx.to(compute_dtype)
            leaves = [p.detach().requires_grad_(True) for p in pt.tree_leaves(params)]
            p = pt.tree_unflatten_like(params, leaves)
            drop = {} if drop_shape is None else {"dropout": dropout[s]}
            if span is None:
                logits, new_stats = model.apply({"params": p, **rest}, bx, train=True, **drop)
                loss = base_loss(logits.to(torch.float32), by)
            else:
                with global_batch_stats(AllReduceSum.apply, world):
                    logits, new_stats = model.apply({"params": p, **rest}, bx, train=True)
                loss = base_loss(logits.to(torch.float32), by) * span[2]
            if loss_extra is not None:
                loss = loss + loss_extra(p, ctx)
            grad_leaves = torch.autograd.grad(loss, leaves)
            if span is not None:  # the global batch's gradient and loss
                flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grad_leaves]
                                                + [loss.detach().reshape(1)]))
                grad_leaves = [v.view_as(g) for v, g in
                               zip(flat[:-1].split([g.numel() for g in grad_leaves]),
                                   grad_leaves)]
                loss = flat[-1]
            grads = pt.tree_unflatten_like(params, grad_leaves)
            if grad_hook is not None:
                grads = grad_hook(grads, ctx)
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


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A host array on ``device`` without a device sync: through pinned
    memory and a copy on the current stream when ``device`` is a card."""
    t = torch.as_tensor(np.array(array), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_batched_local_train_fn(model, hp: HParams, loss_extra: Optional[Callable] = None,
                                grad_hook: Optional[Callable] = None):
    """Build ``batched_train(variables, x, y, clients, counts, perms,
    ctx=None, dropout=None) -> (new_variables, metrics)``:
    :func:`make_local_train_fn` for ``L`` clients at once (reference
    ``make_local_train_fn`` under ``jax.vmap``).

    ``variables``: lane-stacked (a leading lane axis ``L`` on every leaf);
    ``x`` / ``y``: every client's padded shard, stacked ``(clients, cap,
    ...)`` on the device (a step's batch is gathered from them, never a
    lane's whole shard); ``clients``: the lanes' rows of that stack (``(L,)``
    ints); ``counts``: the lanes' true sample counts on the host; ``perms``:
    the lanes' ``(L, epochs, cap)`` permutation tables; ``ctx``: the hooks'
    ``(shared, client)`` pair, ``client`` lane-stacked in the given lane
    order (the loss hook returns one value a lane); ``dropout``: a model
    with dropout takes the lanes' keep-masks, ``(L, steps, ...)`` bool with
    at least each lane's own budget of steps.  Returns lane-stacked
    variables and ``(L,)`` metric tensors on the device, lanes in the given
    order.

    Each of the ``epochs * steps_per_epoch`` steps is one batched forward and
    backward of the lanes still active.  ``step_mode="match"``: a lane takes
    its own budget of ``epochs * ceil(count / batch)`` steps; a spent lane
    keeps its params, optimizer state and batch stats bitwise (the
    reference's ``where(active, ...)``).  Budgets are known on the host, so
    the lanes run sorted longest first, the active ones a prefix that each
    step slices and writes back in place; ``"fixed"``: every lane every
    step.  ``train_loss`` is the mean over each lane's active steps."""
    if hp.steps_per_epoch <= 0:
        raise ValueError(
            "HParams.steps_per_epoch must be positive (got "
            f"{hp.steps_per_epoch}); build it via algorithms.hparams_from_config"
            "(cfg, steps_per_epoch=ceil(capacity/batch)) or the simulator")
    lane_loss = get_lane_loss_fn(hp.loss)
    opt = make_optimizer(hp)
    compute_dtype = torch.bfloat16 if hp.compute_dtype == "bfloat16" else torch.float32
    bsz, spe = hp.batch_size, hp.steps_per_epoch
    total_steps = hp.epochs * spe
    drop_shape = dropout_spec(model, bsz)

    def batched_train(variables: dict, x: torch.Tensor, y: torch.Tensor, clients: torch.Tensor,
                      counts, perms: torch.Tensor, ctx=None, dropout: Optional[torch.Tensor] = None):
        cap, device = x.shape[1], x.device
        if cap < bsz:
            raise ValueError(
                f"client shard capacity {cap} is smaller than batch_size {bsz}; pad "
                "the shard (stack_clients with multiple_of=batch_size) or lower the batch size")
        if perms is None:
            raise ValueError("batched local training takes each lane's permutation table "
                             "(the simulator's sampler gives them)")
        if drop_shape is not None and dropout is None:
            raise ValueError("batched local training of a model with dropout takes each "
                             "lane's keep-masks (the simulator's sampler gives them)")
        counts = np.asarray(counts, dtype=np.int64)
        steps = np.minimum(step_budgets(hp, counts), total_steps)
        order = np.argsort(-steps, kind="stable")  # longest budget first
        ranked = steps[order]
        take, back = to_device(order, device), to_device(np.argsort(order), device)
        params, rest = split_variables(pt.tree_take(variables, take))
        rows = (clients.to(device, torch.long).index_select(0, take) * cap)[:, None]
        perms = perms.to(device=device, dtype=torch.long).index_select(0, take)
        if drop_shape is not None:
            dropout = dropout.to(device).index_select(0, take)
        x_rows, y_rows = x.reshape((-1,) + x.shape[2:]), y.reshape((-1,) + y.shape[2:])
        opt_state = opt.init(params, lanes=counts.shape[0])
        if ctx is not None:  # the per-lane half follows the lanes' running order
            shared, lane_ctx = ctx
            lane_ctx = None if lane_ctx is None else pt.tree_take(lane_ctx, take)
        loss_sum = torch.zeros(counts.shape[0], dtype=torch.float32, device=device)
        for s in range(int(ranked[0]) if ranked.size else 0):
            n = int((ranked > s).sum())  # the active lanes: a prefix
            epoch, step_in_epoch = divmod(s, spe)
            start = min(step_in_epoch * bsz, cap - bsz)
            idx = (rows[:n] + perms[:n, epoch, start:start + bsz]).reshape(-1)
            bx = x_rows.index_select(0, idx).reshape((n, bsz) + x.shape[2:])
            by = y_rows.index_select(0, idx).reshape((n, bsz) + y.shape[2:])
            if bx.is_floating_point():
                bx = bx.to(compute_dtype)
            leaves = [t[:n].detach().requires_grad_(True) for t in pt.tree_leaves(params)]
            p = pt.tree_unflatten_like(params, leaves)
            drop = {} if drop_shape is None else {"dropout": dropout[:n, s]}
            logits, new_stats = model.apply({"params": p, **pt.tree_head(rest, n)}, bx,
                                            train=True, **drop)
            losses = lane_loss(logits.to(torch.float32), by)
            step_ctx = None if ctx is None else (
                shared, None if lane_ctx is None else pt.tree_head(lane_ctx, n))
            if loss_extra is not None:
                losses = losses + loss_extra(p, step_ctx)
            grads = pt.tree_unflatten_like(params, torch.autograd.grad(losses.sum(), leaves))
            if grad_hook is not None:
                grads = grad_hook(grads, step_ctx)
            state = None if opt_state is None else pt.tree_head(opt_state, n)
            new_params, new_state = opt.update(grads, state, p)
            pt.tree_set_head_(params, n, new_params)
            if opt_state is not None:
                pt.tree_set_head_(opt_state, n, new_state)
            if "batch_stats" in rest:
                pt.tree_set_head_(rest["batch_stats"], n, new_stats)
            with torch.no_grad():
                loss_sum[:n] += losses.detach()
        n_active = to_device(np.maximum(steps, 1), device, torch.float32)
        new_vars = pt.tree_take({"params": params, **rest}, back)
        metrics = {
            "train_loss": loss_sum.index_select(0, back) / n_active,
            "num_steps": n_active,
            "num_samples": to_device(counts, device, torch.float32),
        }
        return new_vars, metrics

    return batched_train


def _grad_dropout(model, bsz: int, dropout, n_batches: int, what: str):
    """The full-gradient pass's keep-mask table, checked: None for a model
    without dropout; a model with dropout must be given one mask a batch."""
    shape = dropout_spec(model, bsz)
    if shape is None:
        return None
    if dropout is None:
        raise ValueError(f"{what} of a model with dropout takes one keep-mask a batch of "
                         "the shard (the simulator's sampler gives them)")
    if dropout.shape[-len(shape) - 1] < n_batches:
        raise ValueError(f"{what}: {dropout.shape[-len(shape) - 1]} keep-masks for "
                         f"{n_batches} batches")
    return dropout


def make_full_grad_fn(model, hp: HParams):
    """Build ``full_grad(variables, x, y, dropout=None) -> grads``: the
    gradient of the mean loss over a client's whole cyclic-padded shard at
    fixed variables (the FedSGD client step and Mime's full gradient;
    reference L203).  The mean runs over the ``cap // batch_size``
    consecutive batches of the padded capacity, not over the true count;
    each batch runs in train mode (batch statistics) and its new running
    stats are thrown away.  ``x`` is used as given (no cast: the simulator
    keeps it in the compute dtype).  A model with dropout takes
    ``dropout``, one keep-mask a batch (module docstring)."""
    base_loss = get_loss_fn(hp.loss)
    bsz = hp.batch_size

    def full_grad(variables: dict, x: torch.Tensor, y: torch.Tensor,
                  dropout: Optional[torch.Tensor] = None):
        params, rest = split_variables(variables)
        n_batches = x.shape[0] // bsz
        dropout = _grad_dropout(model, bsz, dropout, n_batches, "the full gradient")
        leaves = [p.detach().requires_grad_(True) for p in pt.tree_leaves(params)]
        p = pt.tree_unflatten_like(params, leaves)
        acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        for i in range(n_batches):
            drop = {} if dropout is None else {"dropout": dropout[i].to(x.device)}
            logits, _ = model.apply({"params": p, **rest}, x[i * bsz:(i + 1) * bsz], train=True,
                                    **drop)
            loss = base_loss(logits.to(torch.float32), y[i * bsz:(i + 1) * bsz])
            acc = [a + g for a, g in zip(acc, torch.autograd.grad(loss, leaves))]
        denom = acc[0].new_full((), float(max(n_batches, 1)))
        return pt.tree_unflatten_like(params, [a / denom for a in acc])

    return full_grad


def make_batched_full_grad_fn(model, hp: HParams):
    """Build ``full_grad(variables, x, y, clients, dropout=None) -> grads``:
    :func:`make_full_grad_fn` for ``L`` clients at once at the same global
    ``variables`` (reference ``make_full_grad_fn`` under ``jax.vmap``).
    ``x`` / ``y``: every client's padded shard stacked ``(clients, cap,
    ...)`` on the device; ``clients``: the lanes' rows (``(L,)`` ints);
    ``dropout``: for a model with dropout the lanes' tables, ``(L, cap //
    batch_size, ...)``.  Each of the ``cap // batch_size`` batches is one
    lane-batched forward and backward of every lane's batch, with each
    lane's own BN statistics; the parameters enter as an ``L``-wide
    expanded view, so each lane gets its own gradient.  Returns the
    lane-stacked ``(L, ...)`` gradient tree."""
    lane_loss = get_lane_loss_fn(hp.loss)
    bsz = hp.batch_size

    def full_grad(variables: dict, x: torch.Tensor, y: torch.Tensor, clients: torch.Tensor,
                  dropout: Optional[torch.Tensor] = None):
        params, rest = split_variables(variables)
        lanes, n_batches = clients.shape[0], x.shape[1] // bsz
        dropout = _grad_dropout(model, bsz, dropout, n_batches, "the batched full gradient")

        def widen(t):
            return t.detach().expand((lanes,) + t.shape)

        leaves = [widen(t).requires_grad_(True) for t in pt.tree_leaves(params)]
        p = pt.tree_unflatten_like(params, leaves)
        rest = pt.tree_map(widen, rest)
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        for i in range(n_batches):
            bx, by = x[clients, i * bsz:(i + 1) * bsz], y[clients, i * bsz:(i + 1) * bsz]
            drop = {} if dropout is None else {"dropout": dropout[:, i].to(x.device)}
            logits, _ = model.apply({"params": p, **rest}, bx, train=True, **drop)
            losses = lane_loss(logits.to(torch.float32), by)
            acc = [a + g for a, g in zip(acc, torch.autograd.grad(losses.sum(), leaves))]
        denom = acc[0].new_full((), float(max(n_batches, 1)))
        return pt.tree_unflatten_like(params, [a / denom for a in acc])

    return full_grad


def make_eval_fn(model, hp: HParams, batch_size: int = 256):
    """Global test eval over a (padded) test set with a validity mask;
    returns ``{"test_loss", "test_acc"}`` as 0-d tensors (reference L240).
    Per sample: classification's cross-entropy and hit; a sequence's mean
    over its positions of both; multi-hot targets' mean binary
    cross-entropy and mean agreement of ``logit > 0`` with ``target >
    0.5``."""

    @torch.no_grad()
    def eval_fn(variables: dict, x: torch.Tensor, y: torch.Tensor, n_valid: int):
        n_batches = x.shape[0] // batch_size
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        correct = torch.zeros((), dtype=torch.float32, device=x.device)
        pos = torch.arange(batch_size, device=x.device)
        for i in range(n_batches):
            bx = x[i * batch_size:(i + 1) * batch_size]
            by = y[i * batch_size:(i + 1) * batch_size]
            mask = (pos + i * batch_size < n_valid).to(torch.float32)
            logits, _ = model.apply(variables, bx, train=False)
            per, ok = _eval_terms(logits.to(torch.float32), by)
            loss_sum = loss_sum + (per * mask).sum()
            correct = correct + (ok * mask).sum()
        seen = float(max(min(n_valid, n_batches * batch_size), 1))
        return {"test_loss": loss_sum / seen, "test_acc": correct / seen}

    return eval_fn


def _eval_terms(logits: torch.Tensor, labels: torch.Tensor):
    """Each sample's eval loss and hit (:func:`make_eval_fn`)."""
    if logits.ndim == labels.ndim + 1:
        labels = labels.long()
        per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                              reduction="none").reshape(labels.shape)
        ok = (logits.argmax(-1) == labels).to(torch.float32)
        if per.ndim == 2:  # a sequence: the mean over its positions
            per, ok = per.mean(-1), ok.mean(-1)
        return per, ok
    per = sigmoid_binary_cross_entropy(logits, labels).mean(-1)
    ok = ((logits > 0) == (labels > 0.5)).to(torch.float32).mean(-1)
    return per, ok
