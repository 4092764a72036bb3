"""FedAlgorithm — the pure-function frame of a federated algorithm (the port
of ``fedml_tpu/fl/algorithm.py``).  Defaults implement FedAvg: the
sample-weighted mean of full client variables and an identity server step.

An algorithm changes local training through the reference's hooks:
``loss_extra()`` (a term added to the loss), ``grad_hook()`` (a rewrite of
the gradient before the optimizer) and ``make_ctx`` (what both read).  In
the port ``make_ctx`` returns a pair ``(shared, client)``: ``shared`` is
the same for every client of the round (global parameters, server state),
``client`` comes from the client's own state.  The same ``make_ctx`` serves
the lanes of a batched round (:meth:`FedAlgorithm.client_update_lanes`):
there ``client`` is lane-stacked, and ``loss_extra(lanes=True)`` returns
one value a lane.  A gradient hook is elementwise, so one function serves
both (``shared`` broadcasts against the lanes).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import pytree as pt
from .local_sgd import make_batched_local_train_fn, make_local_train_fn, step_budgets
from .optim import SGD, Adagrad, Adam, Yogi
from .types import ClientOutput, HParams


class FedAlgorithm:
    name = "FedAvg"
    # the keep-mask tables the algorithm takes for a model with dropout:
    # "train" for the local steps (``dropout=``), "grad" for a full-gradient
    # pass (``grad_dropout=``, one mask a batch of the shard)
    dropout_tables = ("train",)

    def __init__(self, hp: HParams, cfg=None):
        self.hp = hp
        self.cfg = cfg
        self._local_train = None
        self._batched_train = None

    def build(self, model) -> "FedAlgorithm":
        """Close over the model to build the local train fns (one client,
        and the lanes of a batched round)."""
        self._local_train = make_local_train_fn(
            model, self.hp, loss_extra=self.loss_extra(), grad_hook=self.grad_hook())
        self._batched_train = make_batched_local_train_fn(
            model, self.hp, loss_extra=self.loss_extra(lanes=True), grad_hook=self.grad_hook())
        return self

    def round_batches(self, counts, capacity: int) -> int:
        """Forward-and-backward batches of ``batch_size`` rows that clients
        with sample ``counts`` (host) and shards of ``capacity`` rows run in
        a round: each client's local steps (``step_budgets``, at most
        ``epochs * steps_per_epoch``), on MESH and sp alike."""
        hp = self.hp
        return int(np.minimum(step_budgets(hp, counts), hp.epochs * hp.steps_per_epoch).sum())

    def loss_extra(self, lanes: bool = False) -> Optional[Callable]:
        """``extra(params, ctx)`` added to the local loss: a 0-d tensor, or
        with ``lanes`` one value a lane of lane-stacked ``params``."""
        return None

    def grad_hook(self) -> Optional[Callable]:
        """``hook(grads, ctx) -> grads`` applied before the optimizer step."""
        return None

    def init_server_state(self, variables: dict) -> Any:
        return ()

    def init_client_state(self, variables: dict) -> Optional[Any]:
        return None

    def make_ctx(self, global_variables, client_state, server_state):
        """The hooks' ``(shared, client)`` context (module docstring)."""
        return None

    def client_update(self, global_variables, client_state, server_state, x, y, count,
                      key, perms=None, draw=None, dropout=None) -> ClientOutput:
        """One client's round.  ``perms`` is its per-epoch permutation table;
        ``draw(shape)`` returns its uniform ``U[0, 1)`` draw of this round
        for algorithms that compress; ``dropout`` its table of dropout
        keep-masks for a model with dropout (all from the simulator's
        sampler)."""
        new_vars, metrics = self._train_one(global_variables, client_state, server_state, x, y,
                                            count, key, perms, dropout)
        return ClientOutput(contribution=new_vars, client_state=client_state, metrics=metrics)

    def client_update_lanes(self, global_variables, client_states, server_state, x, y, clients,
                            counts, perms=None, draw=None, dropout=None) -> ClientOutput:
        """The round of ``L`` clients at once, a client a lane (the
        reference's ``client_update`` under ``jax.vmap``): ``x`` / ``y`` are
        every client's stacked shards on the device, ``clients`` the lanes'
        rows of them (``(L,)`` ints), ``counts`` the lanes' sample counts
        (host), ``client_states`` the lanes' stacked state, ``perms`` their
        ``(L, epochs, cap)`` permutation tables, ``draw(shape)`` their
        ``(L,) + shape`` uniform draws and ``dropout`` their ``(L, steps,
        ...)`` dropout keep-masks.  Returns lane-stacked contributions and
        client state and ``(L,)`` metric tensors."""
        new_vars, metrics = self._train_lanes(global_variables, client_states, server_state, x,
                                              y, clients, counts, perms, dropout)
        return ClientOutput(contribution=new_vars, client_state=client_states, metrics=metrics)

    def _train_one(self, global_variables, client_state, server_state, x, y, count, key,
                   perms, dropout=None):
        """One client's local training from the global variables."""
        ctx = self.make_ctx(global_variables, client_state, server_state)
        return self._local_train(global_variables, x, y, count, key, perms=perms, ctx=ctx,
                                 dropout=dropout)

    def _train_lanes(self, global_variables, client_states, server_state, x, y, clients, counts,
                     perms, dropout=None):
        """The lanes' local training from the global variables."""
        lanes = clients.shape[0]
        start = pt.tree_map(lambda t: t.unsqueeze(0).expand((lanes,) + t.shape), global_variables)
        ctx = self.make_ctx(global_variables, client_states, server_state)
        return self._batched_train(start, x, y, clients, counts, perms, ctx, dropout)

    def supports_associative_fold(self) -> bool:
        """True when ``aggregate`` is a weight-associative fold (reference
        L75): the sample-weighted mean is; the gate of the secure
        aggregation protocols, whose masked sum is such a fold."""
        return type(self).aggregate is FedAlgorithm.aggregate

    def aggregate(self, stacked_contributions, weights: torch.Tensor):
        return pt.tree_weighted_mean(stacked_contributions, weights)

    def server_update(self, global_variables, server_state, agg, round_idx):
        return agg, server_state


def config_supports_associative_fold(cfg) -> bool:
    """:meth:`FedAlgorithm.supports_associative_fold` of ``cfg``'s algorithm,
    before any model exists (reference L100)."""
    from ..algorithms import create as create_algorithm, hparams_from_config

    algo = create_algorithm(cfg, hparams_from_config(cfg, steps_per_epoch=1))
    return bool(algo.supports_associative_fold())


def make_server_optimizer(hp: HParams):
    """Server-side optimizer of the FedOpt family (reference L111), with
    optax's update order (``fl/optim.py``): ``sgd(server_lr,
    server_momentum)``, ``adam(server_lr, b1=0.9, b2=0.99, eps=1e-3)``,
    ``adagrad(server_lr)`` or ``yogi(server_lr)``."""
    if hp.server_optimizer == "sgd":
        return SGD(hp.server_lr, hp.server_momentum)
    if hp.server_optimizer == "adam":
        return Adam(hp.server_lr, b1=0.9, b2=0.99, eps=1e-3)
    if hp.server_optimizer == "adagrad":
        return Adagrad(hp.server_lr)
    if hp.server_optimizer == "yogi":
        return Yogi(hp.server_lr)
    raise ValueError(f"unknown server optimizer {hp.server_optimizer!r}")
