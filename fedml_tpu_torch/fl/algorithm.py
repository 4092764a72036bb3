"""FedAlgorithm — the pure-function frame of a federated algorithm (the port
of ``fedml_tpu/fl/algorithm.py``).  Defaults implement FedAvg: the
sample-weighted mean of full client variables and an identity server step.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core import pytree as pt
from .local_sgd import SGD, make_local_train_fn
from .types import ClientOutput, HParams


class FedAlgorithm:
    name = "FedAvg"

    def __init__(self, hp: HParams, cfg=None):
        self.hp = hp
        self.cfg = cfg
        self._local_train = None

    def build(self, model) -> "FedAlgorithm":
        """Close over the model to build the local train fn."""
        self._local_train = make_local_train_fn(model, self.hp)
        return self

    def init_server_state(self, variables: dict) -> Any:
        return ()

    def init_client_state(self, variables: dict) -> Optional[Any]:
        return None

    def client_update(self, global_variables, client_state, server_state, x, y, count,
                      key, perms=None, draw=None) -> ClientOutput:
        """One client's round.  ``perms`` is its per-epoch permutation table;
        ``draw(shape)`` returns its uniform ``U[0, 1)`` draw of this round
        for algorithms that compress (both from the simulator's sampler)."""
        new_vars, metrics = self._local_train(global_variables, x, y, count, key, perms=perms)
        return ClientOutput(contribution=new_vars, client_state=client_state, metrics=metrics)

    def aggregate(self, stacked_contributions, weights: torch.Tensor):
        return pt.tree_weighted_mean(stacked_contributions, weights)

    def server_update(self, global_variables, server_state, agg, round_idx):
        return agg, server_state


def make_server_optimizer(hp: HParams) -> SGD:
    """Server-side optimizer (reference L111): ``sgd(server_lr,
    server_momentum)`` with optax's update order.  The adaptive FedOpt
    optimizers come with the FedOpt slice."""
    if hp.server_optimizer == "sgd":
        return SGD(hp.server_lr, hp.server_momentum)
    if hp.server_optimizer in ("adam", "adagrad", "yogi"):
        raise NotImplementedError(f"server_optimizer {hp.server_optimizer!r} is not ported yet "
                                  "(it comes with the FedOpt slice; ported: 'sgd')")
    raise ValueError(f"unknown server optimizer {hp.server_optimizer!r}")
