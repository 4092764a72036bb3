"""FedAlgorithm — the pure-function frame of a federated algorithm (the port
of ``fedml_tpu/fl/algorithm.py``).  Defaults implement FedAvg: the
sample-weighted mean of full client variables and an identity server step.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core import pytree as pt
from .local_sgd import make_local_train_fn
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
                      key, perms=None) -> ClientOutput:
        new_vars, metrics = self._local_train(global_variables, x, y, count, key, perms=perms)
        return ClientOutput(contribution=new_vars, client_state=client_state, metrics=metrics)

    def aggregate(self, stacked_contributions, weights: torch.Tensor):
        return pt.tree_weighted_mean(stacked_contributions, weights)

    def server_update(self, global_variables, server_state, agg, round_idx):
        return agg, server_state
