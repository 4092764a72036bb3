"""FedNova — normalized averaging for heterogeneous local steps (Wang et
al.; the port of ``fedml_tpu/algorithms/fednova.py``).

Client i runs ``tau_i`` local steps (its own budget under ``step_mode``
match) and reports ``d_i = (x - y_i) / a_i`` with ``a_i = tau_i`` for plain
SGD and ``a_i = (tau_i - rho (1 - rho^tau_i) / (1 - rho)) / (1 - rho)`` with
momentum ``rho`` (``rho ** tau`` in f32).  The server steps ``x <- x -
server_lr * tau_eff * sum_i p_i d_i`` with ``tau_eff = sum_i p_i a_i``,
``p_i = n_i / n``.  On MESH ``tau`` and ``a`` are ``(L,)``, one a lane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import pytree as pt
from ..fl.algorithm import FedAlgorithm
from ..fl.local_sgd import split_variables, step_budgets, to_device
from ..fl.types import ClientOutput


class FedNova(FedAlgorithm):
    name = "FedNova"

    def client_update(self, global_variables, client_state, server_state, x, y, count, key,
                      perms=None, draw=None, dropout=None):
        new_vars, metrics = self._train_one(global_variables, client_state, server_state, x, y,
                                            count, key, perms, dropout)
        tau = torch.tensor(float(step_budgets(self.hp, count)), dtype=torch.float32,
                           device=x.device)
        return ClientOutput(self._normalized(global_variables, new_vars, tau), client_state,
                            metrics)

    def client_update_lanes(self, global_variables, client_states, server_state, x, y, clients,
                            counts, perms=None, draw=None, dropout=None):
        new_vars, metrics = self._train_lanes(global_variables, client_states, server_state, x,
                                              y, clients, counts, perms, dropout)
        tau = to_device(step_budgets(self.hp, counts).astype(np.float32), x.device)
        return ClientOutput(self._normalized(global_variables, new_vars, tau), client_states,
                            metrics)

    def _normalized(self, global_variables, new_vars, tau):
        rho = self.hp.momentum
        if rho:
            a = (tau - rho * (1.0 - torch.pow(tau.new_full((), rho), tau)) / (1.0 - rho)) / (
                1.0 - rho)
        else:
            a = tau
        l_params, l_rest = split_variables(new_vars)
        d = pt.tree_map(lambda gx, ly: (gx - ly) / pt.per_lane(a, ly), global_variables["params"],
                        l_params)
        return {"d": d, "a": a, "rest": l_rest}

    def aggregate(self, stacked, weights):
        w = weights / torch.clamp(weights.sum(), min=1e-12)
        return {"d": pt.tree_weighted_mean(stacked["d"], weights),
                "tau_eff": (w * stacked["a"]).sum(),
                "rest": pt.tree_weighted_mean(stacked["rest"], weights)}

    def server_update(self, global_variables, server_state, agg, round_idx):
        scale = agg["tau_eff"] * self.hp.server_lr
        new_params = pt.tree_map(lambda x, d: x - scale * d, global_variables["params"], agg["d"])
        return {"params": new_params, **agg["rest"]}, server_state
