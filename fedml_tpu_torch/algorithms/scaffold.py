"""SCAFFOLD — control-variate corrected local SGD (Karimireddy et al.,
option II; the port of ``fedml_tpu/algorithms/scaffold.py``)::

  local step:    y <- y - lr * (g(y) + c - c_i)          (grad_hook)
  after K steps: c_i+ = c_i - c + (x - y) / (K * lr)
  server:        x <- x + lr_s * (mean_S(y) - x);  c <- c + (|S|/N) * mean_S(c_i+ - c_i)

``K`` is the client's own step budget (one a lane on MESH).  Client state
``c_i`` is stacked over all N clients on the device (the simulator gathers
the sampled rows and scatters them back); server state is ``c``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import pytree as pt
from ..fl.algorithm import FedAlgorithm
from ..fl.local_sgd import split_variables, step_budgets, to_device
from ..fl.types import ClientOutput


class Scaffold(FedAlgorithm):
    name = "SCAFFOLD"

    def grad_hook(self):
        def correct(grads, ctx):
            c_global, c_i = ctx
            return pt.tree_map(lambda g, c, ci: g + c - ci, grads, c_global, c_i)

        return correct

    def init_server_state(self, variables):
        return pt.tree_zeros_like(variables["params"])

    def init_client_state(self, variables):
        return pt.tree_zeros_like(variables["params"])

    def make_ctx(self, global_variables, client_state, server_state):
        return server_state, client_state

    def client_update(self, global_variables, client_state, server_state, x, y, count, key,
                      perms=None, draw=None, dropout=None):
        new_vars, metrics = self._train_one(global_variables, client_state, server_state, x, y,
                                            count, key, perms, dropout)
        k = torch.tensor(float(step_budgets(self.hp, count)), dtype=torch.float32, device=x.device)
        return self._output(global_variables, client_state, server_state, new_vars, metrics, k)

    def client_update_lanes(self, global_variables, client_states, server_state, x, y, clients,
                            counts, perms=None, draw=None, dropout=None):
        new_vars, metrics = self._train_lanes(global_variables, client_states, server_state, x,
                                              y, clients, counts, perms, dropout)
        k = to_device(step_budgets(self.hp, counts).astype(np.float32), x.device)
        return self._output(global_variables, client_states, server_state, new_vars, metrics, k)

    def _output(self, global_variables, c_i, c, new_vars, metrics, k_steps):
        l_params, l_rest = split_variables(new_vars)
        inv_klr = 1.0 / (k_steps * self.hp.learning_rate)
        new_ci = pt.tree_map(lambda ci, cg, gx, ly: ci - cg + (gx - ly) * pt.per_lane(inv_klr, ly),
                             c_i, c, global_variables["params"], l_params)
        contribution = {"variables": {"params": l_params, **l_rest},
                        "delta_c": pt.tree_sub(new_ci, c_i)}
        return ClientOutput(contribution=contribution, client_state=new_ci, metrics=metrics)

    def aggregate(self, stacked, weights):
        # parameters sample-weighted, the control variates' change uniformly
        return {"variables": pt.tree_weighted_mean(stacked["variables"], weights),
                "delta_c": pt.tree_weighted_mean(stacked["delta_c"], torch.ones_like(weights))}

    def server_update(self, global_variables, server_state, agg, round_idx):
        a_params, a_rest = split_variables(agg["variables"])
        lr_s = self.hp.server_lr
        new_params = pt.tree_map(lambda x, a: x + lr_s * (a - x), global_variables["params"],
                                 a_params)
        frac = (self.cfg.client_num_per_round / self.cfg.client_num_in_total) if self.cfg else 1.0
        return {"params": new_params, **a_rest}, pt.tree_axpy(frac, agg["delta_c"], server_state)
