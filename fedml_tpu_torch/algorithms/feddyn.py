"""FedDyn — dynamic regularization (Acar et al.; the port of
``fedml_tpu/algorithms/feddyn.py``)::

  local objective: f_i(w) - <lambda_i, w> + (alpha/2) ||w - x||^2     (loss_extra)
  after training:  lambda_i <- lambda_i - alpha (y_i - x)
  server:          h <- h - alpha (|S|/N) mean_S(y_i - x);  x <- mean_S(y_i) - h / alpha

The means are uniform over the sampled clients.  Client state
``lambda_i`` is stacked over all N clients on the device; server state is
``h``.
"""

from __future__ import annotations

import torch

from ..core import pytree as pt
from ..fl.algorithm import FedAlgorithm
from ..fl.local_sgd import split_variables
from ..fl.types import ClientOutput


class FedDyn(FedAlgorithm):
    name = "FedDyn"

    def loss_extra(self, lanes=False):
        alpha = self.hp.feddyn_alpha
        dot = pt.tree_dot_lanes if lanes else pt.tree_dot
        sq_norm = pt.tree_sq_norm_lanes if lanes else pt.tree_sq_norm

        def extra(params, ctx):
            global_params, lam = ctx
            lin = dot(lam, params)
            prox = 0.5 * alpha * sq_norm(pt.tree_sub(params, global_params))
            return prox - lin

        return extra

    def init_server_state(self, variables):
        return pt.tree_zeros_like(variables["params"])

    def init_client_state(self, variables):
        return pt.tree_zeros_like(variables["params"])

    def make_ctx(self, global_variables, client_state, server_state):
        return global_variables["params"], client_state

    def client_update(self, global_variables, client_state, server_state, x, y, count, key,
                      perms=None, draw=None, dropout=None):
        new_vars, metrics = self._train_one(global_variables, client_state, server_state, x, y,
                                            count, key, perms, dropout)
        return self._output(global_variables, client_state, new_vars, metrics)

    def client_update_lanes(self, global_variables, client_states, server_state, x, y, clients,
                            counts, perms=None, draw=None, dropout=None):
        new_vars, metrics = self._train_lanes(global_variables, client_states, server_state, x,
                                              y, clients, counts, perms, dropout)
        return self._output(global_variables, client_states, new_vars, metrics)

    def _output(self, global_variables, lam, new_vars, metrics):
        l_params, l_rest = split_variables(new_vars)
        delta = pt.tree_sub(l_params, global_variables["params"])
        contribution = {"variables": {"params": l_params, **l_rest}, "delta": delta}
        return ClientOutput(contribution=contribution,
                            client_state=pt.tree_axpy(-self.hp.feddyn_alpha, delta, lam),
                            metrics=metrics)

    def aggregate(self, stacked, weights):
        uniform = torch.ones_like(weights)
        return {"variables": pt.tree_weighted_mean(stacked["variables"], uniform),
                "delta": pt.tree_weighted_mean(stacked["delta"], uniform)}

    def server_update(self, global_variables, server_state, agg, round_idx):
        alpha = self.hp.feddyn_alpha
        frac = (self.cfg.client_num_per_round / self.cfg.client_num_in_total) if self.cfg else 1.0
        new_h = pt.tree_axpy(-alpha * frac, agg["delta"], server_state)
        a_params, a_rest = split_variables(agg["variables"])
        new_params = pt.tree_map(lambda a, h: a - h / alpha, a_params, new_h)
        return {"params": new_params, **a_rest}, new_h
