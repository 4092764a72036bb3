"""FedProx — a proximal term in the local objective (the port of
``fedml_tpu/algorithms/fedprox.py``): ``mu/2 * ||w - w_global||^2`` is
added to each step's loss through ``loss_extra``; the aggregate is FedAvg's
weighted mean."""

from __future__ import annotations

from ..core import pytree as pt
from ..fl.algorithm import FedAlgorithm


class FedProx(FedAlgorithm):
    name = "FedProx"

    def loss_extra(self, lanes=False):
        mu = self.hp.fedprox_mu
        sq_norm = pt.tree_sq_norm_lanes if lanes else pt.tree_sq_norm

        def prox(params, ctx):
            global_params, _ = ctx
            return 0.5 * mu * sq_norm(pt.tree_sub(params, global_params))

        return prox

    def make_ctx(self, global_variables, client_state, server_state):
        return global_variables["params"], None
