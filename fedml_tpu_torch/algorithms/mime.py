"""MimeLite — server momentum applied inside the local steps (Karimireddy
et al.; the port of ``fedml_tpu/algorithms/mime.py``)::

  local step: d = (1 - beta) * g(y) + beta * m;  y <- y - lr * d     (grad_hook; m frozen)
  clients also report grad f_i(x), the full-shard gradient at the global point
  server:     x <- mean_S(y_i);  m <- (1 - beta) * mean_S(grad f_i(x)) + beta * m

Server state is ``m``.  The full gradient is ``make_full_grad_fn`` on sp
and ``make_batched_full_grad_fn`` for the lanes of a MESH round; a model
with dropout takes two keep-mask tables, the local steps' (``dropout``) and
the full gradient's (``grad_dropout``, one mask a batch of the shard).
"""

from __future__ import annotations

from ..core import pytree as pt
from ..fl.algorithm import FedAlgorithm
from ..fl.local_sgd import make_batched_full_grad_fn, make_full_grad_fn
from ..fl.types import ClientOutput


class Mime(FedAlgorithm):
    name = "Mime"
    dropout_tables = ("train", "grad")

    def build(self, model):
        super().build(model)
        self._full_grad = make_full_grad_fn(model, self.hp)
        self._batched_full_grad = make_batched_full_grad_fn(model, self.hp)
        return self

    def round_batches(self, counts, capacity):
        """The local steps and a full gradient a client."""
        return super().round_batches(counts, capacity) + len(counts) * (
            capacity // self.hp.batch_size)

    def grad_hook(self):
        beta = self.hp.mime_momentum

        def mix(grads, ctx):
            m, _ = ctx
            return pt.tree_map(lambda g, mi: (1 - beta) * g + beta * mi, grads, m)

        return mix

    def init_server_state(self, variables):
        return pt.tree_zeros_like(variables["params"])

    def make_ctx(self, global_variables, client_state, server_state):
        return server_state, None

    def client_update(self, global_variables, client_state, server_state, x, y, count, key,
                      perms=None, draw=None, dropout=None, grad_dropout=None):
        new_vars, metrics = self._train_one(global_variables, client_state, server_state, x, y,
                                            count, key, perms, dropout)
        contribution = {"variables": new_vars,
                        "full_grad": self._full_grad(global_variables, x, y, grad_dropout)}
        return ClientOutput(contribution=contribution, client_state=client_state, metrics=metrics)

    def client_update_lanes(self, global_variables, client_states, server_state, x, y, clients,
                            counts, perms=None, draw=None, dropout=None, grad_dropout=None):
        new_vars, metrics = self._train_lanes(global_variables, client_states, server_state, x,
                                              y, clients, counts, perms, dropout)
        contribution = {"variables": new_vars,
                        "full_grad": self._batched_full_grad(global_variables, x, y, clients,
                                                             grad_dropout)}
        return ClientOutput(contribution=contribution, client_state=client_states, metrics=metrics)

    def aggregate(self, stacked, weights):
        return {"variables": pt.tree_weighted_mean(stacked["variables"], weights),
                "full_grad": pt.tree_weighted_mean(stacked["full_grad"], weights)}

    def server_update(self, global_variables, server_state, agg, round_idx):
        beta = self.hp.mime_momentum
        new_m = pt.tree_map(lambda g, m: (1 - beta) * g + beta * m, agg["full_grad"], server_state)
        return agg["variables"], new_m
