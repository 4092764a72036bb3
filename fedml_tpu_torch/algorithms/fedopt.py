"""FedOpt / FedOpt_seq — server-side adaptive optimization (Reddi et al.;
the port of ``fedml_tpu/algorithms/fedopt.py``).

Clients run FedAvg's local SGD; the server treats ``global - mean`` of the
parameters as a pseudo-gradient and steps the server optimizer
(``server_optimizer``: sgd with ``server_momentum``, adam, adagrad or yogi;
``fl/algorithm.make_server_optimizer``) over ``params`` alone.  The other
collections (BN statistics) take the weighted mean.
"""

from __future__ import annotations

from ..core import pytree as pt
from ..fl.algorithm import FedAlgorithm, make_server_optimizer
from ..fl.local_sgd import split_variables


class FedOpt(FedAlgorithm):
    name = "FedOpt"

    def __init__(self, hp, cfg=None):
        super().__init__(hp, cfg)
        self._server_opt = make_server_optimizer(hp)

    def init_server_state(self, variables):
        return self._server_opt.init(variables["params"])

    def server_update(self, global_variables, server_state, agg, round_idx):
        g_params, _ = split_variables(global_variables)
        a_params, a_rest = split_variables(agg)
        pseudo_grad = pt.tree_sub(g_params, a_params)
        new_params, new_state = self._server_opt.update(pseudo_grad, server_state, g_params)
        return {"params": new_params, **a_rest}, new_state


class FedOptSeq(FedOpt):
    name = "FedOpt_seq"
