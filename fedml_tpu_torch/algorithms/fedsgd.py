"""FedSGD — one full-shard gradient per client per round, optionally
compressed (the port of ``fedml_tpu/algorithms/fedsgd.py``).

Each client reports the gradient of its mean loss over its whole padded
shard at the global weights; compression (``topk | eftopk | quantize | qsgd
| qsgd_int8``) applies to that gradient flattened in the reference's layout
(``weights.flatten_reference``), so block-wise and element-wise operators see
the reference's vector.  EF-TopK residuals, in the same layout, are the
per-client state.  The server takes one step of the server optimizer
(``sgd(server_lr)``) on the sample-weighted mean gradient.

:meth:`FedSGD.client_update_lanes` computes the round's clients together, a
client a lane (``fl/local_sgd.make_batched_full_grad_fn``), and compresses
their flat gradients as the rows of one ``(L, n)`` tensor.

A model with dropout takes its keep-masks a batch of the shard
(``grad_dropout``, from the simulator's sampler).

As in the reference: ``learning_rate`` plays no part (the step size is
``server_lr``, 1.0 by default), ``train_loss`` is reported as 0 and the
batch statistics are never updated.
"""

from __future__ import annotations

import torch

from .. import weights
from ..core import pytree as pt
from ..fl.algorithm import FedAlgorithm, make_server_optimizer
from ..fl.local_sgd import (make_batched_full_grad_fn, make_full_grad_fn, split_variables,
                            to_device)
from ..fl.types import ClientOutput
from ..ops import compression as comp


class FedSGD(FedAlgorithm):
    name = "FedSGD"
    dropout_tables = ("grad",)

    def __init__(self, hp, cfg=None):
        super().__init__(hp, cfg)
        self._server_opt = make_server_optimizer(hp)
        self.compression = getattr(cfg, "compression", "no") if cfg else "no"
        self.ratio = getattr(cfg, "compression_ratio", 0.01) if cfg else 0.01
        self.qlevel = getattr(cfg, "quantize_level", 8) if cfg else 8

    def build(self, model):
        self._full_grad = make_full_grad_fn(model, self.hp)
        self._batched_full_grad = make_batched_full_grad_fn(model, self.hp)
        return self

    def init_server_state(self, variables):
        return self._server_opt.init(variables["params"])

    def init_client_state(self, variables):
        if self.compression == "eftopk":
            flat, _ = weights.flatten_reference(variables["params"])
            return torch.zeros_like(flat)
        return None

    def client_update(self, global_variables, client_state, server_state, x, y, count, key,
                      perms=None, draw=None, dropout=None, grad_dropout=None):
        grad = self._full_grad(global_variables, x, y, grad_dropout)
        new_state = client_state
        if self.compression != "no":
            flat, unravel = weights.flatten_reference(grad)
            shape = comp.draw_shape(self.compression, flat.shape[0])
            noise = draw(shape).to(flat.device) if shape is not None else None
            flat, new_state = comp.compress(
                self.compression, flat, noise=noise, residual=client_state, ratio=self.ratio,
                quantize_level=self.qlevel)
            grad = unravel(flat)
        metrics = {"train_loss": 0.0, "num_steps": 1.0, "num_samples": float(count)}
        return ClientOutput(contribution=grad, client_state=new_state, metrics=metrics)

    def client_update_lanes(self, global_variables, client_states, server_state, x, y, clients,
                            counts, perms=None, draw=None, dropout=None, grad_dropout=None):
        grad = self._batched_full_grad(global_variables, x, y, clients, grad_dropout)
        new_states = client_states
        if self.compression != "no":
            flat, unravel = flatten_reference_lanes(grad)
            shape = comp.draw_shape(self.compression, flat.shape[1])
            noise = draw(shape).to(flat.device) if shape is not None else None
            flat, new_states = comp.compress(
                self.compression, flat, noise=noise, residual=client_states, ratio=self.ratio,
                quantize_level=self.qlevel)
            grad = unravel(flat)
        lanes = clients.shape[0]
        zeros = torch.zeros(lanes, dtype=torch.float32, device=clients.device)
        metrics = {"train_loss": zeros, "num_steps": zeros + 1.0,
                   "num_samples": to_device(counts, zeros.device, torch.float32)}
        return ClientOutput(contribution=grad, client_state=new_states, metrics=metrics)

    def server_update(self, global_variables, server_state, agg, round_idx):
        g_params, g_rest = split_variables(global_variables)
        new_params, new_state = self._server_opt.update(agg, server_state, g_params)
        return {"params": new_params, **g_rest}, new_state


def flatten_reference_lanes(tree):
    """:func:`weights.flatten_reference` of each lane of a lane-stacked tree:
    ``(L, n)`` rows in the reference's flat layout, and the inverse
    ``unravel(rows)`` back to the lane-stacked tree."""
    return pt.stacked_tree_to_matrix(tree), lambda rows: pt.matrix_to_stacked_tree(rows, tree)
