"""FedNAS: federated neural architecture search (the port of
``fedml_tpu/sim/fednas.py``).

Each round's sampled clients are the lanes of one batched local search of
the DARTS supernet (``models/darts.py``), every lane from the global
weights and alphas.  A client's padded shard splits in halves: a train
half and a search half.  A step, for every lane at once (first-order
DARTS):

1. a weight step on a batch from the train half: SGD, momentum 0.9, lr
   ``learning_rate``;
2. an alpha step on a batch from the search half, taken with the weights
   just updated: Adam at ``nas_arch_lr``.

The reference runs both optimizers over the whole tree with the other
part's gradient zeroed; a zeroed part's update is exactly zero there
(SGD's trace and Adam's moments stay 0, so the step adds 0), so the port
runs each over its own part (``tests/test_torch_fedgan_fednas.py`` holds
the two forms bitwise).  A client takes ``max(1, half // batch) *
max(1, epochs)`` steps.  The server averages the weights by sample count
and the alphas uniformly.  The test accuracy is over the first 512 test
images after every round; the genotype (``derive_genotype``) is logged at
the end.  f32, as the reference.

Randomness: the sampler's ``sample`` and ``nas_indices`` (each step's two
batch tables; ``sim/own_nets.OwnNetSampler``).  Refused with
``NotImplementedError``: the trust features, the engine's unported flags
and population mode (``sim/engine.refuse_special_simulator``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..arguments import Config
from ..core import pytree as pt
from ..core import rng
from ..core.device import resolve_device
from ..core.flags import cfg_extra
from ..data.dataset import FederatedDataset, stack_clients
from ..fl.losses import cross_entropy_lanes
from ..fl.optim import SGD, Adam
from ..models.darts import DARTSSuperNet, derive_genotype, split_arch_params
from ..obs.metrics import MetricsLogger
from .engine import _labels, fit_loop, refuse_special_simulator
from .own_nets import OwnNetSampler, gather_lanes, grad_leaves, lane_copies

WEIGHT_MOMENTUM = 0.9
TEST_ROWS = 512


class FedNASSimulator:
    """FedNAS (reference L31) on ``device`` (the card unless the caller
    names another): :meth:`run` the fit loop, :meth:`run_round` one round,
    :meth:`genotype` the global architecture."""

    def __init__(self, cfg: Config, dataset: FederatedDataset,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_FEDNAS)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        feat = tuple(dataset.train_x.shape[1:])
        self.model = DARTSSuperNet(num_classes=dataset.class_num,
                                   n_cells=int(cfg_extra(cfg, "nas_cells")),
                                   features=int(cfg_extra(cfg, "nas_features")),
                                   in_channels=feat[-1])
        self.arch_lr = float(cfg_extra(cfg, "nas_arch_lr"))
        self.root_key = rng.root_key(cfg.random_seed)
        self.variables = self.model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        stacked = stack_clients(dataset, multiple_of=cfg.batch_size)
        self.counts, self.capacity = stacked.counts, stacked.capacity
        self._x = torch.from_numpy(stacked.x).to(self.device, torch.float32)
        self._y = _labels(stacked.y, self.device)
        self.half = self.capacity // 2
        self.steps = max(1, self.half // cfg.batch_size) * max(1, cfg.epochs)
        self._tx = torch.from_numpy(np.ascontiguousarray(dataset.test_x[:TEST_ROWS])).to(
            self.device, torch.float32)
        self._ty = _labels(np.ascontiguousarray(dataset.test_y[:TEST_ROWS]), self.device)
        n = dataset.n_clients
        self.sampler = sampler or OwnNetSampler(cfg.random_seed, n,
                                                min(cfg.client_num_per_round, n))
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0

    def _lane_losses(self, weights: dict, alphas: torch.Tensor, x, y) -> torch.Tensor:
        logits, _ = self.model.apply({"params": {**weights, "alphas": alphas}}, x, train=True)
        return cross_entropy_lanes(logits.to(torch.float32), y)

    def local_search(self, sampled: np.ndarray, iw: torch.Tensor, ia: torch.Tensor):
        """The sampled clients' alternating updates as lanes: ``iw`` /
        ``ia`` ``(L, steps, batch)`` rows of the weight and alpha steps (on
        the device).  Returns the lanes' weights, alphas and mean weight
        and alpha losses ``(L,)``."""
        lanes = len(sampled)
        rows = torch.as_tensor(sampled, dtype=torch.long, device=self.device)
        weights, alphas = split_arch_params(lane_copies(self.variables["params"], lanes))
        w_opt = SGD(self.cfg.learning_rate, WEIGHT_MOMENTUM)
        a_opt = Adam(self.arch_lr)
        w_state, a_state = w_opt.init(weights), a_opt.init(alphas, lanes)
        lw_sum = torch.zeros(lanes, dtype=torch.float32, device=self.device)
        la_sum = torch.zeros_like(lw_sum)
        for s in range(iw.shape[1]):
            wq, w_leaves = grad_leaves(weights)
            lw = self._lane_losses(wq, alphas, gather_lanes(self._x, rows, iw[:, s]),
                                   gather_lanes(self._y, rows, iw[:, s]))
            grads = pt.tree_unflatten_like(weights, torch.autograd.grad(lw.sum(), w_leaves))
            weights, w_state = w_opt.update(grads, w_state, wq)
            aq = alphas.detach().requires_grad_(True)
            la = self._lane_losses(weights, aq, gather_lanes(self._x, rows, ia[:, s]),
                                   gather_lanes(self._y, rows, ia[:, s]))
            (ga,) = torch.autograd.grad(la.sum(), [aq])
            alphas, a_state = a_opt.update(ga, a_state, aq)
            lw_sum, la_sum = lw_sum + lw.detach(), la_sum + la.detach()
        return weights, alphas, lw_sum / iw.shape[1], la_sum / iw.shape[1]

    def run_round(self) -> dict:
        r, bs = self.round_idx, self.cfg.batch_size
        sampled = np.array(self.sampler.sample(r))
        tables = [self.sampler.nas_indices(r, int(c), self.steps, self.half, self.capacity, bs)
                  for c in sampled]
        iw, ia = (torch.stack(t).to(self.device) for t in zip(*tables))
        weights, alphas, lw, la = self.local_search(sampled, iw, ia)
        w = torch.as_tensor(self.counts[sampled], dtype=torch.float32, device=self.device)
        # weights by sample count, alphas uniformly (reference L132-134)
        new_weights = pt.tree_weighted_mean(weights, w)
        new_alphas = pt.tree_weighted_mean(alphas, torch.ones_like(w))
        self.variables = {"params": {**new_weights, "alphas": new_alphas}}
        self.round_idx += 1
        return {"train_loss": float(lw.mean()), "arch_loss": float(la.mean())}

    @torch.no_grad()
    def evaluate(self) -> dict:
        logits, _ = self.model.apply(self.variables, self._tx, train=False)
        return {"test_acc": float((logits.argmax(-1) == self._ty).to(torch.float32).mean())}

    def genotype(self) -> list[list[str]]:
        return derive_genotype(self.variables["params"]["alphas"])

    def run(self) -> list[dict]:
        history = fit_loop(self.run_round, self.evaluate, self.cfg, self.logger, every_round=True)
        self.logger.log({"genotype": str(self.genotype())})
        return history
