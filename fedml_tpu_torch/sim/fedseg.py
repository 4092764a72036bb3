"""FedSeg: federated semantic segmentation (the port of
``fedml_tpu/sim/fedseg.py``).

Each round's sampled clients are the lanes of one batched local train of
the UNet (``models/segmentation.py``) from the global model, SGD with
momentum 0.9, per-pixel cross-entropy, ``max(1, cap // batch) * max(1,
epochs)`` steps on batches drawn uniformly (with repeats) from the padded
shard.  The server takes the sample-weighted mean of the lanes' models.
The test metrics (pixel accuracy, mIoU, FWIoU) are over the first 256
test images.

A dataset that carries masks (``fets2021``) trains on them; any other gets
:func:`synthesize_masks`, the reference's deterministic quadrant masks.
The images must be ``(H, W, C)``.  f32, as the reference.

Randomness: the sampler's ``sample`` and ``seg_indices``
(``sim/own_nets.OwnNetSampler``).  Refused with ``NotImplementedError``:
the trust features, the engine's unported flags and population mode
(``sim/engine.refuse_special_simulator``).
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
from ..fl.optim import SGD
from ..models.segmentation import UNet, segmentation_metrics
from ..obs.metrics import MetricsLogger
from .engine import fit_loop, refuse_special_simulator
from .own_nets import OwnNetSampler, gather_lanes, grad_leaves, lane_copies

MOMENTUM = 0.9
TEST_ROWS = 256


def synthesize_masks(x: np.ndarray, y: np.ndarray, num_classes: int, seed: int = 0) -> np.ndarray:
    """``(n, H, W)`` int32 masks (reference L31): the image's class paints
    quadrant ``y % 4`` with ``y % num_classes``; the background is class 0.
    ``seed`` is unused, as there."""
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    masks = np.zeros((n, h, w), np.int32)
    quad = np.asarray(y) % 4
    hh, ww = h // 2, w // 2
    for q in range(4):
        r0, c0 = (q // 2) * hh, (q % 2) * ww
        for i in np.flatnonzero(quad == q):
            masks[i, r0:r0 + hh, c0:c0 + ww] = int(y[i]) % num_classes
    return masks


class FedSegSimulator:
    """FedSeg (reference L47) on ``device`` (the card unless the caller
    names another): :meth:`run` the fit loop, :meth:`run_round` one round,
    :meth:`evaluate` the test metrics."""

    def __init__(self, cfg: Config, dataset: FederatedDataset,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_FEDSEG)
        feat = tuple(dataset.train_x.shape[1:])
        if len(feat) != 3:
            raise ValueError(f"FedSeg needs (H, W, C) image data (got samples of shape {feat})")
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.num_classes = max(int(dataset.class_num), 2)
        self.model = UNet(num_classes=self.num_classes, base=int(cfg_extra(cfg, "seg_base")),
                          in_channels=feat[-1])
        self.root_key = rng.root_key(cfg.random_seed)
        self.variables = self.model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        if dataset.masks is not None:
            masks = np.asarray(dataset.masks, np.int32)
        else:
            masks = synthesize_masks(dataset.train_x, dataset.train_y, self.num_classes,
                                     cfg.random_seed)
        stacked = stack_clients(dataset, multiple_of=cfg.batch_size)
        self.counts, self.capacity = stacked.counts, stacked.capacity
        self._x = torch.from_numpy(stacked.x).to(self.device, torch.float32)
        # each client's masks, cyclically repeated as stack_clients repeats its rows
        m = np.stack([masks[np.resize(ix, self.capacity)] for ix in dataset.client_idx])
        self._m = torch.from_numpy(m).to(self.device, torch.long)
        self.steps = max(1, self.capacity // cfg.batch_size) * max(1, cfg.epochs)
        tx = np.ascontiguousarray(dataset.test_x[:TEST_ROWS], np.float32)
        if dataset.test_masks is not None:
            tm = np.asarray(dataset.test_masks[:TEST_ROWS], np.int32)
        else:
            tm = synthesize_masks(dataset.test_x[:TEST_ROWS], dataset.test_y[:TEST_ROWS],
                                  self.num_classes, cfg.random_seed)
        self._test = (torch.from_numpy(tx).to(self.device),
                      torch.from_numpy(tm).to(self.device, torch.long))
        n = dataset.n_clients
        self.sampler = sampler or OwnNetSampler(cfg.random_seed, n,
                                                min(cfg.client_num_per_round, n))
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0

    def local_train(self, sampled: np.ndarray, idx: torch.Tensor):
        """The sampled clients' local training as lanes: ``idx`` ``(L,
        steps, batch)`` rows a step (on the device).  Returns the lanes'
        models and mean losses ``(L,)``."""
        lanes = len(sampled)
        rows = torch.as_tensor(sampled, dtype=torch.long, device=self.device)
        opt = SGD(self.cfg.learning_rate, MOMENTUM)
        params = lane_copies(self.variables["params"], lanes)
        state = opt.init(params)
        loss_sum = torch.zeros(lanes, dtype=torch.float32, device=self.device)
        for s in range(idx.shape[1]):
            q, leaves = grad_leaves(params)
            logits, _ = self.model.apply({"params": q}, gather_lanes(self._x, rows, idx[:, s]))
            losses = cross_entropy_lanes(logits.to(torch.float32),
                                         gather_lanes(self._m, rows, idx[:, s]))
            grads = pt.tree_unflatten_like(params, torch.autograd.grad(losses.sum(), leaves))
            params, state = opt.update(grads, state, q)
            loss_sum = loss_sum + losses.detach()
        return {"params": params}, loss_sum / idx.shape[1]

    def run_round(self) -> dict:
        r, bs = self.round_idx, self.cfg.batch_size
        sampled = np.array(self.sampler.sample(r))
        idx = torch.stack([self.sampler.seg_indices(r, int(c), self.steps, self.capacity, bs)
                           for c in sampled]).to(self.device)
        stacked, losses = self.local_train(sampled, idx)
        w = torch.as_tensor(self.counts[sampled], dtype=torch.float32, device=self.device)
        self.variables = pt.tree_weighted_mean(stacked, w)
        self.round_idx += 1
        return {"train_loss": float(losses.mean())}

    @torch.no_grad()
    def evaluate(self) -> dict:
        tx, tm = self._test
        logits, _ = self.model.apply(self.variables, tx, train=False)
        return {k: float(v) for k, v in
                segmentation_metrics(logits, tm, self.num_classes).items()}

    def run(self) -> list[dict]:
        return fit_loop(self.run_round, self.evaluate, self.cfg, self.logger)
