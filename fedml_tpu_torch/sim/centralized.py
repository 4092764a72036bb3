"""Centralized (non-federated) training, FedML's accuracy baseline (the
port of ``fedml_tpu/sim/centralized.py``; ``training_type:
centralized``).

The whole training set is one client: its rows tiled cyclically to a
multiple of the batch size (``np.resize``), kept on the device.  Each of the
``comm_round`` rounds is one call of the single-lane local train
(``fl/local_sgd.make_local_train_fn``) over ``epochs`` passes of the set,
then a test evaluation.  The local train's budget is ``epochs * ceil(n /
batch)`` steps (391 a pass of 50,000 images at batch 128).

Randomness goes through a sampler object with ``perms(r, epochs, cap)``
and, for a model with dropout, ``dropout(r, n_steps, shape, keep_prob,
device)``: :class:`CentralSampler` keys round ``r`` from ``round_key(root,
r)``, as the reference does, with the port's generators; a test can hand
in the reference's.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..algorithms import hparams_from_config
from ..arguments import Config
from ..core import rng
from ..core.device import resolve_device
from ..data.dataset import FederatedDataset
from ..fl.local_sgd import dropout_masks, dropout_spec, epoch_permutations, make_local_train_fn
from ..obs.metrics import MetricsLogger
from .engine import _labels, fit_loop, place_test_set


class CentralSampler:
    """The default source of a round's randomness: the permutations and
    keep-masks of round ``r`` from ``round_key(root, r)``."""

    def __init__(self, seed: int):
        self.root = rng.root_key(seed)

    def perms(self, round_idx: int, epochs: int, cap: int) -> torch.Tensor:
        return epoch_permutations(rng.round_key(self.root, round_idx), epochs, cap)

    def dropout(self, round_idx: int, n_steps: int, shape: tuple, keep_prob: float,
                device) -> torch.Tensor:
        return dropout_masks(rng.round_key(self.root, round_idx), n_steps, shape, keep_prob,
                             device)


class CentralizedTrainer:
    """Centralized training on ``device`` (the card unless the caller names
    another): :meth:`run` is the fit loop, a round a call of the local
    train, each followed by the test evaluation."""

    def __init__(self, cfg: Config, dataset: FederatedDataset, model,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        self.cfg = cfg
        self.dataset = dataset
        self.model = model
        self.device = resolve_device(device)
        n = dataset.train_x.shape[0]
        self.n_real = int(n)
        self.hp = hparams_from_config(cfg, steps_per_epoch=max(1, math.ceil(n / cfg.batch_size)))
        self._train = make_local_train_fn(model, self.hp)
        self.capacity = self.hp.steps_per_epoch * cfg.batch_size
        reps = np.resize(np.arange(n), self.capacity)  # cyclic tile to a batch multiple
        x = torch.from_numpy(np.ascontiguousarray(dataset.train_x[reps]))
        if self.hp.compute_dtype == "bfloat16" and x.is_floating_point():
            x = x.to(torch.bfloat16)  # local training casts its batches to it anyway
        self._x = x.to(self.device)
        self._y = _labels(np.ascontiguousarray(dataset.train_y[reps]), self.device)
        self.sampler = sampler or CentralSampler(cfg.random_seed)
        self.root_key = rng.root_key(cfg.random_seed)
        self.variables = model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        self._test, self._eval = place_test_set(cfg, dataset, model, self.hp, self.device)
        self.round_idx = 0
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)

    def run_round(self) -> dict:
        """The next round's local train over the whole set; host metrics."""
        r = self.round_idx
        perms = self.sampler.perms(r, self.hp.epochs, self.capacity)
        dropout = None
        shape = dropout_spec(self.model, self.hp.batch_size)
        if shape is not None:
            dropout = self.sampler.dropout(r, self.hp.epochs * self.hp.steps_per_epoch, shape,
                                           self.model.keep_prob, self.device)
        self.variables, metrics = self._train(self.variables, self._x, self._y, self.n_real,
                                              rng.round_key(self.root_key, r), perms=perms,
                                              dropout=dropout)
        self.round_idx += 1
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self) -> dict:
        return {k: float(v) for k, v in self._eval(self.variables, *self._test).items()}

    def run(self) -> list[dict]:
        """The fit loop (reference ``run``): each round timed on the host,
        then tested."""
        return fit_loop(self.run_round, self.evaluate, self.cfg, self.logger, every_round=True)
