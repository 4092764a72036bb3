"""Asynchronous FedAvg: staleness-weighted server updates with no round
barrier (the port of ``fedml_tpu/sim/async_fl.py``).

Server steps ``t = 0, 1, 2, ...``: at each step one client arrives having
trained from the global model of version ``t - s``, ``s`` its staleness.
The last :data:`HISTORY` globals are a ring buffer on the device (a leading
axis of 8 on every leaf), so a stale start is a row of it.  The arriving
client trains with the single-lane ``make_local_train_fn`` from
``history[(t - s) % 8]``, and the server mixes::

    g' = (1 - a) * g + a * trained      (f32, cast back),  a = staleness_factor(s)

``staleness_factor`` is FedAsync's (Xie et al.): ``constant`` (``alpha``),
``polynomial`` (``alpha * (s + 1) ** -0.5``) or ``hinge`` (``alpha / (1 +
max(s - 4, 0))``), from ``async_staleness_func`` and
``async_staleness_alpha``.

Randomness goes through a sampler object: ``arrival(t) -> (client,
staleness)``, ``perms(t, client, epochs, cap)`` and, for a model with
dropout, ``dropout(t, client, n_steps, shape, keep_prob, device)``.
:class:`ArrivalSampler` draws the client uniformly from the ``n`` clients and
the staleness uniformly below ``min(8, t + 1)`` from the step's key with
the port's generators (the reference draws both from ``fold_in(step_key,
1)`` and ``fold_in(step_key, 2)``); a test can hand in the reference's.
``comm_round`` counts server steps (client arrivals).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as C
from ..arguments import Config
from ..core import pytree as pt
from ..core import rng
from ..core.device import resolve_device
from ..data.dataset import FederatedDataset
from ..fl.local_sgd import make_local_train_fn
from ..obs.metrics import MetricsLogger
from .engine import (ClientSampler, client_dropout, fit_loop, place_clients, place_test_set,
                     refuse_special_simulator)

HISTORY = 8  # ring buffer depth == the most staleness


def staleness_factor(kind: str, s, alpha: float) -> torch.Tensor:
    """The mixing weight of an update ``s`` steps stale, f32 (reference
    L35)."""
    s = torch.as_tensor(s).to(torch.float32)
    if kind == "constant":
        return torch.full_like(s, alpha)
    if kind == "polynomial":
        return alpha * (s + 1.0) ** -0.5
    if kind == "hinge":
        return alpha / (1.0 + torch.clamp(s - 4.0, min=0.0))
    raise ValueError(f"unknown staleness function {kind!r}")


class ArrivalSampler(ClientSampler):
    """The default source of a step's randomness: the arriving client and
    its staleness from the step's key, the client's permutations from its
    client key (``ClientSampler``, the step index as the round)."""

    def arrival(self, step: int) -> tuple[int, int]:
        skey = rng.round_key(self.root, step)
        client = int(torch.randint(0, self.n_total, (), generator=rng.generator(
            rng.fold_in(skey, 1))))
        staleness = int(torch.randint(0, min(HISTORY, step + 1), (), generator=rng.generator(
            rng.fold_in(skey, 2))))
        return client, staleness


class AsyncSimulator:
    """``Async_FedAvg`` on ``device`` (the card unless the caller names
    another): :meth:`run` is the fit loop over server steps,
    :meth:`run_step` one arrival, :meth:`evaluate` the global test eval."""

    def __init__(self, cfg: Config, dataset: FederatedDataset, model,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_ASYNC_FEDAVG)
        self.cfg = cfg
        self.dataset = dataset
        self.model = model
        self.device = resolve_device(device)
        stacked, self.hp, self._data = place_clients(cfg, dataset, self.device)
        self.capacity = stacked.capacity
        self.counts = stacked.counts
        self._train = make_local_train_fn(model, self.hp)
        n = dataset.n_clients
        self.sampler = sampler or ArrivalSampler(cfg.random_seed, n, n)
        self.root_key = rng.root_key(cfg.random_seed)
        self.global_vars = model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        # the ring buffer of past globals (the stale starting points)
        self.history = pt.tree_map(
            lambda t: t.unsqueeze(0).repeat((HISTORY,) + (1,) * t.ndim), self.global_vars)
        self.alpha = float(cfg.async_staleness_alpha)
        self.staleness_kind = cfg.async_staleness_func
        staleness_factor(self.staleness_kind, 0, self.alpha)  # an unknown kind raises here
        self.step_idx = 0
        self._test, self._eval_fn = place_test_set(cfg, dataset, model, self.hp, self.device)
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)

    def run_step(self) -> dict:
        """One arrival (reference ``step_fn`` L88): the client trains from
        the stale global it holds, the server mixes its model in."""
        t = self.step_idx
        client, staleness = self.sampler.arrival(t)
        start = pt.tree_map(lambda h: h[(t - staleness) % HISTORY], self.history)
        perms = self.sampler.perms(t, client, self.hp.epochs, self.capacity)
        drops = client_dropout(self.sampler, self.model, self.hp, t, [client],
                               self.counts[[client]], self.device)
        trained, metrics = self._train(
            start, self._data[0][client], self._data[1][client], int(self.counts[client]),
            rng.client_key(rng.round_key(self.root_key, t), client), perms=perms,
            dropout=None if drops is None else drops[0])
        a = staleness_factor(self.staleness_kind, staleness, self.alpha).to(self.device)
        with torch.no_grad():
            self.global_vars = pt.tree_map(
                lambda g, tr: ((1.0 - a) * g.to(torch.float32)
                               + a * tr.to(torch.float32)).to(g.dtype),
                self.global_vars, trained)
            slot = (t + 1) % HISTORY
            pt.tree_map(lambda h, g: h[slot].copy_(g), self.history, self.global_vars)
        self.step_idx += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["staleness"] = float(staleness)
        out["client"] = client
        return out

    def evaluate(self) -> dict:
        return {k: float(v) for k, v in self._eval_fn(self.global_vars, *self._test).items()}

    def run(self) -> list[dict]:
        """The fit loop (reference ``run``): ``comm_round`` server steps,
        each timed on the host, the global tested at the test cadence and at
        the last step."""
        return fit_loop(self.run_step, self.evaluate, self.cfg, self.logger)
