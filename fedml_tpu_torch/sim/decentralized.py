"""Decentralized FL: DSGD, PushSum and ring gossip over mixing matrices
(the port of ``fedml_tpu/sim/decentralized.py``).

Every one of the ``n`` clients keeps its own variables, stacked over the
clients (a leading axis of ``n`` on every leaf).  A round, as the
reference runs it::

    every client trains from its own variables          (n lanes, one call)
    variables <- the mix of the trained variables        (every leaf)

The ``n`` clients train as the lanes of one batched local train
(``fl/local_sgd.make_batched_local_train_fn``, which takes lane-stacked
starting variables), each from its own model: the reference's ``jax.vmap``
of ``make_local_train_fn``.  The mix applies to every leaf,
``batch_stats`` included:

- ``dsgd`` (``extra.decentralized_mode`` unset or ``dsgd``): ``W @ leaf``
  in f32, cast back to the leaf's dtype, ``W`` the symmetric row-stochastic
  ring plus ``topology_neighbor_num - 2`` random links a node
  (``parallel/topology.symmetric_topology``, seeded by ``random_seed``);
- ``pushsum``: ``W`` the column-stochastic directed ring plus random
  out-links; each leaf is first multiplied by the push weights, mixed, and
  divided by the new weights ``W @ push_w``, so ``x / w`` tends to the
  uniform average on a directed graph;
- ``ring``: the reference's halo mix on a one-device mesh, ``(x + left +
  right) / 3.0`` in f32 in that order, ``left`` / ``right`` the lane axis
  rolled by +1 / -1; the ``(n, n)`` matrix is never built
  (``ring_topology`` stays the reference the tests hold it to).  It needs
  ``n >= 3`` (with two clients ``left`` and ``right`` are the same
  neighbour, which the halo mix would weight twice).

The mixing product is plain torch (the reference computes it outside
Pallas).  :meth:`DecentralizedSimulator.consensus_model` is the f32 mean
over clients, cast back; :meth:`~DecentralizedSimulator.evaluate` tests it.

Randomness goes through a sampler object with ``perms(r, client, epochs,
cap)`` and, for a model with dropout, ``dropout(r, client, n_steps, shape,
keep_prob, device)``: the engine's :class:`~.engine.ClientSampler` keys
client ``i`` of round ``r`` from ``client_key(round_key(root, r), i)`` as
the reference does; a test can hand in the reference's.

Refused with ``NotImplementedError``: the trust features (as the reference's
runner refuses them for this simulator), the engine's unported flags,
``extra.aot_programs`` among them (``ROADMAP.md`` Queue 1 item 10), and
``extra.population_store``, which only the engine serves.
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
from ..data.dataset import FederatedDataset
from ..fl.local_sgd import lane_dropout_table, make_batched_local_train_fn, to_device
from ..obs.metrics import MetricsLogger
from ..parallel import topology as topo
from .engine import (ClientSampler, client_dropout, fit_loop, place_clients, place_test_set,
                     refuse_special_simulator)

MODES = ("dsgd", "pushsum", "ring")


def mixing_matrix(mode: str, n: int, neighbor_num: int, seed: int) -> np.ndarray:
    """The round's ``(n, n)`` f32 mixing matrix of ``mode`` (reference
    L58-85); for ``ring`` the matrix the halo mix equals."""
    if mode == "pushsum":
        return topo.column_stochastic(topo.asymmetric_topology(n, neighbor_num, seed=seed))
    if mode == "ring":
        if n < 3:
            raise ValueError(f"mode='ring' needs n >= 3 clients (got {n}); use mode='dsgd' "
                             "for 1-2 clients")
        return topo.ring_topology(n)
    return topo.symmetric_topology(n, neighbor_num, seed=seed)


def matrix_mix(W: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``W @ leaf`` over the lane axis in f32, cast back to the leaf's dtype
    (reference ``tensordot(W, leaf, ([1], [0]))``)."""
    n = leaf.shape[0]
    out = W.matmul(leaf.to(torch.float32).reshape(n, -1))
    return out.reshape(leaf.shape).to(leaf.dtype)


def ring_mix(leaf: torch.Tensor) -> torch.Tensor:
    """The halo mix on one device (reference L153-166): ``(x + left +
    right) / 3`` in f32 in that order, ``left[j] = x[j - 1]``, ``right[j] =
    x[j + 1]`` around the ring; an IEEE division by a device scalar."""
    x = leaf.to(torch.float32)
    left = torch.roll(x, 1, 0)
    right = torch.roll(x, -1, 0)
    return ((x + left + right) / x.new_full((), 3.0)).to(leaf.dtype)


class DecentralizedSimulator:
    """``decentralized_fl`` on ``device`` (the card unless the caller names
    another): :meth:`run` is the fit loop, :meth:`run_round` one round of
    local training and gossip, :meth:`evaluate` the consensus model's test
    eval."""

    def __init__(self, cfg: Config, dataset: FederatedDataset, model, mode: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_DECENTRALIZED_FL)
        self.cfg = cfg
        self.dataset = dataset
        self.model = model
        self.device = resolve_device(device)
        self.mode = mode or cfg_extra(cfg, "decentralized_mode") or "dsgd"
        if self.mode not in MODES:
            raise ValueError(f"unknown decentralized_mode {self.mode!r} (known: {MODES})")
        n = dataset.n_clients
        self.n = n
        stacked, self.hp, self._data = place_clients(cfg, dataset, self.device)
        self.capacity = stacked.capacity
        self.counts = stacked.counts
        self._train = make_batched_local_train_fn(model, self.hp)
        neighbor_num = int(cfg_extra(cfg, "topology_neighbor_num") or 2)
        self.W_host = mixing_matrix(self.mode, n, neighbor_num, cfg.random_seed)
        self.W = torch.from_numpy(self.W_host).to(self.device)
        self._lanes = to_device(np.arange(n), self.device, torch.long)
        self.sampler = sampler or ClientSampler(cfg.random_seed, n, n)
        self.root_key = rng.root_key(cfg.random_seed)
        one = model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        # every client starts from the same initial variables
        self.client_vars = pt.tree_map(
            lambda t: t.unsqueeze(0).repeat((n,) + (1,) * t.ndim), one)
        self.push_weights = torch.ones(n, dtype=torch.float32, device=self.device)
        self._test, self._eval_fn = place_test_set(cfg, dataset, model, self.hp, self.device)
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0

    def mix(self, tree):
        """The round's gossip applied to every leaf of a client-stacked
        tree."""
        if self.mode == "ring":
            return pt.tree_map(ring_mix, tree)
        return pt.tree_map(lambda leaf: matrix_mix(self.W, leaf), tree)

    def _round(self) -> dict:
        """One round (reference ``round_fn`` L180); its metrics as 0-d
        tensors on the device."""
        r = self.round_idx
        clients = range(self.n)
        perms = to_device(torch.stack([self.sampler.perms(r, c, self.hp.epochs, self.capacity)
                                       for c in clients]), self.device, torch.long)
        drops = client_dropout(self.sampler, self.model, self.hp, r, clients, self.counts,
                               self.device)
        dropout = None if drops is None else lane_dropout_table(drops)
        trained, metrics = self._train(self.client_vars, self._data[0], self._data[1],
                                       self._lanes, self.counts, perms, None, dropout)
        with torch.no_grad():
            if self.mode == "pushsum":
                # mix the weighted variables and the weights, then de-bias
                w = self.push_weights
                mixed = self.mix(pt.tree_map(lambda t: t * pt.per_lane(w, t), trained))
                new_w = self.W.matmul(w)
                self.client_vars = pt.tree_map(lambda t: t / pt.per_lane(new_w, t), mixed)
                self.push_weights = new_w
            else:
                self.client_vars = self.mix(trained)
        self.round_idx += 1
        return {k: v.to(torch.float32).mean() for k, v in metrics.items()}

    def run_round(self) -> dict:
        """One round; its host metrics (one device sync)."""
        return {k: float(v) for k, v in self._round().items()}

    @torch.no_grad()
    def consensus_model(self) -> dict:
        """The clients' mean model (f32 mean, cast back): the consensus
        point."""
        return pt.tree_map(lambda t: t.to(torch.float32).mean(0).to(t.dtype), self.client_vars)

    @torch.no_grad()
    def consensus_distance(self) -> float:
        """Mean over clients of the squared distance to the consensus,
        summed over leaves in the reference's order (reference L220)."""
        mean = self.consensus_model()
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for leaf, m in zip(pt.tree_leaves(self.client_vars), pt.tree_leaves(mean)):
            d = (leaf.to(torch.float32) - m.unsqueeze(0).to(torch.float32)) ** 2
            total = total + d.reshape(d.shape[0], -1).sum(1).mean()
        return float(total)

    def evaluate(self) -> dict:
        res = self._eval_fn(self.consensus_model(), *self._test)
        return {k: float(v) for k, v in res.items()}

    def run(self) -> list[dict]:
        """The fit loop (reference ``run``): each round timed on the host,
        the consensus model tested and its distance read at the test
        cadence and at the last round."""
        return fit_loop(self.run_round,
                        lambda: {**self.evaluate(), "consensus_dist": self.consensus_distance()},
                        self.cfg, self.logger)
