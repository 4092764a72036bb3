"""Turbo-Aggregate: multi-group ring aggregation with additive masks (the
port of ``fedml_tpu/sim/turboaggregate.py``).

The reference implements the protocol its name gives (So, Guler,
Avestimehr 2021) in float: a round's sampled clients train (here as the
lanes of one batched local train, the reference's ``jax.vmap``), each
client's variables flatten into the reference's flat vector
(``core.pytree.stacked_tree_to_matrix``: flax kernels, JAX leaf order,
``batch_stats`` included; 271,098 elements for ResNet-20), then::

    alive   = RandomState(1000 + r).rand(m) >= ta_dropout_prob  (one kept)
    w       = counts * alive / sum                               (f32)
    groups  = np.array_split(the alive lanes, ta_group_num)
    for each non-empty group g, in ring order:
        masked   = u_g * w_g + N(0, 1) * 10        (kernel 7, sigma 10)
        the next group observes only masked rows and the running sum
        running += masked.sum(0);  mask_sum += (N(0, 1) * 10).sum(0)
    global  = unravel(running - mask_sum)

Each group's masked rows are kernel 7's function, ``x + noise * sigma``:
they go through ``ops/noise.apply_gaussian_noise``, one launch a non-empty
group at ``members x 271,098`` elements, the rows laid end to end with a
flat draw.  The mask total is plain torch.  :attr:`observed_by_group` keeps
host copies of what each group observed (its masked rows and the running
sum it received), the audit the tests read: no group sees a client's model
in the clear, only within noise of scale 10 (masking within noise, not the
finite-field guarantee of the cross-silo SecAgg stack).

Randomness goes through a sampler object: ``sample(r)``, ``perms(r,
client, epochs, cap)``, ``ta_masks(r, group, shape, device)`` (the group's
N(0, 1) draw, which the reference takes from ``normal(fold_in(fold_in(
fold_in(round_key, 0x7A), g), 7))``) and, for a model with dropout,
``dropout(...)``.  :class:`TASampler` derives them with the port's
generators; a test can hand in the reference's.
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
from ..ops.noise import apply_gaussian_noise
from ..weights import flatten_reference
from .engine import (ClientSampler, client_dropout, fit_loop, place_clients, place_test_set,
                     refuse_special_simulator)

MASK_SIGMA = 10.0  # the masks' scale, far above an update's
_RING_TAG = 0x7A  # the round key's fold for the ring's masks
_MASK_TAG = 7  # a group key's fold for its draw


class TASampler(ClientSampler):
    """The default source of a round's randomness: the engine's sampled ids
    and permutations, and each group's N(0, 1) mask draw from
    ``fold_in(fold_in(fold_in(round_key, 0x7A), g), 7)``."""

    def ta_masks(self, round_idx: int, group: int, shape: tuple, device) -> torch.Tensor:
        key = rng.fold_in(rng.fold_in(rng.fold_in(rng.round_key(self.root, round_idx),
                                                  _RING_TAG), group), _MASK_TAG)
        return torch.randn(shape, generator=rng.generator(key, device), device=device)


class TurboAggregateSimulator:
    """``TA`` on ``device`` (the card unless the caller names another):
    :meth:`run` is the fit loop, :meth:`run_round` one round,
    :meth:`evaluate` the global test eval."""

    def __init__(self, cfg: Config, dataset: FederatedDataset, model,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_TURBO_AGGREGATE)
        self.cfg = cfg
        self.dataset = dataset
        self.model = model
        self.device = resolve_device(device)
        self.n_groups = max(2, int(cfg_extra(cfg, "ta_group_num")))
        self.dropout_prob = float(cfg_extra(cfg, "ta_dropout_prob"))
        stacked, self.hp, self._data = place_clients(cfg, dataset, self.device)
        self.capacity = stacked.capacity
        self.counts = stacked.counts
        self._train = make_batched_local_train_fn(model, self.hp)
        n = dataset.n_clients
        self.sampler = sampler or TASampler(cfg.random_seed, n, min(cfg.client_num_per_round, n))
        self.root_key = rng.root_key(cfg.random_seed)
        self.global_vars = model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        self._test, self._eval_fn = place_test_set(cfg, dataset, model, self.hp, self.device)
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0
        # the audit: host copies of what each group observed (last round)
        self.observed_by_group: list[list[np.ndarray]] = []
        # the last round's sampled ids, survivors, weights (on the device),
        # groups (lane indices, empty ones too) and row 7's launch lengths
        self.last_round: dict = {}

    # -- the ring protocol ---------------------------------------------------
    @torch.no_grad()
    def _ring_aggregate(self, flat: torch.Tensor, weights: torch.Tensor, groups: list,
                        r: int) -> torch.Tensor:
        """The weighted sum over clients through the masked group ring
        (reference L72): ``flat`` the ``(m, d)`` flat client vectors,
        ``weights`` their ``(m,)`` f32 weights."""
        d = flat.shape[1]
        running = torch.zeros(d, dtype=torch.float32, device=flat.device)
        mask_sum = torch.zeros(d, dtype=torch.float32, device=flat.device)
        sigma = flat.new_full((), MASK_SIGMA)
        self.observed_by_group = []
        lengths = []
        for g, members in enumerate(groups):
            if len(members) == 0:
                self.observed_by_group.append([])
                continue
            rows = to_device(members, flat.device, torch.long)
            noise = self.sampler.ta_masks(r, g, (len(members), d), flat.device)
            x = flat.index_select(0, rows) * weights.index_select(0, rows)[:, None]
            masked = apply_gaussian_noise(x.reshape(-1), noise.reshape(-1),
                                          MASK_SIGMA).reshape(len(members), d)
            # the next group in the ring receives only masked rows and the
            # running partial sum (host copies kept for the audit)
            self.observed_by_group.append(list(masked.cpu().numpy())
                                          + [running.cpu().numpy()])
            running = running + masked.sum(0)
            mask_sum = mask_sum + (noise * sigma).sum(0)
            lengths.append(masked.numel())
        self.last_round.update(groups=list(groups), lengths=lengths)
        # the final hop: the server removes the telescoped mask total
        return running - mask_sum

    def _round(self) -> dict:
        cfg = self.cfg
        r = self.round_idx
        sampled = np.asarray(self.sampler.sample(r), dtype=np.int64)
        m = len(sampled)
        counts = self.counts[sampled]
        perms = to_device(torch.stack([self.sampler.perms(r, int(c), self.hp.epochs,
                                                          self.capacity) for c in sampled]),
                          self.device, torch.long)
        drops = client_dropout(self.sampler, self.model, self.hp, r, sampled, counts,
                               self.device)
        start = pt.tree_map(lambda t: t.unsqueeze(0).expand((m,) + t.shape), self.global_vars)
        trained, metrics = self._train(start, self._data[0], self._data[1],
                                       to_device(sampled, self.device, torch.long), counts,
                                       perms, None,
                                       None if drops is None else lane_dropout_table(drops))
        with torch.no_grad():
            mat = pt.stacked_tree_to_matrix(trained)
        # per-client dropout (the reference's TA_Client.set_dropout flag)
        alive = np.random.RandomState(1000 + r).rand(m) >= self.dropout_prob
        if not alive.any():
            alive[0] = True
        w = np.asarray(counts, np.float64) * alive
        weights = to_device((w / w.sum()).astype(np.float32), self.device)
        groups = np.array_split(np.flatnonzero(alive), self.n_groups)
        agg = self._ring_aggregate(mat, weights, groups, r)
        self.global_vars = flatten_reference(self.global_vars)[1](agg)
        self.last_round.update(sampled=sampled, alive=alive, weights=weights)
        self.round_idx += 1
        out = {k: v.to(torch.float32).mean() for k, v in metrics.items()}
        out["alive"] = torch.tensor(float(alive.sum()))
        return out

    def run_round(self) -> dict:
        """One round; its host metrics (one device sync)."""
        return {k: float(v) for k, v in self._round().items()}

    def evaluate(self) -> dict:
        return {k: float(v) for k, v in self._eval_fn(self.global_vars, *self._test).items()}

    def run(self) -> list[dict]:
        """The fit loop (reference ``run``): each round timed on the host,
        the global tested at the test cadence and at the last round."""
        return fit_loop(self.run_round, self.evaluate, self.cfg, self.logger)
