"""Hierarchical FL: groups run sub-rounds, then a global aggregate (the port
of ``fedml_tpu/sim/hierarchical.py``).

A global round, as the reference runs it::

    every group's model <- the global model
    for each of group_comm_round sub-rounds:
        the sampled clients train, each from its group's model   (lanes)
        each group <- the sample-weighted mean of its sampled members
                      (a group with none keeps its model)
    global <- the groups' models weighted by each group's sample mass

Each sub-round is one batched local train of the sampled clients as lanes
(``fl/local_sgd.make_batched_local_train_fn``), each lane starting from its
group's model: the reference's ``jax.vmap`` of ``make_local_train_fn``.
The reference always runs that vmapped form, so the port has the one form
whatever ``backend_sim`` says.  The group sums are one f32 ``index_add_``
over the lanes (:func:`segment_group_sums`, the reference's
``segment_sum``).  With ``client_num_per_round < client_num_in_total`` each
sub-round samples its clients from all of them; with everyone, every
client trains in every sub-round.

Groups (``group_num``): ``extra.group_assignment: balanced`` (the default)
assigns clients to groups by the LPT min-makespan schedule of their sample
counts, ``round_robin`` as ``arange(n) % G`` (``sched/seq_scheduler.py``).

Randomness goes through a sampler object (``sample(r, s)``, ``perms(r, s,
client, epochs, cap)`` and, for a model with dropout, ``dropout(r, s,
client, n_steps, shape, keep_prob, device)``): :class:`SubRoundSampler`
keys them as the reference does, sub-round ``s`` of round ``r`` from
``fold_in(round_key(root, r), s)``, with the port's generators; a test can
hand in the reference's.

Refused with ``NotImplementedError``: the trust features (as the reference
refuses them for this simulator), the engine's unported flags (the AOT
store, the profiler, OTLP export), and round checkpointing, which the
reference's hierarchical simulator does not have (it ignores the keys).
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
from ..fl.local_sgd import (dropout_masks, dropout_spec, epoch_permutations, lane_dropout_table,
                            make_batched_local_train_fn, step_budgets, to_device)
from ..obs.metrics import MetricsLogger
from ..sched.seq_scheduler import SeqTrainScheduler, round_robin_groups
from .engine import fit_loop, place_clients, place_test_set, refuse_special_simulator


def refuse_unported_hierarchical(cfg: Config) -> None:
    """Raise for what this simulator does not serve."""
    refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_HIERARCHICAL_FL)
    if cfg.checkpoint_dir or cfg.checkpoint_every_rounds or cfg.resume:
        # the reference's hierarchical simulator has no round checkpoint (it
        # ignores these keys); the port refuses them rather than add one
        raise NotImplementedError("checkpointing is not served by the 'HierarchicalFL' "
                                  "simulator (the reference has none there)")


def segment_group_sums(leaf: torch.Tensor, w_sel: torch.Tensor, g_sel: torch.Tensor,
                       num_groups: int) -> torch.Tensor:
    """Per-group weighted sums ``sum_c w_c * x_c`` of one lane-stacked leaf
    (reference L47): f32 multiply, then one ``index_add_`` of the lanes
    into their groups' rows."""
    wleaf = leaf.to(torch.float32) * pt.per_lane(w_sel, leaf)
    out = torch.zeros((num_groups,) + tuple(leaf.shape[1:]), dtype=torch.float32,
                      device=leaf.device)
    return out.index_add_(0, g_sel, wleaf)


class SubRoundSampler:
    """The default source of a sub-round's randomness, keyed as the
    reference keys it (module docstring)."""

    def __init__(self, seed: int, n_total: int, per_round: int):
        self.root = rng.root_key(seed)
        self.n_total = n_total
        self.per_round = per_round

    def _skey(self, round_idx: int, sub: int) -> rng.Key:
        return rng.fold_in(rng.round_key(self.root, round_idx), sub)

    def sample(self, round_idx: int, sub: int) -> np.ndarray:
        return rng.sample_clients(self._skey(round_idx, sub), sub, self.n_total, self.per_round)

    def perms(self, round_idx: int, sub: int, client: int, epochs: int, cap: int) -> torch.Tensor:
        return epoch_permutations(rng.client_key(self._skey(round_idx, sub), client), epochs, cap)

    def dropout(self, round_idx: int, sub: int, client: int, n_steps: int, shape: tuple,
                keep_prob: float, device) -> torch.Tensor:
        key = rng.client_key(self._skey(round_idx, sub), client)
        return dropout_masks(key, n_steps, shape, keep_prob, device)


class HierarchicalSimulator:
    """``HierarchicalFL`` on ``device`` (the card unless the caller names
    another): :meth:`run` is the fit loop, :meth:`run_round` one global
    round, :meth:`evaluate` the global test eval."""

    def __init__(self, cfg: Config, dataset: FederatedDataset, model,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_unported_hierarchical(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.model = model
        self.device = resolve_device(device)
        n = dataset.n_clients
        self.group_num = max(1, int(cfg.group_num))
        self.group_comm_round = max(1, int(cfg.group_comm_round))

        stacked, self.hp, self._data = place_clients(cfg, dataset, self.device)
        self.capacity = stacked.capacity
        self.counts = stacked.counts
        if cfg_extra(cfg, "group_assignment") == "balanced":
            # equal sample mass per group: with ragged Dirichlet shards,
            # round-robin groups can differ by 10x in total work
            sched = SeqTrainScheduler(np.asarray(stacked.counts, np.float64),
                                      self.group_num).schedule_lpt()
            group_of = np.empty(n, np.int32)
            for g, members in enumerate(sched.assignment):
                group_of[np.asarray(members, np.int64)] = g
        else:
            group_of = round_robin_groups(n, self.group_num)
        self.group_of = group_of
        self._train = make_batched_local_train_fn(model, self.hp)
        self.per_round = min(max(1, int(cfg.client_num_per_round)), n)
        self.sampler = sampler or SubRoundSampler(cfg.random_seed, n, self.per_round)
        self.root_key = rng.root_key(cfg.random_seed)
        self.global_vars = model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        # the global aggregate's weights: each group's sample mass (integer
        # counts, so the f64 host sums are exact in f32)
        self._group_mass = to_device(
            np.bincount(group_of, weights=stacked.counts, minlength=self.group_num),
            self.device, torch.float32)
        self._test, self._eval_fn = place_test_set(cfg, dataset, model, self.hp, self.device)
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0

    def _sub_round(self, group_vars: dict, r: int, s: int) -> tuple[dict, dict]:
        """One sub-round: the sampled clients train as lanes from their
        groups' models, then each group with a sampled member takes their
        sample-weighted mean."""
        n = self.dataset.n_clients
        idx = (np.arange(n) if self.per_round == n
               else np.asarray(self.sampler.sample(r, s), dtype=np.int64))
        g_sel = self.group_of[idx]
        counts = self.counts[idx]
        lanes = to_device(idx, self.device, torch.long)
        g_lanes = to_device(g_sel, self.device, torch.long)
        perms = torch.stack([self.sampler.perms(r, s, int(ci), self.hp.epochs, self.capacity)
                             for ci in idx])
        dropout = None
        shape = dropout_spec(self.model, self.hp.batch_size)
        if shape is not None:
            steps = np.minimum(step_budgets(self.hp, counts),
                               self.hp.epochs * self.hp.steps_per_epoch)
            dropout = lane_dropout_table([
                self.sampler.dropout(r, s, int(ci), int(k), shape, self.model.keep_prob,
                                     self.device) for ci, k in zip(idx, steps)])
        start = pt.tree_take(group_vars, g_lanes)
        trained, metrics = self._train(start, self._data[0], self._data[1], lanes, counts,
                                       perms, None, dropout)
        w_sel = to_device(counts, self.device, torch.float32)
        wsum = np.bincount(g_sel, weights=counts, minlength=self.group_num)
        denom = to_device(np.maximum(wsum, 1e-12), self.device, torch.float32)
        keep = to_device(wsum > 0, self.device, torch.bool)

        def group_mean(leaf, old):
            mean = segment_group_sums(leaf, w_sel, g_lanes, self.group_num) / pt.per_lane(
                denom, old)
            return torch.where(pt.per_lane(keep, old), mean, old.to(torch.float32)).to(old.dtype)

        with torch.no_grad():
            return pt.tree_map(group_mean, trained, group_vars), metrics

    def _round(self) -> dict:
        """One global round; its metrics as 0-d tensors on the device."""
        r = self.round_idx
        group_vars = pt.tree_map(
            lambda t: t.unsqueeze(0).repeat((self.group_num,) + (1,) * t.ndim), self.global_vars)
        metrics = []
        for s in range(self.group_comm_round):
            group_vars, m = self._sub_round(group_vars, r, s)
            metrics.append(m)
        self.global_vars = pt.tree_weighted_mean(group_vars, self._group_mass)
        self.round_idx += 1
        return {k: torch.cat([m[k] for m in metrics]).to(torch.float32).mean()
                for k in metrics[0]}

    def run_round(self) -> dict:
        """One global round; its host metrics (one device sync)."""
        return {k: float(v) for k, v in self._round().items()}

    def evaluate(self) -> dict:
        return {k: float(v) for k, v in self._eval_fn(self.global_vars, *self._test).items()}

    def run(self) -> list[dict]:
        """The fit loop (reference ``run``): every round timed on the host,
        evaluation at the test cadence and at the last round."""
        return fit_loop(self.run_round, self.evaluate, self.cfg, self.logger)
