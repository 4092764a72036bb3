"""MeshSimulator — the simulation round on one device.

The port of ``fedml_tpu/sim/engine.py``.  The backend is ``cfg.backend_sim``,
MESH when unset, as in the reference (its L151):

- MESH (the default; ``_run_round_mesh``, reference ``_make_round_fn`` and
  ``_gather_round_inputs``): every sampled client of the round is a lane of
  one batched round on the card, as the reference runs ``jax.vmap`` over
  them.  Each local step is one lane-batched forward and backward for all
  the lanes still active (``FedAlgorithm.client_update_lanes``;
  ``fl/local_sgd.make_batched_local_train_fn``), so each fused kernel site
  launches once a step for all lanes, not once a client.  One card is a
  lane multiple of 1: no pad lanes.
- ``sp`` (``_run_round_sp``, reference L821): the sequential twin, one
  client after another; ``tests/test_torch_mesh.py`` holds the two equal,
  as the reference's ``tests/test_m0_fedavg.py`` does.
- Multi-process backends (``MPI``, ``MULTIPROCESS``) raise
  ``NotImplementedError``.

    sampled  = sampler.sample(r)                                 (host)
    MESH: algorithm.client_update_lanes(all sampled, batched)    (the card)
    sp:   for each sampled client: algorithm.client_update       (the card)
    agg      = algorithm.aggregate(stacked contributions, counts)
    global'  = algorithm.server_update(agg)

Client data is stacked once (``data.dataset.stack_clients``) and kept on the
device in the compute dtype; a MESH step gathers its batch rows from that
stack.  Per-client algorithm state (FedSGD's EF-TopK residuals) is one
stacked tensor tree on the device, one row per client: the sampled clients'
rows are gathered (``core.pytree.tree_take``), and the new rows are written
back in place after the server step (``tree_scatter_``, the reference's
functional ``.at[sampled].set``).  ``run_rounds(n)`` on MESH keeps the
rounds' metrics on the device and syncs once, at the end of the chunk (the
reference's ``jit(scan(round))`` chunk has one host sync too); CUDA-graph
capture of rounds is a later slice.  Checkpointing, the AOT program store,
the profiler, OTLP export, trust hooks and population mode raise
``NotImplementedError``.

How to run either backend on the CPU: ``FedMLRunner(cfg,
device="cpu").run()`` with ``cfg.backend_sim`` unset / ``"MESH"`` or
``"sp"``.

Randomness goes through a sampler object (``sample(r)``, ``perms(r, client,
epochs, cap)``, ``uniform(r, client, shape, device)``): :class:`ClientSampler`
derives all three from the port's generators; a test can hand in one built
from the JAX package's keys.  Both backends take each client's draws from it,
a MESH lane those of its client.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..algorithms import create as create_algorithm, hparams_from_config
from ..arguments import Config
from ..core import pytree as pt
from ..core import rng
from ..core.device import resolve_device
from ..core.flags import cfg_extra
from ..data.dataset import FederatedDataset, pad_eval_set, stack_clients
from ..fl.local_sgd import epoch_permutations, make_eval_fn, to_device
from ..obs.metrics import MetricsLogger

# flags whose subsystems later slices port; setting one must not be a no-op
_UNPORTED_FLAGS = ("aot_programs", "profile_rounds", "otlp_endpoint", "population_store",
                   "cost_model_gauges")
_UNPORTED_TRUST = ("enable_attack", "enable_defense", "enable_dp", "enable_secagg",
                   "enable_fhe", "enable_contribution")
_MULTI_PROCESS = ("MULTIPROCESS", C.SIMULATION_BACKEND_MPI)


def _refuse_unported(cfg: Config) -> None:
    if cfg.backend_sim in _MULTI_PROCESS:
        raise NotImplementedError(f"backend_sim {cfg.backend_sim!r}: multi-process simulation "
                                  "is not ported yet")
    if cfg.checkpoint_dir or cfg.checkpoint_every_rounds or cfg.resume:
        raise NotImplementedError("checkpointing is not ported yet (first port slice)")
    for flag in _UNPORTED_FLAGS:
        if cfg_extra(cfg, flag):
            raise NotImplementedError(f"extra.{flag} is not ported yet (first port slice)")
    for flag in _UNPORTED_TRUST:
        if getattr(cfg, flag, False):
            raise NotImplementedError(f"{flag} is not ported yet (first port slice)")


def _mean(values: list) -> float:
    """Mean over clients of one metric (device tensors sync once here)."""
    if torch.is_tensor(values[0]):
        return float(torch.stack(values).mean())
    return float(np.mean(values))


class ClientSampler:
    """The default source of a round's randomness: sampled client ids from
    the round key, each client's per-epoch permutations and compression
    draw from its client key, all through the port's generators
    (``core/rng.py``)."""

    def __init__(self, seed: int, n_total: int, per_round: int):
        self.root = rng.root_key(seed)
        self.n_total = n_total
        self.per_round = per_round

    def sample(self, round_idx: int) -> np.ndarray:
        return rng.sample_clients(self.root, round_idx, self.n_total, self.per_round)

    def perms(self, round_idx: int, client: int, epochs: int, cap: int) -> torch.Tensor:
        key = rng.client_key(rng.round_key(self.root, round_idx), client)
        return epoch_permutations(key, epochs, cap)

    def uniform(self, round_idx: int, client: int, shape: tuple, device) -> torch.Tensor:
        """The client's ``U[0, 1)`` compression draw of this round, drawn on
        ``device`` (the reference folds ``(client key, 7)``; so does this)."""
        key = rng.fold_in(rng.client_key(rng.round_key(self.root, round_idx), client), 7)
        return torch.rand(shape, generator=rng.generator(key, device), device=device)


class MeshSimulator:
    """FedAvg-family and FedSGD simulation on ``device`` (the card unless the caller
    names another; see ``core/device.py``): :meth:`run` is the fit loop,
    :meth:`run_round` one round, :meth:`evaluate` the global test eval."""

    def __init__(
        self,
        cfg: Config,
        dataset: FederatedDataset,
        model,
        algorithm=None,
        logger: Optional[MetricsLogger] = None,
        device=None,
        sampler=None,
    ):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.backend = cfg.backend_sim or C.SIMULATION_BACKEND_MESH
        self.dataset = dataset
        self.model = model
        self.device = resolve_device(device)
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)

        stacked = stack_clients(dataset, multiple_of=cfg.batch_size)
        self.capacity = stacked.capacity
        steps_per_epoch = max(1, math.ceil(self.capacity / cfg.batch_size))
        self.hp = hparams_from_config(cfg, steps_per_epoch=steps_per_epoch)
        self.algorithm = (algorithm or create_algorithm(cfg, self.hp)).build(model)
        self._data = self._place_data(stacked)
        self.counts = stacked.counts
        n_total = dataset.n_clients
        self.sampler = sampler or ClientSampler(
            cfg.random_seed, n_total, min(cfg.client_num_per_round, n_total))

        self.root_key = rng.root_key(cfg.random_seed)
        self.global_vars = model.init(rng.generator(rng.init_key(self.root_key)), self.device)
        self.server_state = self.algorithm.init_server_state(self.global_vars)
        template = self.algorithm.init_client_state(self.global_vars)
        self.client_states = None if template is None else pt.tree_map(
            lambda t: t.unsqueeze(0).repeat((n_total,) + (1,) * t.ndim), template)

        eval_bs = min(256, max(32, cfg.test_batch_size))
        tx, ty, n_test = pad_eval_set(dataset.test_x, dataset.test_y, eval_bs)
        self._test = (torch.from_numpy(np.ascontiguousarray(tx)).to(self.device),
                      torch.from_numpy(np.ascontiguousarray(ty)).to(self.device, torch.long),
                      int(n_test))
        self._eval_fn = make_eval_fn(model, self.hp, batch_size=eval_bs)
        self.round_idx = 0

    def _place_data(self, stacked):
        x = torch.from_numpy(stacked.x)
        if self.hp.compute_dtype == "bfloat16" and x.is_floating_point():
            # device-resident shards in the compute dtype: half the memory and
            # half the per-step gather traffic
            x = x.to(torch.bfloat16)
        return x.to(self.device), torch.from_numpy(stacked.y).to(self.device, torch.long)

    def _server_path(self, contribs, weights, round_idx: int):
        agg = self.algorithm.aggregate(contribs, weights)
        return self.algorithm.server_update(self.global_vars, self.server_state, agg, round_idx)

    def _round(self) -> dict:
        """One round on the backend; its metrics as 0-d tensors (MESH, on
        the device) or floats (sp)."""
        r = self.round_idx
        metrics = (self._run_round_sp(r) if self.backend == C.SIMULATION_BACKEND_SP
                   else self._run_round_mesh(r))
        self.round_idx += 1
        return metrics

    def run_round(self) -> dict:
        """One round: the sampled clients train from the global variables
        (MESH: as the lanes of one batched round; sp: in turn), then the
        weighted mean replaces them.  Returns the round's host metrics (one
        device sync)."""
        return {k: float(v) for k, v in self._round().items()}

    def _run_round_mesh(self, r: int) -> dict:
        """The sampled clients as the lanes of one batched round (reference
        ``_make_round_fn`` L356 with ``_gather_round_inputs`` L326): each
        lane's permutations and draws from the sampler, the lanes' client
        state gathered and scattered, the server path shared with sp.
        Metrics stay on the device."""
        sampled = np.asarray(self.sampler.sample(r))
        lanes = to_device(sampled, self.device, torch.long)
        counts = self.counts[sampled]
        perms = [self.sampler.perms(r, int(ci), self.hp.epochs, self.capacity) for ci in sampled]
        perms = None if perms[0] is None else to_device(torch.stack(perms), self.device, torch.long)

        def draw(shape):
            return torch.stack([self.sampler.uniform(r, int(ci), shape, self.device)
                                for ci in sampled])

        states = (pt.tree_take(self.client_states, lanes)
                  if self.client_states is not None else None)
        out = self.algorithm.client_update_lanes(
            self.global_vars, states, self.server_state, self._data[0], self._data[1], lanes,
            counts, perms=perms, draw=draw)
        weights = to_device(counts, self.device, torch.float32)
        self.global_vars, self.server_state = self._server_path(out.contribution, weights, r)
        if self.client_states is not None and out.client_state is not None:
            pt.tree_scatter_(self.client_states, lanes, out.client_state)
        return {k: v.to(torch.float32).mean() for k, v in out.metrics.items()}

    def _run_round_sp(self, r: int) -> dict:
        """The sequential twin (reference ``_run_round_sp`` L821): every
        sampled client trains in turn."""
        sampled = np.asarray(self.sampler.sample(r))
        rkey = rng.round_key(self.root_key, r)
        contribs, new_states, metrics_list = [], [], []
        for ci in (int(c) for c in sampled):
            perms = self.sampler.perms(r, ci, self.hp.epochs, self.capacity)
            cs = (pt.tree_map(lambda s: s[ci], self.client_states)
                  if self.client_states is not None else None)
            out = self.algorithm.client_update(
                self.global_vars, cs, self.server_state, self._data[0][ci], self._data[1][ci],
                int(self.counts[ci]), rng.client_key(rkey, ci), perms=perms,
                draw=lambda shape, ci=ci: self.sampler.uniform(r, ci, shape, self.device))
            contribs.append(out.contribution)
            new_states.append(out.client_state)
            metrics_list.append(out.metrics)
        weights = torch.as_tensor(self.counts[sampled], dtype=torch.float32, device=self.device)
        self.global_vars, self.server_state = self._server_path(pt.tree_stack(contribs), weights, r)
        if self.client_states is not None and new_states[0] is not None:
            with torch.no_grad():
                for ci, ncs in zip(sampled, new_states):
                    pt.tree_map(lambda full, upd: full[int(ci)].copy_(upd), self.client_states, ncs)
        return {k: _mean([m[k] for m in metrics_list]) for k in metrics_list[0]}

    def run_rounds(self, n: int) -> list[dict]:
        """``n`` rounds; one dict of host metrics a round.  sp: each round
        syncs and is timed alone.  MESH (reference L733): the rounds'
        metrics stay on the device and come to the host in one sync at the
        end, and each round is given the chunk's time over ``n``."""
        if self.backend == C.SIMULATION_BACKEND_SP:
            out = []
            for _ in range(n):
                t0 = time.perf_counter()
                metrics = self.run_round()
                metrics["round_time_s"] = time.perf_counter() - t0
                out.append(metrics)
            return out
        if n <= 0:
            return []
        t0 = time.perf_counter()
        rounds = [self._round() for _ in range(n)]
        keys = list(rounds[0])
        host = torch.stack([torch.stack([m[k] for k in keys]) for m in rounds]).cpu()
        per_round = (time.perf_counter() - t0) / n
        return [dict(zip(keys, map(float, row)), round_time_s=per_round) for row in host]

    def evaluate(self) -> dict:
        res = self._eval_fn(self.global_vars, *self._test)
        return {k: float(v) for k, v in res.items()}

    def _next_boundary(self, r0: int) -> int:
        """First round index > r0 at which the host evaluates or training
        ends."""
        cfg = self.cfg
        ends = [cfg.comm_round]
        if cfg.frequency_of_the_test:
            f = cfg.frequency_of_the_test
            ends.append(((r0 // f) + 1) * f)
        return max(r0 + 1, min(e for e in ends if e > r0))

    def run(self) -> list[dict]:
        """The fit loop (reference ``FedAvgAPI.train``): rounds between host
        boundaries, evaluation at the test cadence and at the last round."""
        history = []
        cfg = self.cfg
        while self.round_idx < cfg.comm_round:
            r0 = self.round_idx
            end = self._next_boundary(r0)
            t0 = time.perf_counter()
            chunk = self.run_rounds(end - r0)
            span = time.perf_counter() - t0
            for i, metrics in enumerate(chunk):
                metrics["chunk_time_s"] = span
                metrics["chunk_rounds"] = len(chunk)
                metrics["round"] = r0 + i
            r_last = r0 + len(chunk) - 1
            if cfg.frequency_of_the_test and (
                (r_last + 1) % cfg.frequency_of_the_test == 0 or r_last == cfg.comm_round - 1
            ):
                chunk[-1].update(self.evaluate())
            for metrics in chunk:
                self.logger.log(metrics)
                history.append(metrics)
        return history
