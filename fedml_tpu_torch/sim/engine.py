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
- ``MULTIPROCESS`` / ``MPI`` (the reference's global mesh over
  ``jax.distributed``): every rank of the gloo process group
  (``parallel/multihost.py``) loads the same data, samples the same
  clients and runs its contiguous block of the round's lanes
  (``_run_round_mesh``); the lanes' contributions, client states and
  metrics are all-gathered to every rank over host copies, and every rank
  runs the identical ``_server_path``, so the trust pipeline and the
  server optimizer see the single-process inputs and every rank holds the
  same global bitwise, as the reference's replicated state.  Population
  mode, contribution and checkpoints are refused there (ROADMAP Queue 3).

    sampled  = sampler.sample(r)                                 (host)
    MESH: algorithm.client_update_lanes(all sampled, batched)    (the card)
    sp:   for each sampled client: algorithm.client_update       (the card)
    agg      = algorithm.aggregate(stacked contributions, counts)
    global'  = algorithm.server_update(agg)

Client data is stacked once (``data.dataset.stack_clients``) and kept on the
device in the compute dtype; a MESH step gathers its batch rows from that
stack.  Per-client algorithm state (SCAFFOLD's control variates, FedDyn's
linear terms, FedSGD's EF-TopK residuals: a tensor or a tree of them) is
stacked on the device, one row per client: the sampled clients' rows are
gathered (``core.pytree.tree_take``), and the new rows are written back in
place after the server step (``tree_scatter_``, the reference's functional
``.at[sampled].set``); the rows of clients not sampled are never touched.
Server state (an optimizer's moments, SCAFFOLD's ``c``, FedDyn's ``h``,
Mime's momentum) is whatever tree ``server_update`` returns.  ``run_rounds(n)`` on MESH keeps the
rounds' metrics on the device and syncs once, at the end of the chunk (the
reference's ``jit(scan(round))`` chunk has one host sync too); CUDA-graph
capture of rounds is a later slice.  The AOT program store, the profiler
and OTLP export raise ``NotImplementedError``.

Population mode (``extra.population_store``, reference L275-288 and
L431-600): a sharded on-disk store (``population/``) is the authority for
the clients' data rows and state, ``population_size`` ids replicating the
dataset's clients cyclically.  Each MESH round samples its cohort with the
two-level sampler, gathers the cohort's ``(m, cap, ...)`` rows on the host
(the next round's on a prefetch thread), moves them to the card once
(pinned, then cast to the compute dtype there) and runs the same lane round
and ``_server_path`` (trust hooks included) as the in-memory round, each
lane keyed by its population id.  Client state is gathered before the
round and scattered back after it, in the reference's layout (flax
kernels), so the shard files hold the reference's arrays; the store
flushes at every chunk's end, before evaluation or a checkpoint.  ``sp``
refuses population mode, as the reference does; so does contribution (its
replay reads the in-memory stack), and so does
``extra.health_aware_selection`` (the sampler's health mask needs a device
registry and a health ledger: ``ROADMAP.md`` Queue 1 item 10).  The
reference's ``round_gate`` (the multi-tenant control plane's device-slot
grant, ``ROADMAP.md`` Queue 1 item 9) is left out.

Trust (``trust/pipeline.py``, reference L145-158 and L402-425): with
``enable_attack``, ``enable_defense`` or ``enable_dp`` the round's
contributions go through the pipeline's three hooks in :meth:`_server_path`,
shared by both backends (the attack and local DP, the defense before and at
aggregation, central DP and the defense after it), with the sampled ids and
the round index; a data attack poisons the dataset before the shards are
stacked.  A defense that reads the previous round's global delta
(``cross_round``, ``wbc``) gets it from :attr:`defense_history`, a tensor
on the device carried from round to round and through the checkpoint.  With
``enable_contribution`` the last round's pre-round state is kept, the
round's client work replayed through the same backend call (MESH: one
lane-batched call, so the replayed contributions are bitwise the round's),
and the clients scored by test accuracy (``trust/contribution.py``,
reference L902-1047).  ``enable_secagg`` and ``enable_fhe`` are cross-silo
protocols: the simulator refuses them, as the reference's runner does.
With no trust flag set the round does no trust work at all.

Round checkpointing (``core/checkpoint.py``, reference L871-903): with
``checkpoint_dir`` and ``checkpoint_every_rounds`` set, :meth:`run` saves
the global variables, the server state, the round, the root key and every
client's state (when the algorithm keeps one) at that cadence and at the
last round; with ``resume`` it first installs the newest intact step, whose
root key replaces the seed's (the default sampler's too).

How to run either backend on the CPU: ``FedMLRunner(cfg,
device="cpu").run()`` with ``cfg.backend_sim`` unset / ``"MESH"`` or
``"sp"``.

Randomness goes through a sampler object (``sample(r)``, ``perms(r, client,
epochs, cap)``, ``uniform(r, client, shape, device)`` and, for a model with
dropout, ``dropout(r, client, n_steps, shape, keep_prob, device)`` for the
local steps and ``grad_dropout(r, client, n_batches, shape, keep_prob,
device)`` for the full-gradient pass of FedSGD and Mime; an algorithm's
``dropout_tables`` names which of the two it takes):
:class:`ClientSampler` derives them all from the port's generators; a test
can hand in one built from the JAX package's keys.  Both backends take each
client's draws from it, a MESH lane those of its client.
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
from ..core.checkpoint import RoundCheckpointMixin, tree_to_device
from ..core.device import resolve_device
from ..core.flags import cfg_extra
from ..data.dataset import FederatedDataset, pad_eval_set, stack_clients
from ..fl.local_sgd import (dropout_masks, dropout_spec, epoch_permutations, lane_dropout_table,
                            make_eval_fn, step_budgets, to_device)
from ..obs.metrics import MetricsLogger
from ..parallel import multihost
from ..trust.contribution import ContributionAssessorManager
from ..trust.dp.dp import NoiseSampler
from ..trust.pipeline import build_trust_pipeline
from ..weights import flatten_reference

# flags whose subsystems later slices port (the ROADMAP.md Queue 1 item
# that ports each); setting one must not be a no-op
_UNPORTED_FLAGS = {"aot_programs": 10, "profile_rounds": 10, "otlp_endpoint": 10,
                   "cost_model_gauges": 10}
_MULTI_PROCESS = ("MULTIPROCESS", C.SIMULATION_BACKEND_MPI)
# tag of the full-gradient pass's dropout stream in a client key ("grad")
_GRAD_DROPOUT_TAG = 0x67726164


def refuse_protocol_flags(cfg: Config) -> None:
    """SecAgg and FHE are cross-silo protocols: the simulator refuses them
    with the reference runner's reason (``fedml_tpu/runner.py:113-120``)."""
    for flag, feature in (("enable_secagg", "LightSecAgg"), ("enable_fhe", "FHE aggregation")):
        if getattr(cfg, flag, False):
            raise NotImplementedError(
                f"{flag} is a cross-silo protocol feature ({feature} over the wire); the "
                "single-process simulator has no adversarial server to hide updates from "
                "— set training_type='cross_silo'")


def _refuse_multi_process(cfg: Config) -> None:
    """A multi-process backend needs the process group that
    ``fedml_tpu_torch.init`` brings up (the reference's ``ValueError``
    without it); refuse what its round does not serve (a decided
    difference, ROADMAP Queue 3)."""
    if not multihost.is_initialized():
        raise ValueError(multihost.MULTIPROCESS_REFUSAL)
    for flag, is_set, why in (
            ("extra.population_store", cfg_extra(cfg, "population_store"),
             "population mode streams one process's cohorts"),
            ("checkpoint_dir", cfg.checkpoint_dir, "every rank would write the same checkpoint"),
            ("enable_contribution", getattr(cfg, "enable_contribution", False),
             "the replay reads one process's lanes")):
        if is_set:
            raise NotImplementedError(f"backend_sim {cfg.backend_sim!r} with {flag}: {why} "
                                      "(ROADMAP.md Queue 3)")


def refuse_multi_process(cfg: Config, what: str) -> None:
    """A simulator of its own runs in one process: it refuses a
    multi-process backend by name (ROADMAP.md Queue 3)."""
    if getattr(cfg, "backend_sim", "") in _MULTI_PROCESS:
        raise NotImplementedError(
            f"backend_sim {cfg.backend_sim!r}: the {what!r} simulator runs in one process; "
            "the multi-process round serves the engine's algorithms (ROADMAP.md Queue 3)")


def _refuse_unported(cfg: Config) -> None:
    if cfg.backend_sim in _MULTI_PROCESS:
        _refuse_multi_process(cfg)
    for flag, item in _UNPORTED_FLAGS.items():
        if cfg_extra(cfg, flag):
            raise NotImplementedError(f"extra.{flag} is not ported yet (ROADMAP.md Queue 1 "
                                      f"item {item})")
    refuse_protocol_flags(cfg)


def refuse_population(cfg: Config, what: str) -> None:
    """Population mode is the engine's FedAvg round's; a simulator of its
    own refuses it (the reference's ignore the flag)."""
    if cfg_extra(cfg, "population_store"):
        raise NotImplementedError(f"extra.population_store is served by the engine's FedAvg "
                                  f"family on MESH, not by the {what!r} simulator")


def refuse_special_simulator(cfg: Config, what: str) -> None:
    """Raise for what a simulator of its own does not serve: the trust
    features (the reference's runner refuses them there), the engine's
    unported flags (each naming its ``ROADMAP.md`` Queue 1 item) and
    population mode."""
    active = [f for f in C.TRUST_FLAGS if getattr(cfg, f, False)]
    if active:
        raise NotImplementedError(f"trust features {active} are not wired into the {what!r} "
                                  "simulator; refusing to run without them")
    for flag, item in _UNPORTED_FLAGS.items():
        if cfg_extra(cfg, flag):
            raise NotImplementedError(f"extra.{flag} is not ported yet (ROADMAP.md Queue 1 "
                                      f"item {item})")
    refuse_population(cfg, what)
    refuse_multi_process(cfg, what)


def _lanes_relayout(tree, axes_map: dict, name=None):
    """A lane-stacked tree (or a lone tensor) with every ``kernel`` leaf
    permuted behind its lane axis by ``axes_map`` (the port's layout <->
    flax's)."""
    if isinstance(tree, dict):
        return {k: _lanes_relayout(v, axes_map, k) for k, v in tree.items()}
    axes = axes_map.get(tree.ndim - 1) if name == "kernel" else None
    return tree.permute((0,) + tuple(a + 1 for a in axes)).contiguous() if axes else tree


def _labels(y: np.ndarray, device) -> torch.Tensor:
    """Labels on the device: class or token ids as int64, multi-hot
    targets as they are."""
    y = torch.from_numpy(y)
    return y.to(device) if y.is_floating_point() else y.to(device, torch.long)


def _mean(values: list) -> float:
    """Mean over clients of one metric (device tensors sync once here)."""
    if torch.is_tensor(values[0]):
        return float(torch.stack(values).mean())
    return float(np.mean(values))


def place_clients(cfg: Config, dataset: FederatedDataset, device):
    """``(stacked, hp, (x, y))``: the clients' rows padded to a batch
    multiple (``stack_clients``, numpy), the local train's hyperparameters
    (an epoch ``ceil(capacity / batch)`` steps) and the rows on ``device``,
    floating ones in the compute dtype (half the memory and half a step's
    gather traffic in bf16; local training casts its batches to it
    anyway)."""
    stacked = stack_clients(dataset, multiple_of=cfg.batch_size)
    hp = hparams_from_config(cfg,
                             steps_per_epoch=max(1, math.ceil(stacked.capacity / cfg.batch_size)))
    x = torch.from_numpy(stacked.x)
    if hp.compute_dtype == "bfloat16" and x.is_floating_point():
        x = x.to(torch.bfloat16)
    return stacked, hp, (x.to(device), _labels(stacked.y, device))


def eval_batch_size(cfg: Config) -> int:
    """The test evaluation's batch: ``test_batch_size`` within [32, 256]."""
    return min(256, max(32, cfg.test_batch_size))


def place_test_set(cfg: Config, dataset: FederatedDataset, model, hp, device):
    """``((x, y, n_test), eval_fn)``: the test set padded to the eval batch
    on ``device`` and the eval function over it."""
    eval_bs = eval_batch_size(cfg)
    tx, ty, n_test = pad_eval_set(dataset.test_x, dataset.test_y, eval_bs)
    test = (torch.from_numpy(np.ascontiguousarray(tx)).to(device),
            _labels(np.ascontiguousarray(ty), device), int(n_test))
    return test, make_eval_fn(model, hp, batch_size=eval_bs)


def test_due(cfg: Config, r: int) -> bool:
    """Whether round ``r`` ends with a test evaluation: at the cadence
    ``frequency_of_the_test`` (0: never) and at the last round."""
    every = cfg.frequency_of_the_test
    return bool(every) and ((r + 1) % every == 0 or r == cfg.comm_round - 1)


def fit_loop(run_round, evaluate, cfg: Config, logger, every_round: bool = False) -> list[dict]:
    """The simulators' fit loop (the reference's ``run``): ``comm_round``
    calls of ``run_round()`` (host metrics), each timed on the host, then
    ``evaluate()`` merged in when :func:`test_due` (every round with
    ``every_round``), then logged."""
    history = []
    for r in range(cfg.comm_round):
        t0 = time.perf_counter()
        metrics = run_round()
        metrics.update(round=r, round_time_s=time.perf_counter() - t0)
        if every_round or test_due(cfg, r):
            metrics.update(evaluate())
        logger.log(metrics)
        history.append(metrics)
    return history


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

    def dropout(self, round_idx: int, client: int, n_steps: int, shape: tuple,
                keep_prob: float, device) -> torch.Tensor:
        """The client's dropout keep-masks of this round, ``(n_steps,
        *shape)`` bool, drawn on ``device`` from its client key (the
        reference folds a dropout key into every step)."""
        key = rng.client_key(rng.round_key(self.root, round_idx), client)
        return dropout_masks(key, n_steps, shape, keep_prob, device)

    def grad_dropout(self, round_idx: int, client: int, n_batches: int, shape: tuple,
                     keep_prob: float, device) -> torch.Tensor:
        """The client's keep-masks of this round's full-gradient pass, one
        a batch of its shard, ``(n_batches, *shape)`` bool: a stream of its
        own in the client key (the reference folds the batch index into the
        client's key, or Mime's full-gradient key)."""
        key = rng.client_key(rng.round_key(self.root, round_idx), client)
        return dropout_masks(rng.fold_in(key, _GRAD_DROPOUT_TAG), n_batches, shape, keep_prob,
                             device)


def client_grad_dropout(sampler, model, hp, capacity: int, r: int, clients,
                        device) -> Optional[list]:
    """Each client's keep-mask table of round ``r``'s full-gradient pass
    from ``sampler``, one row a batch of the padded shard; None for a model
    without dropout."""
    shape = dropout_spec(model, hp.batch_size)
    if shape is None:
        return None
    return [sampler.grad_dropout(r, int(ci), capacity // hp.batch_size, shape, model.keep_prob,
                                 device) for ci in clients]


def client_dropout(sampler, model, hp, r: int, clients, counts, device) -> Optional[list]:
    """Each client's keep-mask table of round ``r`` from ``sampler``, one
    row a step of its own budget; None for a model without dropout."""
    shape = dropout_spec(model, hp.batch_size)
    if shape is None:
        return None
    steps = np.minimum(step_budgets(hp, counts), hp.epochs * hp.steps_per_epoch)
    return [sampler.dropout(r, int(ci), int(n), shape, model.keep_prob, device)
            for ci, n in zip(clients, steps)]


class MeshSimulator(RoundCheckpointMixin):
    """Simulation of the registry's algorithms (the FedAvg family, FedSGD)
    on ``device`` (the card unless the caller names another; see
    ``core/device.py``): :meth:`run` is the fit loop, :meth:`run_round` one
    round, :meth:`evaluate` the global test eval."""

    def __init__(
        self,
        cfg: Config,
        dataset: FederatedDataset,
        model,
        algorithm=None,
        logger: Optional[MetricsLogger] = None,
        device=None,
        sampler=None,
        trust=None,
    ):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.backend = cfg.backend_sim or C.SIMULATION_BACKEND_MESH
        #: (processes, this one's index) sharing each round: the process
        #: group under MULTIPROCESS / MPI, else this process alone (also
        #: where a group is up for another purpose)
        self._span = ((multihost.process_count(), multihost.process_index())
                      if self.backend in _MULTI_PROCESS else (1, 0))
        self.device = resolve_device(device)
        self.trust = trust if trust is not None else build_trust_pipeline(cfg)
        if self.trust is not None and self.trust.attacker is not None \
                and self.trust.attacker.is_data_attack():
            dataset = self.trust.attacker.poison_data(dataset)
        self.dataset = dataset
        self.model = model
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)

        stacked, self.hp, self._data = place_clients(cfg, dataset, self.device)
        self.capacity = stacked.capacity
        self.algorithm = (algorithm or create_algorithm(cfg, self.hp)).build(model)
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

        self._eval_bs = eval_batch_size(cfg)
        self._test, self._eval_fn = place_test_set(cfg, dataset, model, self.hp, self.device)
        self.round_idx = 0
        # the previous round's global delta (the reference's flat layout) for
        # a defense that reads it; zeros before the first round
        self.defense_history = (
            torch.zeros_like(flatten_reference(self.global_vars)[0])
            if self.trust is not None and self.trust.needs_history else None)
        self._contribution_snapshot = None
        self._population = None
        pop_root = cfg_extra(cfg, "population_store")
        if pop_root:
            if self.backend == C.SIMULATION_BACKEND_SP:
                raise ValueError("population_store streams cohorts into the batched MESH round; "
                                 "it has no meaning on the sp host loop")
            if getattr(cfg, "enable_contribution", False):
                raise NotImplementedError("contribution replays the last round from the "
                                          "in-memory client stack; population mode has none")
            if cfg_extra(cfg, "health_aware_selection"):
                # the sampler's health mask reads a device registry and a
                # health ledger, which the port does not have yet
                raise NotImplementedError("extra.health_aware_selection in population mode is "
                                          "not ported yet (ROADMAP.md Queue 1 item 10)")
            self._init_population(str(pop_root), stacked)

    def _server_path(self, contribs, weights, sampled, round_idx: int):
        """Trust hooks, aggregation and the server update, shared by both
        backends (reference L402).  Returns the new global variables and
        server state; updates :attr:`defense_history`."""
        old = self.global_vars
        agg = None
        if self.trust is not None:
            contribs, weights = self.trust.on_client_outputs(contribs, weights, sampled, old,
                                                             round_idx)
            contribs, weights, agg = self.trust.on_aggregation(
                contribs, weights, old, round_idx, prev_delta=self.defense_history)
        if agg is None:
            agg = self.algorithm.aggregate(contribs, weights)
        new_global, new_server = self.algorithm.server_update(old, self.server_state, agg,
                                                              round_idx)
        if self.trust is not None:
            new_global = self.trust.on_after_aggregation(new_global, old, round_idx)
        if self.defense_history is not None:
            self.defense_history = flatten_reference(new_global)[0] - flatten_reference(old)[0]
        return new_global, new_server

    def _round(self) -> dict:
        """One round on the backend; its metrics as 0-d tensors (MESH, on
        the device) or floats (sp)."""
        r = self.round_idx
        if self._population is not None:
            metrics = self._run_round_population(r)
        elif self.backend == C.SIMULATION_BACKEND_SP:
            metrics = self._run_round_sp(r)
        else:
            metrics = self._run_round_mesh(r)
        self.round_idx += 1
        return metrics

    def run_round(self) -> dict:
        """One round: the sampled clients train from the global variables
        (MESH: as the lanes of one batched round; sp: in turn), then the
        weighted mean replaces them.  Returns the round's host metrics (one
        device sync)."""
        out = {k: float(v) for k, v in self._round().items()}
        if self._population is not None:
            self._population.store.flush()
        return out

    def _run_round_mesh(self, r: int) -> dict:
        """The sampled clients as the lanes of one batched round (reference
        ``_make_round_fn`` L356 with ``_gather_round_inputs`` L326): each
        lane's permutations and draws from the sampler, the lanes' client
        state gathered and scattered, the server path shared with sp.
        Under MULTIPROCESS / MPI this rank trains its contiguous block of the
        lanes, and every lane's contribution, client state and metrics are
        all-gathered (in the sampled order) before the server path, which
        every rank runs; in one process the block is every lane.  Metrics
        stay on the device."""
        sampled = np.asarray(self.sampler.sample(r))
        m, (world, index) = len(sampled), self._span
        if m < world:
            raise ValueError(f"{m} clients a round cannot give each of {world} processes a lane")
        a, b = multihost.contiguous_block(m, world, index)
        all_lanes = to_device(sampled, self.device, torch.long)
        lanes = all_lanes[a:b]
        states = (pt.tree_take(self.client_states, lanes)
                  if self.client_states is not None else None)
        out = self._client_outputs_mesh(r, sampled[a:b], lanes, self.global_vars,
                                        self.server_state, states)
        contribs, new_states, metrics = out.contribution, out.client_state, out.metrics
        if world > 1:
            contribs, new_states, metrics = (multihost.tree_gather_rows(t, m)
                                             for t in (contribs, new_states, metrics))
        weights = to_device(self.counts[sampled], self.device, torch.float32)
        self.global_vars, self.server_state = self._server_path(contribs, weights, sampled, r)
        if self.client_states is not None and new_states is not None:
            pt.tree_scatter_(self.client_states, all_lanes, new_states)
        return {k: v.to(torch.float32).mean() for k, v in metrics.items()}

    def _client_outputs_mesh(self, r: int, sampled, lanes, global_vars, server_state, states,
                             data=None, counts=None):
        """Round ``r``'s client work on MESH: the sampled clients (``lanes``
        their rows of ``data``, the in-memory stack unless given, on the
        device; ``counts`` their sample counts) trained in one batched call
        from ``global_vars`` / ``server_state`` and their gathered client
        ``states``; each lane's draws those of its id in ``sampled``."""
        data = self._data if data is None else data
        counts = self.counts[sampled] if counts is None else counts
        perms = [self.sampler.perms(r, int(ci), self.hp.epochs, self.capacity) for ci in sampled]
        perms = None if perms[0] is None else to_device(torch.stack(perms), self.device, torch.long)

        def draw(shape):
            return torch.stack([self.sampler.uniform(r, int(ci), shape, self.device)
                                for ci in sampled])

        drop = {}
        if "train" in self.algorithm.dropout_tables:
            drops = client_dropout(self.sampler, self.model, self.hp, r, sampled, counts,
                                   self.device)
            if drops is not None:
                drop["dropout"] = lane_dropout_table(drops)
        if "grad" in self.algorithm.dropout_tables:
            drops = client_grad_dropout(self.sampler, self.model, self.hp, self.capacity, r,
                                        sampled, self.device)
            if drops is not None:
                drop["grad_dropout"] = torch.stack(drops)
        # a model without dropout is trained through the same call as before
        return self.algorithm.client_update_lanes(
            global_vars, states, server_state, data[0], data[1], lanes, counts,
            perms=perms, draw=draw, **drop)

    def _run_round_sp(self, r: int) -> dict:
        """The sequential twin (reference ``_run_round_sp`` L821): every
        sampled client trains in turn."""
        sampled = np.asarray(self.sampler.sample(r))
        states = (pt.tree_take(self.client_states, to_device(sampled, self.device, torch.long))
                  if self.client_states is not None else None)
        contribs, new_states, metrics_list = self._client_outputs_sp(
            r, sampled, self.global_vars, self.server_state, states)
        weights = torch.as_tensor(self.counts[sampled], dtype=torch.float32, device=self.device)
        self.global_vars, self.server_state = self._server_path(contribs, weights, sampled, r)
        if self.client_states is not None and new_states[0] is not None:
            with torch.no_grad():
                for ci, ncs in zip(sampled, new_states):
                    pt.tree_map(lambda full, upd: full[int(ci)].copy_(upd), self.client_states, ncs)
        return {k: _mean([m[k] for m in metrics_list]) for k in metrics_list[0]}

    def _client_outputs_sp(self, r: int, sampled, global_vars, server_state, states):
        """Round ``r``'s client work on sp: each sampled client in turn, lane
        ``i`` of ``states`` its client state.  Returns the stacked
        contributions, each client's new state and its metrics."""
        rkey = rng.round_key(self.root_key, r)
        contribs, new_states, metrics_list = [], [], []
        tables = self.algorithm.dropout_tables
        drops = (client_dropout(self.sampler, self.model, self.hp, r, sampled,
                                self.counts[sampled], self.device)
                 if "train" in tables else None)
        gdrops = (client_grad_dropout(self.sampler, self.model, self.hp, self.capacity, r,
                                      sampled, self.device)
                  if "grad" in tables else None)
        for lane, ci in enumerate(int(c) for c in sampled):
            drop = {} if drops is None else {"dropout": drops[lane]}
            if gdrops is not None:
                drop["grad_dropout"] = gdrops[lane]
            perms = self.sampler.perms(r, ci, self.hp.epochs, self.capacity)
            cs = pt.tree_map(lambda s: s[lane], states) if states is not None else None
            out = self.algorithm.client_update(
                global_vars, cs, server_state, self._data[0][ci], self._data[1][ci],
                int(self.counts[ci]), rng.client_key(rkey, ci), perms=perms,
                draw=lambda shape, ci=ci: self.sampler.uniform(r, ci, shape, self.device),
                **drop)
            contribs.append(out.contribution)
            new_states.append(out.client_state)
            metrics_list.append(out.metrics)
        return pt.tree_stack(contribs), new_states, metrics_list

    # -- population mode (extra.population_store) ----------------------------
    def _init_population(self, root: str, stacked) -> None:
        """The store, the two-level sampler and the prefetch pipeline
        (``population/``, reference ``_init_population`` L432); the store
        replaces the device stack of client state."""
        from types import SimpleNamespace

        from ..population import build_population_components

        template = self.algorithm.init_client_state(self.global_vars)
        state_template = None
        if template is not None:  # one client's state, the reference's layout
            one = _lanes_relayout(pt.tree_map(lambda t: t.unsqueeze(0), template),
                                  pt.KERNEL_TO_FLAX)
            state_template = pt.tree_map(lambda t: t[0].detach().cpu().numpy(), one)
        store, sampler, pipeline = build_population_components(
            self.cfg, root, stacked.x, stacked.y, stacked.counts, self.capacity,
            state_template=state_template)
        self._population = SimpleNamespace(store=store, sampler=sampler, pipeline=pipeline,
                                           m=sampler.cohort_size)
        self.client_states = None  # the store holds every client's state

    def _cohort_rows(self, rows: np.ndarray, cast: bool = True) -> torch.Tensor:
        """A cohort's host rows on the device, crossing once (pinned, on the
        current stream); with ``cast`` floating rows are cast to the compute
        dtype there."""
        t = torch.from_numpy(rows)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        if cast and self.hp.compute_dtype == "bfloat16" and t.is_floating_point():
            t = t.to(torch.bfloat16)  # round to nearest even, as ml_dtypes casts
        return t.to(self.device)

    def _run_round_population(self, r: int) -> dict:
        """One cohort round (reference ``_run_one_population_round`` L548):
        the cohort's data from the pipeline (the next round's prefetched),
        its state from the store, the MESH lane round and the shared server
        path, the new state scattered back.  Metrics stay on the device."""
        pop = self._population
        pop.pipeline.prefetch_round(r)
        ids, batch = pop.pipeline.obtain(r)
        if r + 1 < self.cfg.comm_round:
            pop.pipeline.prefetch_round(r + 1)
        data = (self._cohort_rows(batch.x), _labels(batch.y, self.device))
        states = pop.store.gather_state(ids)
        if states is not None:
            states = pt.tree_map(lambda a: self._cohort_rows(a, cast=False), states)
            states = _lanes_relayout(states, pt.KERNEL_TO_TORCH)
        sampled = np.asarray(ids, np.int64)
        lanes = to_device(np.arange(len(sampled)), self.device, torch.long)
        out = self._client_outputs_mesh(r, sampled, lanes, self.global_vars, self.server_state,
                                        states, data=data, counts=batch.counts)
        weights = to_device(batch.counts, self.device, torch.float32)
        self.global_vars, self.server_state = self._server_path(out.contribution, weights,
                                                                sampled, r)
        if states is not None and out.client_state is not None:
            pop.store.scatter_state(ids, _lanes_relayout(out.client_state, pt.KERNEL_TO_FLAX))
        return {k: v.to(torch.float32).mean() for k, v in out.metrics.items()}

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
        if self._population is not None:
            # the shards are this mode's client state: consistent on disk
            # before an evaluation or a checkpoint reads the boundary
            self._population.store.flush()
        per_round = (time.perf_counter() - t0) / n
        return [dict(zip(keys, map(float, row)), round_time_s=per_round) for row in host]

    def evaluate(self) -> dict:
        res = self._eval_fn(self.global_vars, *self._test)
        return {k: float(v) for k, v in res.items()}

    # -- round checkpoint (reference L871-903) -------------------------------
    def _ckpt_state(self) -> dict:
        state = {"global_vars": self.global_vars, "server_state": self.server_state,
                 "round_idx": self.round_idx, "root_key": self.root_key}
        if self.client_states is not None:
            state["client_states"] = self.client_states
        if self.defense_history is not None:
            state["defense_history"] = self.defense_history
        return state

    def _apply_ckpt_state(self, state: dict) -> None:
        self.global_vars = tree_to_device(state["global_vars"], self.device)
        self.server_state = tree_to_device(state["server_state"], self.device)
        self.round_idx = int(state["round_idx"])
        # the checkpointed key is authoritative over the config's seed
        self.root_key = tuple(int(w) for w in state["root_key"])
        if isinstance(self.sampler, ClientSampler):
            self.sampler.root = self.root_key
        if self.trust is not None and isinstance(self.trust.sampler, NoiseSampler):
            self.trust.sampler.root = self.root_key
        if "client_states" in state:
            self.client_states = tree_to_device(state["client_states"], self.device)
        if "defense_history" in state:
            self.defense_history = tree_to_device(state["defense_history"], self.device)

    def _next_boundary(self, r0: int) -> int:
        """First round index > r0 at which the host evaluates, checkpoints,
        snapshots the last round for contribution, or training ends."""
        cfg = self.cfg
        ends = [cfg.comm_round]
        for every in (cfg.frequency_of_the_test, cfg.checkpoint_every_rounds):
            if every:
                ends.append(((r0 // every) + 1) * every)
        if getattr(cfg, "enable_contribution", False) and r0 < cfg.comm_round - 1:
            # a chunk must not straddle the last round: its pre-round state
            # is kept for the contribution replay
            ends.append(cfg.comm_round - 1)
        return max(r0 + 1, min(e for e in ends if e > r0))

    def run(self) -> list[dict]:
        """The fit loop (reference ``FedAvgAPI.train``): resume when asked,
        rounds between host boundaries, evaluation at the test cadence and at
        the last round, a checkpoint at its cadence and at the last round."""
        history = []
        cfg = self.cfg
        self.try_resume()
        contribution = getattr(cfg, "enable_contribution", False)
        while self.round_idx < cfg.comm_round:
            r0 = self.round_idx
            if contribution and r0 == cfg.comm_round - 1:
                # keep the pre-round state: the last round's contributions are
                # replayed from it (reference L920-927)
                self._contribution_snapshot = self._snapshot_pre_round(r0)
            end = self._next_boundary(r0)
            t0 = time.perf_counter()
            chunk = self.run_rounds(end - r0)
            span = time.perf_counter() - t0
            for i, metrics in enumerate(chunk):
                metrics["chunk_time_s"] = span
                metrics["chunk_rounds"] = len(chunk)
                metrics["round"] = r0 + i
            r_last = r0 + len(chunk) - 1
            if test_due(cfg, r_last):
                chunk[-1].update(self.evaluate())
            for metrics in chunk:
                self.logger.log(metrics)
                history.append(metrics)
            self.maybe_save_checkpoint(r_last)
        if contribution:
            scores = self.assess_contribution()
            if scores is not None:
                self.logger.log({f"contribution_c{i}": float(s) for i, s in enumerate(scores)})
        return history

    # -- contribution (reference L960-1047) ----------------------------------
    def _snapshot_pre_round(self, r: int) -> dict:
        """Round ``r``'s starting state: the global variables and the server
        state (the round replaces them, never writes into them) and a copy of
        the sampled clients' states (the round writes those rows in place)."""
        sampled = np.asarray(self.sampler.sample(r))
        states = None
        if self.client_states is not None:
            states = pt.tree_take(self.client_states, to_device(sampled, self.device, torch.long))
        return {"round": r, "global_vars": self.global_vars, "server_state": self.server_state,
                "client_states": states}

    def last_round_contributions(self):
        """Replay the last round's client work from the kept pre-round state:
        the same sampled clients, draws and starting state, through the same
        backend call as the round (MESH: one lane-batched call, so the
        contributions are bitwise the round's).  Returns (stacked
        contributions, weights, sampled ids, snapshot), or None when no
        snapshot was kept."""
        snap = self._contribution_snapshot
        if snap is None:
            return None
        r = snap["round"]
        sampled = np.asarray(self.sampler.sample(r))
        if self.backend == C.SIMULATION_BACKEND_SP:
            contribs, _, _ = self._client_outputs_sp(r, sampled, snap["global_vars"],
                                                     snap["server_state"], snap["client_states"])
        else:
            contribs = self._client_outputs_mesh(
                r, sampled, to_device(sampled, self.device, torch.long), snap["global_vars"],
                snap["server_state"], snap["client_states"]).contribution
        return contribs, [float(self.counts[int(ci)]) for ci in sampled], sampled, snap

    def assess_contribution(self):
        """Shapley contribution of the last round's sampled clients
        (reference ``ServerAggregator.assess_contribution``): coalitions of
        the replayed contributions scored by test accuracy."""
        mgr = ContributionAssessorManager(self.cfg)
        if not mgr.enabled or self.round_idx == 0:
            return None
        replay = self.last_round_contributions()
        if replay is None:
            return None
        stacked, weights, _, snap = replay
        if not pt.same_structure(pt.tree_map(lambda x: x[0], stacked), self.global_vars):
            return None  # contribution is defined on weight-style contributions

        def eval_fn(agg_vars):
            return float(self._eval_fn(agg_vars, *self._test)["test_acc"])

        return mgr.assess(stacked, np.asarray(weights), eval_fn, empty_model=snap["global_vars"])
