"""FedLLM: federated LoRA fine-tuning (the port of
``fedml_tpu/llm/fedllm.py``).

Each sampled client fine-tunes LoRA adapters (``llm/lora.py``) of a frozen
transformer (``models/transformer.py``) on its token sequences; only the
adapter tree is averaged, weighted by the clients' sample counts.  The base
model stays on the device and is never trained.

One client's update (reference L75-104):
- every client takes the same step budget, ``epochs * max(1, capacity //
  batch_size)``, its shard padded to the largest client's size (the
  capacity) by cyclic repetition (``np.resize``);
- step ``s`` trains on the batch ``table[s]`` of rows drawn uniformly from
  the client's own count, the optimizer is optax's ``adamw(lr)``
  (``fl/optim.adamw``), re-initialised for each client, and the client's
  loss is the mean of its steps' losses.
The reference draws each step's batch with ``jax.random.randint`` in its
scan; here the draw is data: a ``(steps, batch)`` index table from the
sampler, so a test can hand in the reference's.  The default sampler
(:class:`LLMSampler`) draws the round's clients and each client's table
from the port's generators (``core/rng.py``).

Evaluation runs on the first 256 test sequences and gives ``test_loss``
and ``test_ppl = exp(test_loss)``.  Round checkpointing
(``core/checkpoint.py``) keeps the adapters, the round and the root key.

How to run it on the CPU: ``FedMLRunner(fedml_tpu_torch.init(argv=["--cf",
"examples/fedllm_shakespeare_lora/fedml_config.yaml"]), device="cpu").run()``.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..arguments import Config
from ..core import pytree as pt
from ..core import rng
from ..core.checkpoint import RoundCheckpointMixin, tree_to_device
from ..core.device import resolve_device
from ..core.flags import cfg_extra
from ..fl.optim import adamw
from ..models.transformer import Transformer, TransformerConfig
from ..obs.metrics import MetricsLogger
from . import lora as lora_lib

EVAL_SAMPLES = 256
# the model's init stream and the adapters' (the reference folds 1 and 2
# into its root key)
_BASE_TAG, _LORA_TAG = 1, 2


def refuse_unported_fedllm(cfg: Config) -> None:
    """Raise for flags this simulator does not serve (the reference wires
    no trust feature into it either)."""
    from ..sim.engine import refuse_special_simulator

    refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_FEDLLM)


class LLMSampler:
    """The default source of a round's randomness: the sampled client ids
    from the round key, each client's batch-index table from its client
    key."""

    def __init__(self, seed: int, n_total: int, per_round: int):
        self.root = rng.root_key(seed)
        self.n_total, self.per_round = n_total, per_round

    def sample(self, round_idx: int) -> np.ndarray:
        return rng.sample_clients(self.root, round_idx, self.n_total, self.per_round)

    def batches(self, round_idx: int, client: int, steps: int, batch_size: int, count: int,
                device) -> torch.Tensor:
        """``(steps, batch_size)`` row indices in ``[0, count)``, drawn on
        ``device``."""
        key = rng.client_key(rng.round_key(self.root, round_idx), client)
        return torch.randint(0, count, (steps, batch_size), device=device,
                             generator=rng.generator(key, device))


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy on the logits upcast to f32 (optax
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return torch.nn.functional.cross_entropy(
        logits.to(torch.float32).reshape(-1, logits.shape[-1]), targets.reshape(-1))


class FedLLMSimulator(RoundCheckpointMixin):
    """Federated LoRA over token-sequence clients on ``device`` (the card
    unless the caller names another).  ``dataset``: a FederatedDataset of
    token sequences ``(n, T)`` and their shifted targets; ``tcfg`` the
    transformer (``TransformerConfig.tiny`` at the dataset's vocabulary
    when None)."""

    def __init__(self, cfg: Config, dataset, tcfg: Optional[TransformerConfig] = None,
                 device=None, sampler=None, logger: Optional[MetricsLogger] = None):
        refuse_unported_fedllm(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.rank = int(cfg_extra(cfg, "lora_r", 8))
        self.alpha = float(cfg_extra(cfg, "lora_alpha"))
        self.tcfg = tcfg or TransformerConfig.tiny(vocab_size=dataset.class_num)
        self.root_key = rng.root_key(cfg.random_seed)
        self.model = Transformer(self.tcfg, device=self.device)
        self.model.reset_parameters(
            rng.generator(rng.fold_in(self.root_key, _BASE_TAG), self.device))
        self.model.requires_grad_(False)
        #: the frozen base: the flax params tree of the model's Parameters
        self.base_params = self.model.variables()
        self.global_lora = lora_lib.init_lora(
            self.base_params, self.rank, rng.fold_in(self.root_key, _LORA_TAG),
            targets=cfg_extra(cfg, "lora_targets", lora_lib.DEFAULT_TARGETS))
        self.round_idx = 0
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        n_total = dataset.n_clients
        self.sampler = sampler or LLMSampler(cfg.random_seed, n_total,
                                             min(cfg.client_num_per_round, n_total))

        counts = dataset.local_sample_counts()
        self.counts = counts
        self.capacity = int(counts.max())
        self.steps = cfg.epochs * max(1, self.capacity // cfg.batch_size)
        # every client's shard padded to the capacity, on the device
        reps = np.stack([np.resize(ix, self.capacity) for ix in dataset.client_idx])
        self._x = torch.from_numpy(dataset.train_x[reps]).to(self.device, torch.long)
        self._y = torch.from_numpy(dataset.train_y[reps]).to(self.device, torch.long)
        self._test = (
            torch.from_numpy(dataset.test_x[:EVAL_SAMPLES]).to(self.device, torch.long),
            torch.from_numpy(dataset.test_y[:EVAL_SAMPLES]).to(self.device, torch.long))

    def loss(self, lora: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        params = lora_lib.merge(self.base_params, lora, alpha=self.alpha)
        return lm_loss(self.model(x, params), y)

    def client_update(self, lora: dict, x: torch.Tensor, y: torch.Tensor,
                      table: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """One client's local training from ``lora`` on its padded shard
        ``x, y``: step ``s`` on rows ``table[s]``.  Returns the new adapters
        and the steps' losses (a ``(steps,)`` tensor on the device; their
        mean is the client's loss)."""
        opt = adamw(self.cfg.learning_rate)
        state = opt.init(lora)
        losses = []
        for idx in table:
            lora = pt.tree_map(lambda t: t.detach().requires_grad_(True), lora)
            leaves = pt.tree_leaves(lora)
            loss = self.loss(lora, x[idx], y[idx])
            grads = pt.tree_unflatten_like(lora, torch.autograd.grad(loss, leaves))
            lora, state = opt.update(grads, state, pt.tree_map(torch.Tensor.detach, lora))
            losses.append(loss.detach())
        return lora, torch.stack(losses)

    def run_round(self) -> dict:
        """The sampled clients train from the global adapters in turn; their
        weighted mean replaces them."""
        cfg = self.cfg
        r = self.round_idx
        sampled = np.asarray(self.sampler.sample(r))
        loras, losses = [], []
        for ci in (int(c) for c in sampled):
            count = int(self.counts[ci])
            table = self.sampler.batches(r, ci, self.steps, cfg.batch_size, count, self.device)
            new_lora, steps = self.client_update(self.global_lora, self._x[ci], self._y[ci],
                                                 table.to(self.device, torch.long))
            loras.append(new_lora)
            losses.append(steps.mean())
        weights = torch.as_tensor(self.counts[sampled], dtype=torch.float32, device=self.device)
        self.global_lora = pt.tree_weighted_mean(pt.tree_stack(loras), weights)
        self.round_idx += 1
        return {"train_loss": float(np.mean([float(v) for v in torch.stack(losses).cpu()]))}

    @torch.no_grad()
    def evaluate(self) -> dict:
        loss = float(self.loss(self.global_lora, *self._test))
        return {"test_loss": loss, "test_ppl": math.exp(loss)}

    def trained_tokens(self, n_clients: int) -> int:
        """Tokens a round trains on: clients x steps x batch x sequence."""
        return n_clients * self.steps * self.cfg.batch_size * int(self._x.shape[-1])

    # -- round checkpoint: the adapters, the round and the root key ----------
    def _ckpt_state(self) -> dict:
        return {"global_lora": self.global_lora, "round_idx": self.round_idx,
                "root_key": self.root_key}

    def _apply_ckpt_state(self, state: dict) -> None:
        self.global_lora = tree_to_device(state["global_lora"], self.device)
        self.round_idx = int(state["round_idx"])
        self.root_key = tuple(int(w) for w in state["root_key"])
        if isinstance(self.sampler, LLMSampler):
            self.sampler.root = self.root_key

    def run(self) -> list[dict]:
        from ..sim.engine import test_due

        history = []
        self.try_resume()
        while self.round_idx < self.cfg.comm_round:
            r = self.round_idx
            t0 = time.perf_counter()
            metrics = self.run_round()
            metrics.update(round=r, round_time_s=time.perf_counter() - t0)
            if test_due(self.cfg, r):
                metrics.update(self.evaluate())
            self.logger.log(metrics)
            history.append(metrics)
            self.maybe_save_checkpoint(r)
        return history
