"""UnitedLLM: cross-cloud federated LLM training over the wire (the port of
``fedml_tpu/llm/unitedllm.py``).

Silos fine-tune LoRA adapters (``llm/lora.py``) of one frozen base model on
their private token sequences and exchange only the adapter trees through
the cross-silo protocol; the base never crosses the network.  The pieces
plug into the unchanged cross-silo managers, so every transport, the
straggler handling, the finish protocol and the streaming / compressed /
async paths serve LLM silos too:

- :func:`_build_base`: the reference's ``TransformerConfig.tiny`` at the
  dataset's vocabulary, its base drawn from ``fold_in(root_key(seed), 1)``
  and its adapters from ``fold_in(root_key(seed), 2)`` (the port's
  generators; a ``base`` hook carries the reference's flax trees in, by
  key: the transformer's tree is flax's, key for key);
- :class:`LoRASiloTrainer`: the ``FedMLTrainer`` contract over the adapter
  tree; ``epochs * ceil(count / batch)`` steps of optax's ``adamw(lr)``
  (re-initialised each round), each on ``batch`` rows drawn uniformly from
  the silo's own count (the reference draws them with ``jax.random.randint``
  from ``fold_in(client key, step)``; here a ``(steps, batch)`` table from
  the client key, or the ``batches`` hook's); it declares the low-rank
  compression floor ``codecs.LOW_RANK_MIN_COMPRESS_ELEMS``, which an
  explicit ``comm_compress_min_size`` overrides;
- :class:`LoRAAggregator`: the port's ``FedMLAggregator`` with the adapter
  tree as its global state and the LM loss / perplexity on the first 256
  test sequences as its evaluation, opting into the streaming fold by the
  same gate (``_init_stream_mode``);
- :func:`build_unitedllm_server` (the async server under
  ``extra.async_aggregation``), :func:`build_unitedllm_client` and
  :func:`run_unitedllm_process_group` (the server and its silos as threads
  over INPROC or TCP).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..algorithms import create as create_algorithm, hparams_from_config
from ..comm.codecs import LOW_RANK_MIN_COMPRESS_ELEMS
from ..core import pytree as pt
from ..core import rng
from ..core.flags import cfg_extra
from ..cross_silo.client import ClientMasterManager
from ..cross_silo.server import FedMLAggregator, FedMLServerManager, provisional_steps_per_epoch
from ..fl.optim import adamw
from ..models.transformer import Transformer, TransformerConfig
from . import lora as lora_lib
from .fedllm import EVAL_SAMPLES, lm_loss

log = logging.getLogger("fedml_tpu_torch.llm.unitedllm")

_BASE_TAG, _LORA_TAG = 1, 2


def _build_base(cfg, dataset, device, base: Optional[tuple] = None):
    """``(model, base_params, lora0, alpha)``: the frozen base every party
    derives from ``cfg.random_seed`` (the stand-in for one public
    checkpoint), or ``base = (flax params, flax adapters)`` carried in."""
    tcfg = TransformerConfig.tiny(vocab_size=dataset.class_num)
    model = Transformer(tcfg, device=device)
    root = rng.root_key(cfg.random_seed)
    targets = cfg_extra(cfg, "lora_targets", lora_lib.DEFAULT_TARGETS)
    if base is None:
        model.reset_parameters(rng.generator(rng.fold_in(root, _BASE_TAG), device))
    else:
        with torch.no_grad():
            pt.tree_map(lambda p, v: p.copy_(torch.as_tensor(np.array(v))),
                        model.variables(), base[0])
    model.requires_grad_(False)
    base_params = model.variables()
    if base is None:
        lora0 = lora_lib.init_lora(base_params, int(cfg_extra(cfg, "lora_r", 4)),
                                   rng.fold_in(root, _LORA_TAG), targets=targets)
    else:
        lora0 = {k: {n: torch.as_tensor(np.array(v)).to(device) for n, v in ab.items()}
                 for k, ab in base[1].items()}
    return model, base_params, lora0, float(cfg_extra(cfg, "lora_alpha"))


class LoRASiloTrainer:
    """``FedMLTrainer``-shaped local operator on ``device``: the global
    state is the adapter tree, the base stays frozen in the silo."""

    def __init__(self, cfg, dataset, x: np.ndarray, y: np.ndarray, device,
                 base: Optional[tuple] = None, batches: Optional[Callable] = None):
        self.cfg = cfg
        self.model, self.base_params, _, self.alpha = _build_base(cfg, dataset, device, base)
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(device, torch.long)
        self.y = torch.from_numpy(np.ascontiguousarray(y)).to(device, torch.long)
        self.count = int(x.shape[0])
        self.steps = cfg.epochs * max(1, math.ceil(self.count / cfg.batch_size))
        #: ``fn(round, client, steps, batch, count)``: the row table in place
        #: of the client key's draw (tests hand in the reference's)
        self.batches = batches
        # adapter factors sit far below the model-scale compression floor
        self.comm_compress_min_elems = LOW_RANK_MIN_COMPRESS_ELEMS

    def loss(self, lora: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return lm_loss(self.model(x, lora_lib.merge(self.base_params, lora, alpha=self.alpha)), y)

    def train(self, global_lora: dict, round_idx: int, seed_key, client_idx: int = 0) -> tuple:
        key = rng.client_key(rng.round_key(seed_key, round_idx), client_idx)
        bs, device = self.cfg.batch_size, self.x.device
        if self.batches is not None:
            table = torch.as_tensor(np.asarray(self.batches(round_idx, client_idx, self.steps,
                                                            bs, self.count)))
        else:
            table = torch.randint(0, self.count, (self.steps, bs), device=device,
                                  generator=rng.generator(key, device))
        table = table.to(device, torch.long)
        opt = adamw(self.cfg.learning_rate)
        lora = global_lora
        state = opt.init(lora)
        losses = []
        for idx in table:
            lora = pt.tree_map(lambda t: t.detach().requires_grad_(True), lora)
            leaves = pt.tree_leaves(lora)
            loss = self.loss(lora, self.x[idx], self.y[idx])
            grads = pt.tree_unflatten_like(lora, torch.autograd.grad(loss, leaves))
            lora, state = opt.update(grads, state, pt.tree_map(torch.Tensor.detach, lora))
            losses.append(loss.detach())
        log.info("silo %d round %d lora train loss %.4f", client_idx, round_idx,
                 float(torch.stack(losses).mean()))
        return pt.tree_map(torch.Tensor.detach, lora), float(self.count)


class LoRAAggregator(FedMLAggregator):
    """The cross-silo aggregator whose global state is the adapter tree;
    evaluation merges base and adapters and reports the LM loss and
    perplexity.  The base class's constructor builds a classifier's
    evaluation, so it is not called; the rest of the base class (the
    buffer-all and streaming folds, the journal state) serves as it is."""

    def __init__(self, cfg, dataset, device, base: Optional[tuple] = None, trust=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model, self.base_params, lora0, self.alpha = _build_base(cfg, dataset, self.device,
                                                                      base)
        self.global_vars = lora0
        self.hp = hparams_from_config(cfg, steps_per_epoch=provisional_steps_per_epoch(cfg))
        self.algorithm = create_algorithm(cfg, self.hp)  # aggregate and server_update only
        self.server_state = self.algorithm.init_server_state(self.global_vars)
        if trust is None:
            from ..trust.pipeline import build_trust_pipeline

            trust = build_trust_pipeline(cfg)
        self.trust = trust
        self.root_key = rng.root_key(cfg.random_seed)
        self.model_dict: dict[int, object] = {}
        self.sample_num_dict: dict[int, float] = {}
        self.flag_client_model_uploaded: dict[int, bool] = {}
        n_eval = min(EVAL_SAMPLES, len(dataset.test_x))
        self._test = (torch.from_numpy(dataset.test_x[:n_eval]).to(self.device, torch.long),
                      torch.from_numpy(dataset.test_y[:n_eval]).to(self.device, torch.long))
        self._init_stream_mode(cfg)

    @torch.no_grad()
    def test_on_server(self) -> dict:
        params = lora_lib.merge(self.base_params, self.global_vars, alpha=self.alpha)
        loss = float(lm_loss(self.model(self._test[0], params), self._test[1]))
        return {"test_loss": loss, "test_ppl": math.exp(loss)}


def build_unitedllm_server(cfg, dataset, device, backend: Optional[str] = None,
                           base: Optional[tuple] = None) -> FedMLServerManager:
    aggregator = LoRAAggregator(cfg, dataset, device, base=base)
    if cfg_extra(cfg, "async_aggregation"):
        # buffered-async LoRA: the vision path's manager, the adapter tree as
        # the global state
        from ..cross_silo.async_server import AsyncFedMLServerManager

        return AsyncFedMLServerManager(cfg, aggregator, backend=backend)
    return FedMLServerManager(cfg, aggregator, backend=backend)


def build_unitedllm_client(cfg, dataset, rank: int, device, backend: Optional[str] = None,
                           base: Optional[tuple] = None,
                           batches: Optional[Callable] = None) -> ClientMasterManager:
    ix = dataset.client_idx[rank - 1]
    trainer = LoRASiloTrainer(cfg, dataset, dataset.train_x[ix], dataset.train_y[ix], device,
                              base=base, batches=batches)
    return ClientMasterManager(cfg, trainer, rank=rank, backend=backend)


def run_unitedllm_process_group(cfg, dataset, device, backend: str = "INPROC",
                                timeout: float = 600.0, base: Optional[tuple] = None,
                                batches: Optional[Callable] = None):
    """The server and ``client_num_in_total`` LLM silos as threads of this
    process over INPROC or TCP (``tcp_base_port`` 0: ports the system
    picks, linked).  Returns ``(history, server)``."""
    from ..comm.comm_manager import reset_in_memory_fabric
    from ..comm.tcp_backend import link_ports
    from ..cross_silo import run_group

    reset_in_memory_fabric(str(getattr(cfg, "run_id", "0")))
    # the server first: its listener exists before a silo's first send
    server = build_unitedllm_server(cfg, dataset, device, backend=backend, base=base)
    clients = [build_unitedllm_client(cfg, dataset, r, device, backend=backend, base=base,
                                      batches=batches)
               for r in range(1, cfg.client_num_in_total + 1)]
    link_ports([server, *clients])
    return run_group(server, clients, timeout), server
