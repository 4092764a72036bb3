"""Vertical (feature-partitioned) federated learning (the port of
``fedml_tpu/sim/vertical.py``).

``vfl_party_num`` parties (at least 2) each hold an equal slice of every
sample's features (the features zero-padded to a multiple of the party
count) and a ``PartyBottom`` (``Dense(32)``, ReLU, ``Dense(embed)``); the
host holds the labels and ``HostTop`` (ReLU, ``Dense(32)``, ReLU,
``Dense(classes)``) over the parties' embeddings concatenated in party
order.  The embedding exchange is autograd through the composed program:
the parties' bottoms are stacked over a party axis and run as one
``torch.bmm`` a layer, and one optimizer (SGD with the recipe's momentum,
fresh each round) steps all of it.  Step ``s`` of a round takes the batch
at ``(s % spe) * batch`` of the epoch's permutation extended by its first
``batch`` entries (``spe = ceil(N / batch)``, epoch ``s // spe``).  The
test accuracy is over the whole test set at once.  f32, as the reference.

Randomness: the sampler's ``epoch_perm`` (``sim/own_nets.OwnNetSampler``).
Refused with ``NotImplementedError``: the trust features, the engine's
unported flags and population mode (``sim/engine.refuse_special_simulator``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..algorithms import hparams_from_config
from ..arguments import Config
from ..core import pytree as pt
from ..core import rng
from ..core.device import resolve_device
from ..core.flags import cfg_extra
from ..data.dataset import FederatedDataset
from ..fl.losses import cross_entropy
from ..fl.optim import SGD
from ..models import simple
from ..obs.metrics import MetricsLogger
from .engine import _labels, fit_loop, refuse_special_simulator
from .own_nets import OwnNetSampler, grad_leaves, lane_copies


@dataclass(frozen=True)
class PartyBottom:
    """``PartyBottom`` (reference L34) over a party's feature slice; the
    parties' stacked variables run as lanes (``(P, N, slice)`` in, ``(P, N,
    embed)`` out)."""

    in_features: int
    embed_dim: int = 16

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": simple._dense_init(self.in_features, 32, generator),
                  "Dense_1": simple._dense_init(32, self.embed_dim, generator)}
        return pt.tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return simple.single_lane(self, variables, x, train)
        return simple._dense(p["Dense_1"], torch.relu(simple._dense(p["Dense_0"], x))), {}


@dataclass(frozen=True)
class HostTop:
    """``HostTop`` (reference L44) over the concatenated embeddings."""

    in_features: int
    num_classes: int = 2

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": simple._dense_init(self.in_features, 32, generator),
                  "Dense_1": simple._dense_init(32, self.num_classes, generator)}
        return pt.tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, h: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return simple.single_lane(self, variables, h, train)
        h = torch.relu(simple._dense(p["Dense_0"], torch.relu(h)))
        return simple._dense(p["Dense_1"], h), {}


def party_slices(x: np.ndarray, parties: int) -> np.ndarray:
    """Flattened rows zero-padded to a multiple of ``parties`` features, as
    ``(parties, N, slice)`` f32."""
    x = x.reshape(x.shape[0], -1).astype(np.float32)
    pad = (-x.shape[1]) % parties
    if pad:
        x = np.concatenate([x, np.zeros((x.shape[0], pad), np.float32)], axis=1)
    return np.ascontiguousarray(x.reshape(x.shape[0], parties, -1).transpose(1, 0, 2))


class VFLSimulator:
    """Vertical FL (reference L55) on ``device`` (the card unless the
    caller names another): :meth:`run` the fit loop, :meth:`run_round`
    ``local_steps`` joint steps."""

    def __init__(self, cfg: Config, dataset: FederatedDataset,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_VERTICAL_FL)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.n_parties = max(2, int(cfg_extra(cfg, "vfl_party_num") or 2))
        train_x = party_slices(dataset.train_x, self.n_parties)
        self.slice_w = train_x.shape[2]
        self.train_x = torch.from_numpy(train_x).to(self.device)
        self.test_x = torch.from_numpy(party_slices(dataset.test_x, self.n_parties)).to(self.device)
        self.train_y = _labels(np.asarray(dataset.train_y), self.device)
        self.test_y = _labels(np.asarray(dataset.test_y), self.device)
        self.n_rows = train_x.shape[1]
        self.hp = hparams_from_config(
            cfg, steps_per_epoch=max(1, math.ceil(self.n_rows / cfg.batch_size)))
        embed = int(cfg_extra(cfg, "vfl_embed_dim") or 16)
        self.bottom = PartyBottom(self.slice_w, embed)
        self.top = HostTop(self.n_parties * embed, dataset.class_num)
        self.root_key = rng.root_key(cfg.random_seed)
        g = rng.generator(rng.init_key(self.root_key))
        # every party starts from the same bottom, as the reference's
        self.party_vars = lane_copies(self.bottom.init(g, self.device), self.n_parties)
        self.top_vars = self.top.init(g, self.device)
        self.opt = SGD(self.hp.learning_rate, self.hp.momentum)
        self.sampler = sampler or OwnNetSampler(cfg.random_seed)
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0

    def forward(self, party_params: dict, top_params: dict, xb: torch.Tensor) -> torch.Tensor:
        """``xb`` ``(parties, N, slice)`` -> the host's logits: one ``bmm``
        a bottom layer over the parties, the embeddings concatenated in
        party order."""
        embeds, _ = self.bottom.apply({"params": party_params}, xb)
        h = embeds.transpose(0, 1).reshape(xb.shape[1], -1)
        return self.top.apply({"params": top_params}, h)[0]

    def run_round(self) -> dict:
        r, hp = self.round_idx, self.hp
        bs, spe = hp.batch_size, hp.steps_per_epoch
        params = {"parties": self.party_vars["params"], "top": self.top_vars["params"]}
        state = self.opt.init(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        ext, epoch = None, -1
        for s in range(hp.local_steps):
            if s // spe != epoch:
                epoch = s // spe
                perm = self.sampler.epoch_perm(r, epoch, self.n_rows).to(self.device)
                ext = torch.cat([perm, perm[:bs]])
            start = min((s % spe) * bs, ext.shape[0] - bs)
            idx = ext[start:start + bs]
            q, leaves = grad_leaves(params)
            logits = self.forward(q["parties"], q["top"], self.train_x.index_select(1, idx))
            loss = cross_entropy(logits.to(torch.float32), self.train_y.index_select(0, idx))
            grads = pt.tree_unflatten_like(params, torch.autograd.grad(loss, leaves))
            params, state = self.opt.update(grads, state, q)
            loss_sum = loss_sum + loss.detach()
        self.party_vars, self.top_vars = {"params": params["parties"]}, {"params": params["top"]}
        self.round_idx += 1
        return {"train_loss": float(loss_sum / max(hp.local_steps, 1))}

    @torch.no_grad()
    def evaluate(self) -> dict:
        logits = self.forward(self.party_vars["params"], self.top_vars["params"], self.test_x)
        return {"test_acc": float((logits.argmax(-1) == self.test_y).to(torch.float32).mean())}

    def run(self) -> list[dict]:
        return fit_loop(self.run_round, self.evaluate, self.cfg, self.logger)
