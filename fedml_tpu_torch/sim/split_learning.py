"""Split learning: SplitNN and FedGKT (the port of
``fedml_tpu/sim/split_learning.py``).

The model is cut in two: a bottom that each client holds and a top.  The
reference's activation and gradient exchange is autograd through the
composed program.

- ``create_split_model``: the split ResNet-56 halves
  (``models/resnet.SplitResNet56Client`` / ``SplitResNet56Server``) for
  ``cifar*`` and ``cinic10``, else ``BottomMLP`` (``Dense(64)``, ReLU) and
  ``TopMLP`` (``Dense(64)``, ReLU, ``Dense(classes)``).  The ResNet-56
  halves refuse ``norm: batch``: the reference applies them with
  ``train=True`` and an immutable ``batch_stats`` collection, which flax
  rejects at the first step (``ModifyScopeVariableError``), so they are
  usable there only with ``norm: group``.
- :class:`SplitNNSimulator`, the relay: each of the ``n`` clients keeps its
  bottom (stacked over the clients); the top is shared and passes through
  the clients in index order.  Each client starts fresh SGD (with the
  recipe's momentum) states for its bottom and the top, then takes
  ``local_steps`` steps, each on the first ``batch_size`` rows of a
  permutation of its whole padded shard.  One client at a time, single
  lane.  ``evaluate`` tests client 0's bottom under the top, as the
  reference does.
- :class:`FedGKTSimulator`, group knowledge transfer: every client is a
  lane of one batched local train of its bottom plus a head (``MLP(hidden=
  64)`` on the flattened features) on cross-entropy plus knowledge
  distillation towards last round's server logits (off at round 0; the
  server logits of a row are those of probe row ``min(idx, probe - 1)``).
  Each client's probe is the first ``min(capacity, 128)`` rows of its
  shard; their features and the head's logits pool on the server, whose
  top trains single-lane on them with cross-entropy plus distillation
  towards the clients' logits, ``max(1, n probe // batch)`` steps, every
  step a slice of one permutation of the pool.  New server logits come
  per client.  Distillation: ``-mean(sum(softmax(t) * log_softmax(s)))``
  at temperature 1.

Both compute in f32, as the reference.  Randomness goes through the
sampler (``sim/own_nets.OwnNetSampler``): SplitNN's ``relay_perms``,
FedGKT's ``client_perms`` and ``server_perm``.

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
from ..data.dataset import FederatedDataset, pad_eval_set, stack_clients
from ..fl.losses import cross_entropy, cross_entropy_lanes
from ..fl.optim import SGD
from ..models import resnet, simple
from ..obs.metrics import MetricsLogger
from .engine import _labels, eval_batch_size, fit_loop, refuse_special_simulator
from .own_nets import OwnNetSampler, gather_lanes, grad_leaves, lane_copies

PROBE_ROWS = 128  # FedGKT's exchanged rows a client (reference L210)
GKT_HEAD_HIDDEN = 64


@dataclass(frozen=True)
class BottomMLP:
    """The reference's ``BottomMLP``: the flattened input through
    ``Dense(64)`` and ReLU."""

    in_features: int

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        return pt.tree_map(lambda t: t.to(device), {"params": {
            "Dense_0": simple._dense_init(self.in_features, 64, generator)}})

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return simple.single_lane(self, variables, x, train)
        return torch.relu(simple._dense(p["Dense_0"], x.reshape(x.shape[0], x.shape[1], -1))), {}


@dataclass(frozen=True)
class TopMLP:
    """The reference's ``TopMLP``: ``Dense(64)``, ReLU, ``Dense(classes)``."""

    num_classes: int

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        params = {"Dense_0": simple._dense_init(64, 64, generator),
                  "Dense_1": simple._dense_init(64, self.num_classes, generator)}
        return pt.tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, h: torch.Tensor, train: bool = True):
        p = variables["params"]
        if p["Dense_0"]["kernel"].ndim == 2:
            return simple.single_lane(self, variables, h, train)
        return simple._dense(p["Dense_1"], torch.relu(simple._dense(p["Dense_0"], h))), {}


def create_split_model(cfg: Config, out_dim: int, input_shape: tuple):
    """``(bottom, top)`` (reference L35); ``input_shape`` is one sample's
    shape."""
    if cfg.dataset.startswith("cifar") or cfg.dataset == "cinic10":
        if cfg.norm != "group":
            raise ValueError(
                f"the split ResNet-56 halves need norm: group (got {cfg.norm!r}): the reference "
                "applies them with train=True and an immutable batch_stats collection, which "
                "flax rejects at the first step (ModifyScopeVariableError)")
        return (resnet.SplitResNet56Client(norm=cfg.norm, in_channels=input_shape[-1]),
                resnet.SplitResNet56Server(num_classes=out_dim, norm=cfg.norm))
    return BottomMLP(int(np.prod(input_shape))), TopMLP(out_dim)


def kd_loss(student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """Distillation at temperature 1 (reference L240), one value a lane for
    ``(L, N, classes)`` logits, else a scalar."""
    per = -(torch.softmax(teacher, -1) * torch.log_softmax(student, -1)).sum(-1)
    return per.mean(-1)


class _SplitBase:
    """Set-up and evaluation shared by the two simulators."""

    what = ""

    def __init__(self, cfg: Config, dataset: FederatedDataset, logger, device, sampler):
        refuse_special_simulator(cfg, self.what)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.n = dataset.n_clients
        self.n_classes = dataset.class_num
        self.bottom, self.top = create_split_model(cfg, dataset.class_num,
                                                   tuple(dataset.train_x.shape[1:]))
        stacked = stack_clients(dataset, multiple_of=cfg.batch_size)
        self.capacity = stacked.capacity
        self.hp = hparams_from_config(
            cfg, steps_per_epoch=max(1, math.ceil(stacked.capacity / cfg.batch_size)))
        self._x = torch.from_numpy(stacked.x).to(self.device, torch.float32)
        self._y = _labels(stacked.y, self.device)
        self.opt = SGD(self.hp.learning_rate, self.hp.momentum)
        self.sampler = sampler or OwnNetSampler(cfg.random_seed, self.n, self.n)
        self.root_key = rng.root_key(cfg.random_seed)
        self._init_gen = rng.generator(rng.init_key(self.root_key))
        self.eval_bs = eval_batch_size(cfg)
        tx, ty, n_valid = pad_eval_set(dataset.test_x, dataset.test_y, self.eval_bs)
        self._test = (torch.from_numpy(np.ascontiguousarray(tx)).to(self.device, torch.float32),
                      _labels(np.ascontiguousarray(ty), self.device), int(n_valid))
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0

    @torch.no_grad()
    def _test_acc(self, bvars: dict, tvars: dict) -> dict:
        """Client ``bvars`` under ``tvars`` on the test set: the share of
        right argmax predictions over its valid rows."""
        x, y, n_valid = self._test
        bs = self.eval_bs
        correct = torch.zeros((), dtype=torch.float32, device=self.device)
        pos = torch.arange(bs, device=self.device)
        n_batches = x.shape[0] // bs
        for i in range(n_batches):
            h, _ = self.bottom.apply(bvars, x[i * bs:(i + 1) * bs], train=False)
            logits, _ = self.top.apply(tvars, h, train=False)
            ok = (logits.argmax(-1) == y[i * bs:(i + 1) * bs]).to(torch.float32)
            correct = correct + (ok * (pos + i * bs < n_valid).to(torch.float32)).sum()
        return {"test_acc": float(correct / max(min(n_valid, n_batches * bs), 1))}

    def run(self) -> list[dict]:
        return fit_loop(self.run_round, self.evaluate, self.cfg, self.logger)


class SplitNNSimulator(_SplitBase):
    """SplitNN (reference L64) on ``device`` (the card unless the caller
    names another): :meth:`run` the fit loop, :meth:`run_round` one relay
    through every client."""

    what = C.FEDERATED_OPTIMIZER_SPLIT_NN

    def __init__(self, cfg: Config, dataset: FederatedDataset,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        super().__init__(cfg, dataset, logger, device, sampler)
        bvars = self.bottom.init(self._init_gen, self.device)
        self.top_vars = self.top.init(self._init_gen, self.device)
        self.client_bottoms = lane_copies(bvars, self.n)

    def client_pass(self, bvars: dict, tvars: dict, x: torch.Tensor, y: torch.Tensor,
                    perms: torch.Tensor):
        """One client's turn of the relay from ``bvars`` and the top
        ``tvars`` on its padded shard ``x`` / ``y``: ``(bottom, top, mean
        loss)``; ``perms`` ``(steps, batch)`` its rows a step.  Runs where
        its tensors lie."""
        opt = self.opt
        bp, tp = bvars["params"], tvars["params"]
        b_state, t_state = opt.init(bp), opt.init(tp)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(perms.shape[0]):
            idx = perms[s]
            (bq, b_leaves), (tq, t_leaves) = grad_leaves(bp), grad_leaves(tp)
            h, _ = self.bottom.apply({"params": bq}, x.index_select(0, idx), train=True)
            logits, _ = self.top.apply({"params": tq}, h, train=True)
            loss = cross_entropy(logits.to(torch.float32), y.index_select(0, idx))
            grads = torch.autograd.grad(loss, b_leaves + t_leaves)
            bp, b_state = opt.update(pt.tree_unflatten_like(bp, grads[:len(b_leaves)]),
                                     b_state, bq)
            tp, t_state = opt.update(pt.tree_unflatten_like(tp, grads[len(b_leaves):]),
                                     t_state, tq)
            loss_sum = loss_sum + loss.detach()
        return {"params": bp}, {"params": tp}, loss_sum / max(perms.shape[0], 1)

    def run_round(self) -> dict:
        r, steps, bs = self.round_idx, self.hp.local_steps, self.hp.batch_size
        tvars, losses = self.top_vars, []
        for c in range(self.n):
            perms = self.sampler.relay_perms(r, c, steps, self.capacity)[:, :bs]
            bvars = pt.tree_map(lambda t: t[c], self.client_bottoms)
            bvars, tvars, loss = self.client_pass(bvars, tvars, self._x[c], self._y[c],
                                                  perms.to(self.device))
            pt.tree_map(lambda full, new: full[c].copy_(new), self.client_bottoms, bvars)
            losses.append(loss)
        self.top_vars = tvars
        self.round_idx += 1
        return {"train_loss": float(torch.stack(losses).mean())}

    def evaluate(self) -> dict:
        return self._test_acc(pt.tree_map(lambda t: t[0], self.client_bottoms), self.top_vars)


class FedGKTSimulator(_SplitBase):
    """FedGKT (reference L188) on ``device``: :meth:`run` the fit loop,
    :meth:`run_round` the clients' batched phase, then the server's."""

    what = C.FEDERATED_OPTIMIZER_FEDGKT

    def __init__(self, cfg: Config, dataset: FederatedDataset,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        super().__init__(cfg, dataset, logger, device, sampler)
        self.probe = min(int(self.capacity), PROBE_ROWS)
        if self.n * self.probe < cfg.batch_size:
            raise ValueError(f"FedGKT's pooled probe ({self.n} x {self.probe} rows) is smaller "
                             f"than batch_size {cfg.batch_size}")
        bvars = self.bottom.init(self._init_gen, self.device)
        with torch.no_grad():
            h0, _ = self.bottom.apply(bvars, self._x[0, :1], train=False)
        self.head = simple.MLP(hidden=GKT_HEAD_HIDDEN, num_classes=self.n_classes,
                               in_features=int(np.prod(h0.shape[1:])))
        hvars = self.head.init(self._init_gen, self.device)
        self.server_vars = self.top.init(self._init_gen, self.device)
        self.client_bottoms = lane_copies(bvars, self.n)
        self.client_heads = lane_copies(hvars, self.n)
        self.server_logits = torch.zeros((self.n, self.probe, self.n_classes),
                                         dtype=torch.float32, device=self.device)
        self._lanes = torch.arange(self.n, device=self.device)

    def client_phase(self, params: dict, rows: torch.Tensor, perms: torch.Tensor,
                     teacher: Optional[torch.Tensor] = None):
        """The local train of clients ``rows`` as the lanes of one batched
        train: ``params`` ``{"bottom", "head"}`` lane-stacked in ``rows``'
        order, ``perms`` ``(L, steps, batch)`` their rows a step (on the
        device), ``teacher`` their server logits ``(L, probe, classes)`` for
        the distillation term (None: none).  Returns the new params and the
        lanes' mean losses ``(L,)``."""
        opt, lanes = self.opt, rows.shape[0]
        state = opt.init(params)
        loss_sum = torch.zeros(lanes, dtype=torch.float32, device=self.device)
        for s in range(perms.shape[1]):
            idx = perms[:, s]
            bx = gather_lanes(self._x, rows, idx)
            by = gather_lanes(self._y, rows, idx)
            q, leaves = grad_leaves(params)
            feats, _ = self.bottom.apply({"params": q["bottom"]}, bx, train=True)
            logits, _ = self.head.apply({"params": q["head"]},
                                        feats.reshape(lanes, idx.shape[1], -1), train=True)
            logits = logits.to(torch.float32)
            losses = cross_entropy_lanes(logits, by)
            if teacher is not None:
                lane = torch.arange(lanes, device=self.device)
                losses = losses + kd_loss(logits, gather_lanes(
                    teacher, lane, torch.clamp_max(idx, self.probe - 1)))
            grads = pt.tree_unflatten_like(params, torch.autograd.grad(losses.sum(), leaves))
            params, state = opt.update(grads, state, q)
            loss_sum = loss_sum + losses.detach()
        return params, loss_sum / max(perms.shape[1], 1)

    @torch.no_grad()
    def probe_outputs(self):
        """Each client's probe features ``(n, probe, ...)`` and its head's
        logits on them ``(n, probe, classes)``, in eval mode."""
        feats, _ = self.bottom.apply(self.client_bottoms, self._x[:, :self.probe], train=False)
        logits, _ = self.head.apply(self.client_heads, feats.reshape(self.n, self.probe, -1),
                                    train=False)
        return feats, logits.to(torch.float32)

    def server_phase(self, feats: torch.Tensor, client_logits: torch.Tensor,
                     perm: torch.Tensor) -> None:
        """The server top's train on the pooled probe rows (single lane),
        then fresh server logits for every client's probe."""
        opt, bs = self.opt, self.hp.batch_size
        flat = feats.reshape((-1,) + feats.shape[2:])
        flat_y = self._y[:, :self.probe].reshape(-1)
        flat_cl = client_logits.reshape(-1, self.n_classes)
        n_batches = flat.shape[0] // bs
        tp = self.server_vars["params"]
        state = opt.init(tp)
        for i in range(max(1, n_batches)):
            idx = perm[(i % n_batches) * bs:(i % n_batches + 1) * bs]
            q, leaves = grad_leaves(tp)
            logits, _ = self.top.apply({"params": q}, flat.index_select(0, idx), train=True)
            logits = logits.to(torch.float32)
            loss = (cross_entropy(logits, flat_y.index_select(0, idx))
                    + kd_loss(logits, flat_cl.index_select(0, idx)))
            grads = pt.tree_unflatten_like(tp, torch.autograd.grad(loss, leaves))
            tp, state = opt.update(grads, state, q)
        self.server_vars = {"params": tp}
        with torch.no_grad():
            self.server_logits = torch.stack([
                self.top.apply(self.server_vars, feats[c], train=False)[0].to(torch.float32)
                for c in range(self.n)])

    def run_round(self) -> dict:
        r, steps, bs = self.round_idx, self.hp.local_steps, self.hp.batch_size
        perms = torch.stack([self.sampler.client_perms(r, c, steps, self.capacity)[:, :bs]
                             for c in range(self.n)]).to(self.device)
        params = {"bottom": self.client_bottoms["params"], "head": self.client_heads["params"]}
        params, losses = self.client_phase(params, self._lanes, perms,
                                           self.server_logits if r > 0 else None)
        self.client_bottoms = {"params": params["bottom"]}
        self.client_heads = {"params": params["head"]}
        feats, client_logits = self.probe_outputs()
        self.server_phase(feats, client_logits,
                          self.sampler.server_perm(r, self.n * self.probe).to(self.device))
        self.round_idx += 1
        return {"train_loss": float(losses.mean())}

    def evaluate(self) -> dict:
        return self._test_acc(pt.tree_map(lambda t: t[0], self.client_bottoms), self.server_vars)
