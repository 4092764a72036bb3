"""FedGAN: federated GAN training (the port of ``fedml_tpu/sim/fedgan.py``).

A round's sampled clients are the lanes of one batched local train of the
GAN pair (``models/gan.py``), each from the global generator and
discriminator with fresh Adam (``lr``, ``b1 = 0.5``) states for both.  A
step, for every lane at once:

1. a discriminator step on the lane's real batch and a fake batch made by
   the generator as it was before the step: ``bce(D(real), 1) +
   bce(D(fake), 0)``;
2. a generator step through the discriminator just updated:
   ``bce(D(G(z2)), 1)``.

``bce`` is the mean of optax's ``sigmoid_binary_cross_entropy``
(``fl/losses.py``).  A client takes ``max(1, cap // batch) * max(1,
epochs)`` steps, ``cap`` the largest shard rounded up to a batch multiple;
its real batch a step is the first ``batch`` rows of a permutation of its
padded shard.  The server takes the sample-weighted mean of the
generators and of the discriminators.  f32, as the reference.

Randomness: the sampler's ``sample`` (the round's clients), ``gan_draws``
(each client's batch rows and two latent tables) and ``latent``
(:meth:`FedGANSimulator.sample`); ``sim/own_nets.OwnNetSampler``.
Refused with ``NotImplementedError``: the trust features, the engine's
unported flags and population mode (``sim/engine.refuse_special_simulator``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..arguments import Config
from ..core import pytree as pt
from ..core import rng
from ..core.device import resolve_device
from ..core.flags import cfg_extra
from ..data.dataset import FederatedDataset, stack_clients
from ..fl.losses import sigmoid_binary_cross_entropy
from ..fl.optim import Adam
from ..models.gan import Discriminator, Generator
from ..obs.metrics import MetricsLogger
from .engine import fit_loop, refuse_special_simulator
from .own_nets import OwnNetSampler, gather_lanes, grad_leaves, lane_copies

ADAM_B1 = 0.5


def bce_lanes(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Each lane's mean binary cross-entropy of ``(L, N)`` logits against
    a constant target."""
    return sigmoid_binary_cross_entropy(logits, torch.full_like(logits, target)).mean(-1)


class FedGANSimulator:
    """FedGAN (reference L32) on ``device`` (the card unless the caller
    names another): :meth:`run` the fit loop, :meth:`run_round` one round,
    :meth:`sample` images from the global generator."""

    def __init__(self, cfg: Config, dataset: FederatedDataset,
                 logger: Optional[MetricsLogger] = None, device=None, sampler=None):
        refuse_special_simulator(cfg, C.FEDERATED_OPTIMIZER_FEDGAN)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.z_dim = int(cfg_extra(cfg, "gan_z_dim"))
        out_shape = tuple(dataset.train_x.shape[1:])
        self.gen = Generator(out_shape=out_shape, z_dim=self.z_dim)
        self.disc = Discriminator(in_features=math.prod(out_shape))
        self.root_key = rng.root_key(cfg.random_seed)
        g = rng.generator(rng.init_key(self.root_key))
        self.g_vars = self.gen.init(g, self.device)
        self.d_vars = self.disc.init(g, self.device)
        stacked = stack_clients(dataset, multiple_of=cfg.batch_size)
        self.counts, self.capacity = stacked.counts, stacked.capacity
        self._x = torch.from_numpy(stacked.x).to(self.device, torch.float32)
        self.steps = max(1, self.capacity // cfg.batch_size) * max(1, cfg.epochs)
        n = dataset.n_clients
        self.sampler = sampler or OwnNetSampler(cfg.random_seed, n,
                                                min(cfg.client_num_per_round, n))
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.round_idx = 0

    def local_train(self, sampled: np.ndarray, idx: torch.Tensor, z1: torch.Tensor,
                    z2: torch.Tensor):
        """The sampled clients' local GAN training as lanes: ``idx`` ``(L,
        steps, batch)`` real rows, ``z1`` / ``z2`` ``(L, steps, batch,
        z_dim)`` (on the device).  Returns the lanes' generators,
        discriminators and mean D and G losses ``(L,)``."""
        lanes = len(sampled)
        rows = torch.as_tensor(sampled, dtype=torch.long, device=self.device)
        opt = Adam(self.cfg.learning_rate, b1=ADAM_B1)
        gp = lane_copies(self.g_vars["params"], lanes)
        dp = lane_copies(self.d_vars["params"], lanes)
        g_state, d_state = opt.init(gp, lanes), opt.init(dp, lanes)
        d_sum = torch.zeros(lanes, dtype=torch.float32, device=self.device)
        g_sum = torch.zeros_like(d_sum)
        for s in range(idx.shape[1]):
            real = gather_lanes(self._x, rows, idx[:, s])
            with torch.no_grad():
                fake, _ = self.gen.apply({"params": gp}, z1[:, s])
            dq, d_leaves = grad_leaves(dp)
            d_loss = (bce_lanes(self.disc.apply({"params": dq}, real)[0], 1.0)
                      + bce_lanes(self.disc.apply({"params": dq}, fake)[0], 0.0))
            grads = pt.tree_unflatten_like(dp, torch.autograd.grad(d_loss.sum(), d_leaves))
            dp, d_state = opt.update(grads, d_state, dq)
            gq, g_leaves = grad_leaves(gp)
            fake, _ = self.gen.apply({"params": gq}, z2[:, s])
            g_loss = bce_lanes(self.disc.apply({"params": dp}, fake)[0], 1.0)
            grads = pt.tree_unflatten_like(gp, torch.autograd.grad(g_loss.sum(), g_leaves))
            gp, g_state = opt.update(grads, g_state, gq)
            d_sum, g_sum = d_sum + d_loss.detach(), g_sum + g_loss.detach()
        return {"params": gp}, {"params": dp}, d_sum / idx.shape[1], g_sum / idx.shape[1]

    def run_round(self) -> dict:
        r, bs = self.round_idx, self.cfg.batch_size
        sampled = np.array(self.sampler.sample(r))
        draws = [self.sampler.gan_draws(r, int(c), self.steps, self.capacity, bs, self.z_dim)
                 for c in sampled]
        idx, z1, z2 = (torch.stack(t).to(self.device) for t in zip(*draws))
        g_stack, d_stack, d_loss, g_loss = self.local_train(sampled, idx, z1, z2)
        w = torch.as_tensor(self.counts[sampled], dtype=torch.float32, device=self.device)
        self.g_vars = pt.tree_weighted_mean(g_stack, w)
        self.d_vars = pt.tree_weighted_mean(d_stack, w)
        self.round_idx += 1
        return {"d_loss": float(d_loss.mean()), "g_loss": float(g_loss.mean())}

    @torch.no_grad()
    def sample(self, n: int = 16, seed: int = 0) -> torch.Tensor:
        """``n`` images from the global generator, ``(n, *image shape)`` in
        [-1, 1]."""
        z = self.sampler.latent(n, seed, self.z_dim).to(self.device)
        return self.gen.apply(self.g_vars, z)[0]

    def run(self) -> list[dict]:
        return fit_loop(self.run_round, lambda: {}, self.cfg, self.logger)
