"""Pieces shared by the simulators that build their own networks
(``sim/split_learning.py``, ``sim/vertical.py``, ``sim/fedgan.py``,
``sim/fednas.py``, ``sim/fedseg.py``): their source of randomness, the
gradient leaves of a step and the gather of a lane batch.

Randomness goes through a sampler object.  :class:`OwnNetSampler` is the
default: each draw from the port's generators (``core/rng.py``), keyed as
the reference keys it (the round key, the client key, a fold); the bits
differ from threefry's, so a test hands in an object with the same methods
that returns the reference's draws.  Index tables come back as int64 on the
CPU and latent draws as f32 on the CPU; the simulators move them to their
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import pytree as pt
from ..core import rng

# folds of the reference's keys (fedml_tpu/sim/split_learning.py L129, L307)
RELAY_FOLD = 7
SERVER_FOLD = 0x5E
# the port's own streams of a client key: FedGAN's batch, first and second
# latent draws, FedNAS's weight and alpha batches, FedSeg's batch
_GAN_TAGS = (1, 2, 3)
_NAS_TAGS = (1, 2)
_SEG_TAG = 1


class OwnNetSampler:
    """The default draws of the six simulators (module docstring)."""

    def __init__(self, seed: int, n_total: int = 1, per_round: int = 1):
        self.root = rng.root_key(seed)
        self.n_total = n_total
        self.per_round = per_round

    def _client(self, round_idx: int, client: int) -> rng.Key:
        return rng.client_key(rng.round_key(self.root, round_idx), client)

    def sample(self, round_idx: int) -> np.ndarray:
        """The round's sampled client ids (``rng.sample_clients``)."""
        return rng.sample_clients(self.root, round_idx, self.n_total, self.per_round)

    def relay_perms(self, round_idx: int, client: int, steps: int, cap: int) -> torch.Tensor:
        """SplitNN: the ``(steps, cap)`` permutations of the relay's
        ``client``-th pass, step ``s`` from ``fold_in(key, s)``, the key the
        round key folded by 7 once for each client before it."""
        key = rng.round_key(self.root, round_idx)
        for _ in range(client):
            key = rng.fold_in(key, RELAY_FOLD)
        return torch.stack([rng.permutation(rng.fold_in(key, s), cap) for s in range(steps)])

    def client_perms(self, round_idx: int, client: int, steps: int, cap: int) -> torch.Tensor:
        """FedGKT: a client's ``(steps, cap)`` permutations, step ``s`` from
        ``fold_in(client key, s)``."""
        key = self._client(round_idx, client)
        return torch.stack([rng.permutation(rng.fold_in(key, s), cap) for s in range(steps)])

    def server_perm(self, round_idx: int, n: int) -> torch.Tensor:
        """FedGKT: the server phase's one permutation of the ``n`` pooled
        rows, from ``fold_in(round key, 0x5E)``."""
        return rng.permutation(rng.fold_in(rng.round_key(self.root, round_idx), SERVER_FOLD), n)

    def epoch_perm(self, round_idx: int, epoch: int, n: int) -> torch.Tensor:
        """VFL: the permutation of the ``n`` rows for ``epoch`` of the
        round, from ``fold_in(round key, epoch)``."""
        return rng.permutation(rng.fold_in(rng.round_key(self.root, round_idx), epoch), n)

    def gan_draws(self, round_idx: int, client: int, steps: int, cap: int, batch: int,
                  z_dim: int):
        """FedGAN: a client's ``(steps, batch)`` real-batch rows (the first
        ``batch`` of a permutation of ``cap`` a step) and its two ``(steps,
        batch, z_dim)`` latent tables, the discriminator's and the
        generator's step's."""
        key = self._client(round_idx, client)
        g = rng.generator(rng.fold_in(key, _GAN_TAGS[0]))
        idx = torch.stack([torch.randperm(cap, generator=g)[:batch] for _ in range(steps)])
        z1, z2 = (torch.randn((steps, batch, z_dim), generator=rng.generator(rng.fold_in(key, t)))
                  for t in _GAN_TAGS[1:])
        return idx, z1, z2

    def latent(self, n: int, seed: int, z_dim: int) -> torch.Tensor:
        """FedGAN's ``sample``: ``(n, z_dim)`` standard normals from
        ``seed``."""
        return torch.randn((n, z_dim), generator=rng.generator(rng.root_key(seed)))

    def nas_indices(self, round_idx: int, client: int, steps: int, half: int, cap: int,
                    batch: int):
        """FedNAS: a client's ``(steps, batch)`` rows of the weight steps
        (uniform in ``[0, half)``) and of the alpha steps (``[half,
        cap)``)."""
        key = self._client(round_idx, client)
        gw, ga = (rng.generator(rng.fold_in(key, t)) for t in _NAS_TAGS)
        return (torch.randint(0, half, (steps, batch), generator=gw),
                torch.randint(half, cap, (steps, batch), generator=ga))

    def seg_indices(self, round_idx: int, client: int, steps: int, cap: int,
                    batch: int) -> torch.Tensor:
        """FedSeg: a client's ``(steps, batch)`` rows, uniform in ``[0,
        cap)``."""
        g = rng.generator(rng.fold_in(self._client(round_idx, client), _SEG_TAG))
        return torch.randint(0, cap, (steps, batch), generator=g)


def grad_leaves(params):
    """``(tree, leaves)``: ``params`` as fresh leaves that require grad,
    for one step's ``torch.autograd.grad``."""
    leaves = [t.detach().requires_grad_(True) for t in pt.tree_leaves(params)]
    return pt.tree_unflatten_like(params, leaves), leaves


def gather_lanes(x: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A batch a lane from the clients' stacked rows: ``x`` ``(clients,
    cap, ...)``, ``rows`` the lanes' clients ``(L,)``, ``idx`` ``(L,
    batch)`` positions in each -> ``(L, batch, ...)``."""
    flat = (rows[:, None] * x.shape[1] + idx).reshape(-1)
    out = x.reshape((-1,) + x.shape[2:]).index_select(0, flat)
    return out.reshape(idx.shape + x.shape[2:])


def lane_copies(tree, n: int):
    """``n`` copies of every leaf of a tree, stacked on a new leading
    axis."""
    return pt.tree_map(lambda t: t.unsqueeze(0).repeat((n,) + (1,) * t.ndim).contiguous(), tree)
