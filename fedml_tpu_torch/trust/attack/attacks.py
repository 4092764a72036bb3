"""Attack simulations (robustness evaluation): the port of
``fedml_tpu/trust/attack/attacks.py``.

Parity with ``FedMLAttacker`` (``core/security/fedml_attacker.py:14``) and the
attack classes under ``core/security/attack/``: Byzantine (random / zero /
flip), model replacement, lazy worker, label flipping and the pixel-pattern
and edge-case backdoors.

The model attacks are transforms of the stacked ``(m, d)`` client update
matrix on its device, with a per-client malicious mask: they run in the
trust pipeline's first hook, server-side before aggregation, as the
reference's ``poison_model`` does.  ``byzantine_random``'s N(0, 1) draw is
an argument (the pipeline takes it from its sampler).  The data attacks
poison the host numpy dataset before the client shards are stacked
(``ClientTrainer.update_dataset``, ``client_trainer.py:38``), bitwise the
reference's for the same inputs.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ...core.flags import cfg_extra

log = logging.getLogger("fedml_tpu_torch.trust.attack")


def malicious_mask(m: int, sampled_idx, attacker_ids: Sequence[int], device) -> torch.Tensor:
    """(m,) 1.0 where the sampled client id is an attacker, on ``device``
    (the sampled ids are the host's: no device sync)."""
    ids = np.asarray(list(attacker_ids), dtype=np.int64)
    mask = np.isin(np.asarray(sampled_idx, dtype=np.int64)[:m], ids)
    return torch.as_tensor(mask.astype(np.float32), device=device)


def _rows(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, None] > 0


# ---------------------------------------------------------------------------
# Byzantine family (byzantine_attack.py modes: random / zero / flip)
# ---------------------------------------------------------------------------

def byzantine_random(updates: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor,
                     scale: float = 1.0) -> torch.Tensor:
    """Attackers' rows become ``noise * scale`` (``noise`` the ``(m, d)``
    N(0, 1) draw)."""
    return torch.where(_rows(mask), noise.view(updates.shape) * scale, updates)


def byzantine_zero(updates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(_rows(mask), torch.zeros_like(updates), updates)


def byzantine_flip(updates: torch.Tensor, mask: torch.Tensor,
                   global_flat: torch.Tensor) -> torch.Tensor:
    """Sign-flip the delta around the global model (gradient ascent)."""
    flipped = 2.0 * global_flat[None, :] - updates
    return torch.where(_rows(mask), flipped, updates)


def model_replacement(updates: torch.Tensor, mask: torch.Tensor, global_flat: torch.Tensor,
                      boost: float) -> torch.Tensor:
    """Model-replacement backdoor (model_replacement_backdoor_attack.py):
    the attacker scales its delta by ``boost`` (typically n/eta) so the
    averaged global becomes its target model."""
    boosted = global_flat[None, :] + boost * (updates - global_flat[None, :])
    return torch.where(_rows(mask), boosted, updates)


def lazy_worker(updates: torch.Tensor, mask: torch.Tensor,
                global_flat: torch.Tensor) -> torch.Tensor:
    """Lazy / free-rider (lazy_worker.py): returns the global weights
    untrained."""
    return torch.where(_rows(mask), global_flat[None, :].expand_as(updates), updates)


# ---------------------------------------------------------------------------
# Data attacks: host numpy, bitwise the reference's
# ---------------------------------------------------------------------------

def flip_labels(labels: np.ndarray, client_idx: list, poisoned_clients: Sequence[int],
                original_class: int, target_class: int) -> np.ndarray:
    """A copy of ``labels`` where poisoned clients' samples of
    ``original_class`` become ``target_class`` (label_flipping_attack.py)."""
    out = labels.copy()
    for c in poisoned_clients:
        ix = client_idx[c]
        sel = ix[out[ix] == original_class]
        out[sel] = target_class
    return out


def backdoor_pixel_pattern(x: np.ndarray, client_idx: list, poisoned_clients: Sequence[int],
                           target_class: int, labels: np.ndarray, frac: float = 0.5,
                           seed: int = 0):
    """Pixel-pattern backdoor (backdoor_attack.py): stamp a 3x3 corner
    trigger on a fraction of poisoned clients' images and relabel them to
    the target class.  Returns (x', labels')."""
    x = x.copy()
    labels = labels.copy()
    rng = np.random.RandomState(seed)
    for c in poisoned_clients:
        ix = client_idx[c]
        n_poison = int(len(ix) * frac)
        sel = rng.choice(ix, size=n_poison, replace=False)
        x[sel, :3, :3, :] = x.max()
        labels[sel] = target_class
    return x, labels


def edge_case_backdoor(x: np.ndarray, client_idx: list, poisoned_clients: Sequence[int],
                       target_class: int, labels: np.ndarray, frac: float = 0.2,
                       seed: int = 0, edge_examples: np.ndarray = None):
    """Edge-case backdoor (Wang et al. NeurIPS'20): poison with inputs from
    the tail of the data distribution, relabelled to the target.  With the
    canonical edge sets (``edge_examples``, Southwest airplanes / ARDIS
    digits) the poisoned slots take those images, moment-matched per
    channel to the dataset; without them the tail samples are the dataset's
    own pushed 3x along their deviation from the mean.  Returns (x',
    labels')."""
    x = x.copy()
    labels = labels.copy()
    rng = np.random.RandomState(seed)
    mean = x.mean(axis=0, keepdims=True)
    scale = 3.0  # how far into the tail the samples are pushed
    if edge_examples is not None and edge_examples.shape[1:] != x.shape[1:]:
        log.warning("edge-case set shape %s != dataset shape %s; falling back to "
                    "synthesized tail samples", edge_examples.shape[1:], x.shape[1:])
        edge_examples = None
    if edge_examples is not None:
        ax = tuple(range(x.ndim - 1))
        e = edge_examples.astype(np.float32)
        e_m, e_s = e.mean(axis=ax), e.std(axis=ax) + 1e-8
        x_m, x_s = x.mean(axis=ax), x.std(axis=ax) + 1e-8
        edge_examples = (e - e_m) / e_s * x_s + x_m
    for c in poisoned_clients:
        ix = client_idx[c]
        n_poison = int(len(ix) * frac)
        if n_poison == 0:
            continue
        sel = rng.choice(ix, size=n_poison, replace=False)
        if edge_examples is not None:
            pick = rng.randint(0, len(edge_examples), size=n_poison)
            x[sel] = edge_examples[pick]
        else:
            x[sel] = mean + scale * (x[sel] - mean)  # amplified deviation = tail
        labels[sel] = target_class
    return x, labels


MODEL_ATTACKS = ("byzantine_random", "byzantine_zero", "byzantine_flip", "model_replacement",
                 "lazy_worker")
DATA_ATTACKS = ("label_flipping", "backdoor", "edge_case_backdoor")
KNOWN_ATTACKS = MODEL_ATTACKS + DATA_ATTACKS


class FedMLAttacker:
    """Facade with the reference's API shape (``fedml_attacker.py``):
    enabled by config, ``poison_model`` (the stacked update matrix) and
    ``poison_data`` (the host dataset)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.enabled = bool(getattr(cfg, "enable_attack", False))
        self.attack_type = getattr(cfg, "attack_type", "")
        if self.enabled and self.attack_type not in KNOWN_ATTACKS:
            raise ValueError(f"unknown attack_type {self.attack_type!r}; known: "
                             f"{sorted(KNOWN_ATTACKS)}")
        self.attackers = tuple(getattr(cfg, "poisoned_client_list", ()) or ())
        self.boost = float(cfg_extra(cfg, "attack_boost"))
        self.original_class = int(cfg_extra(cfg, "attack_original_class"))
        self.target_class = int(cfg_extra(cfg, "attack_target_class"))
        self.poison_frac = float(cfg_extra(cfg, "attack_poison_frac"))

    def is_model_attack(self) -> bool:
        return self.enabled and self.attack_type in MODEL_ATTACKS

    def is_data_attack(self) -> bool:
        return self.enabled and self.attack_type in DATA_ATTACKS

    def needs_draw(self) -> bool:
        """True when :meth:`poison_model` takes an N(0, 1) draw."""
        return self.attack_type == "byzantine_random"

    def poison_data(self, ds):
        """A new dataset with the poisoned clients' host arrays poisoned,
        before the client shards are stacked."""
        if self.attack_type == "label_flipping":
            new_y = flip_labels(ds.train_y, ds.client_idx, self.attackers, self.original_class,
                                self.target_class)
            return dataclasses.replace(ds, train_y=new_y)
        if self.attack_type == "backdoor":
            new_x, new_y = backdoor_pixel_pattern(ds.train_x, ds.client_idx, self.attackers,
                                                  self.target_class, ds.train_y,
                                                  frac=self.poison_frac)
            return dataclasses.replace(ds, train_x=new_x, train_y=new_y)
        if self.attack_type == "edge_case_backdoor":
            from ...data.extra_loaders import load_edge_case_sets

            sets = load_edge_case_sets(
                Path(os.path.expanduser(getattr(self.cfg, "data_cache_dir", "") or ".")),
                str(cfg_extra(self.cfg, "edge_case_type")))
            new_x, new_y = edge_case_backdoor(ds.train_x, ds.client_idx, self.attackers,
                                              self.target_class, ds.train_y,
                                              frac=self.poison_frac,
                                              edge_examples=None if sets is None else sets[0])
            return dataclasses.replace(ds, train_x=new_x, train_y=new_y)
        return ds

    def poison_model(self, updates: torch.Tensor, sampled_idx, global_flat: torch.Tensor,
                     noise: torch.Tensor = None) -> torch.Tensor:
        """The attack on the ``(m, d)`` matrix; ``noise`` the ``(m, d)``
        N(0, 1) draw when :meth:`needs_draw`."""
        mask = malicious_mask(updates.shape[0], sampled_idx, self.attackers, updates.device)
        t = self.attack_type
        if t == "byzantine_random":
            return byzantine_random(updates, mask, noise)
        if t == "byzantine_zero":
            return byzantine_zero(updates, mask)
        if t == "byzantine_flip":
            return byzantine_flip(updates, mask, global_flat)
        if t == "model_replacement":
            return model_replacement(updates, mask, global_flat, self.boost)
        if t == "lazy_worker":
            return lazy_worker(updates, mask, global_flat)
        raise ValueError(f"unknown model attack {t!r}")
