"""TrustPipeline: attacks, defenses and DP around aggregation (the port of
``fedml_tpu/trust/pipeline.py``).

The reference's lifecycle-hook chain (``ClientTrainer.on_after_local_training``
-> ``ServerAggregator.on_before_aggregation`` -> ``agg`` ->
``on_after_aggregation``) as three hooks over the flat ``(m, d)`` matrix of
stacked client contributions on their device, each row the reference's flat
vector of one client (``core.pytree.stacked_tree_to_matrix``: flax kernels,
JAX leaf order; a structured contribution such as SCAFFOLD's flattens
wholesale, as the reference's does):

1. :meth:`TrustPipeline.on_client_outputs`: the model attack and local DP
   (Gaussian: one launch of the noise kernel on the flattened matrix);
2. :meth:`TrustPipeline.on_aggregation`: the defense's ``before`` and
   ``on_agg`` (which may replace the aggregate);
3. :meth:`TrustPipeline.on_after_aggregation`: central DP (clip the global's
   delta, one launch of the noise kernel on the global) and the defense's
   ``after``.

Every random draw comes from the pipeline's sampler (``trust/dp/dp.py``
:class:`NoiseSampler` by default) by round index; a test hands in one that
returns the reference's draws.  Nothing here reads a device value back to
the host: selections and masks stay on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import weights as wlayout
from ..core import pytree as pt
from .attack.attacks import FedMLAttacker
from .defense import create as create_defense
from .defense.base import DrawingDefense
from .dp.dp import FedMLDifferentialPrivacy, NoiseSampler


class TrustPipeline:
    def __init__(self, cfg, sampler=None):
        self.cfg = cfg
        self.attacker = FedMLAttacker(cfg) if getattr(cfg, "enable_attack", False) else None
        self.defense = create_defense(cfg) if getattr(cfg, "enable_defense", False) else None
        self.dp = FedMLDifferentialPrivacy(cfg) if getattr(cfg, "enable_dp", False) else None
        self.sampler = sampler or NoiseSampler(getattr(cfg, "random_seed", 0))

    @property
    def active(self) -> bool:
        return any((self.attacker, self.defense, self.dp))

    @property
    def needs_history(self) -> bool:
        """True when the defense consumes the previous round's global delta
        (cross-round, WBC); the engine then threads it between rounds."""
        return self.defense is not None and hasattr(self.defense, "set_history")

    def supports_streaming(self) -> bool:
        """True when the pipeline never needs the stacked per-client matrix:
        only central DP, which touches the finalized aggregate alone."""
        return (self.attacker is None and self.defense is None
                and (self.dp is None or not self.dp.is_ldp_enabled()))

    # -- hook 1: on client outputs (attack simulation + LDP) -----------------
    def on_client_outputs(self, contribs, weights, sampled_idx, global_vars, round_idx: int):
        run_attack = self.attacker is not None and self.attacker.is_model_attack()
        run_ldp = self.dp is not None and self.dp.is_ldp_enabled()
        if not run_attack and not run_ldp:
            return contribs, weights
        mat = pt.stacked_tree_to_matrix(contribs)
        m, d = mat.shape
        if run_attack:
            gflat = self._reference_flat(contribs, global_vars, d, mat.device)
            noise = (self.sampler.attack(round_idx, (m, d), mat.device)
                     if self.attacker.needs_draw() else None)
            mat = self.attacker.poison_model(mat, sampled_idx, gflat, noise)
        if run_ldp:
            noise = self.sampler.local(round_idx, self.dp.mechanism, m, d, mat.device)
            mat = self.dp.add_local_noise(mat, noise)
        return pt.matrix_to_stacked_tree(mat, contribs), weights

    # -- hook 2: before / at aggregation (defenses) ---------------------------
    def on_aggregation(self, contribs, weights, global_vars, round_idx: int, prev_delta=None):
        """Returns (contribs, weights, the aggregate tree replacing the
        weighted mean or None)."""
        if self.defense is None:
            return contribs, weights, None
        if isinstance(self.defense, DrawingDefense):
            self.defense.set_draw(self._defense_draw(round_idx, weights.device))
        if prev_delta is not None and hasattr(self.defense, "set_history"):
            self.defense.set_history(prev_delta)
        mat = pt.stacked_tree_to_matrix(contribs)
        gflat = self._reference_flat(contribs, global_vars, mat.shape[1], mat.device)
        mat, weights = self.defense.before(mat, weights, gflat)
        agg_flat = self.defense.on_agg(mat, weights, gflat)
        contribs = pt.matrix_to_stacked_tree(mat, contribs)
        agg_tree = None
        if agg_flat is not None:
            one = pt.tree_map(lambda x: x[0], contribs)
            agg_tree = wlayout.flatten_reference(one)[1](agg_flat)
        return contribs, weights, agg_tree

    # -- hook 3: after aggregation (CDP + defense post) -----------------------
    def on_after_aggregation(self, new_global_vars, old_global_vars, round_idx: int):
        touched = False
        flat, unravel = wlayout.flatten_reference(new_global_vars)
        old_flat, _ = wlayout.flatten_reference(old_global_vars)
        if self.dp is not None and self.dp.is_cdp_enabled():
            flat = old_flat + self.dp.global_clip(flat - old_flat)
            draw = (self.sampler.gaussian if self.dp.mechanism == "gaussian"
                    else self.sampler.laplace)
            flat = self.dp.add_global_noise(flat, draw(round_idx, tuple(flat.shape), flat.device))
            touched = True
        if self.defense is not None:
            new_flat = self.defense.after(flat, old_flat)
            touched = touched or (new_flat is not flat)
            flat = new_flat
        return unravel(flat) if touched else new_global_vars

    def _defense_draw(self, round_idx: int, device):
        def draw(kind: str, shape: tuple) -> torch.Tensor:
            return self.sampler.defense(round_idx, kind, shape, device)

        return draw

    @staticmethod
    def _reference_flat(contribs, global_vars, d: int, device) -> torch.Tensor:
        """The global as the reference's flat vector when the contributions
        are weight-shaped, else zeros (e.g. gradient or SCAFFOLD
        contributions)."""
        one = pt.tree_map(lambda x: x[0], contribs)
        if pt.same_structure(one, global_vars):
            flat = wlayout.flatten_reference(global_vars)[0]
            if flat.shape[0] == d:
                return flat
        return torch.zeros(d, dtype=torch.float32, device=device)


def build_trust_pipeline(cfg, sampler=None) -> Optional[TrustPipeline]:
    tp = TrustPipeline(cfg, sampler)
    return tp if tp.active else None
