"""MyAvg: CKA layer-selective personalized aggregation (the port of
``fedml_tpu/sim/myavg.py``).

What a round does, as in the reference:

- **Personal clients**: every client keeps its own model across rounds
  (``client_states``, one row a client, on the device); the sampled clients
  train from their personal weights, never from the global model, with the
  plain client SGD of FedAvg (lanes of one batched local train,
  ``fl/local_sgd.make_batched_local_train_fn``).
- **Layer schedule**: a round's config id picks which leaves aggregate:
  the first ``agg_mod_list`` entry that divides the round index (round 0
  exempt) selects its ``agg_mod_dict`` filter, else the default
  ``agg_*_layer`` :class:`LayerFilter`.  The filters compile to per-leaf
  mask tables once; the round reads them on the host.
- **Aggregation** of a gated-on leaf: the global takes the sample-weighted
  mean delta; a client's personal leaf is the old global plus either that
  mean delta or, for leaves the ``cka_*_layer`` filter selects, the mean
  over its CKA partners (:func:`linear_cka_matrix` over the clients' layer
  deltas reduced by :func:`as_rows`, :func:`partner_weights` top-k with
  thresholds, self always kept), corrected against the global mean delta
  for >=2-D leaves (a negative component projected out, the norm rescaled
  to the mean of the two: reference L393-406).  A gated-off leaf keeps the
  old global and each client's locally trained leaf.
- **Evaluation**: the global model on the test set, and each personal model
  on its own client's test shard (``test_client_idx``) or on the test set.

The config id is known on the host, so a gated-off leaf skips the CKA work
outright (the reference's ``lax.cond``); :attr:`MyAvgSimulator.cka_rounds`
counts the rounds in which it ran.

Trust (reference L349-367, L428-432): the sampled clients' trained models
go through the engine's trust hooks (``trust/pipeline.py``: the attack and
local DP, then the defense's ``before``) before the server rebuilds the
global and the personal models from them, so a reweighted client loses its
vote as a CKA partner too; central DP and the defense's ``after`` touch the
global only.  A leaf that does not aggregate keeps each client's clean
locally trained leaf, never the transformed copy.

Refused as the reference refuses them: the ``sp`` backend,
``enable_secagg`` / ``enable_fhe`` / ``enable_contribution`` and a defense
that replaces the aggregation (``on_agg``: MyAvg needs the clients'
individual deltas) (``NotImplementedError``), a non-positive
``agg_mod_list`` entry, a filter substring that matches no leaf and a
configured CKA filter that selects none (``ValueError``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..core import pytree as pt
from ..fl.local_sgd import lane_dropout_table, make_batched_local_train_fn, to_device
from ..trust.defense import create as create_defense
from ..trust.defense.base import Defense
from ..weights import flatten_reference
from .engine import MeshSimulator, client_dropout, refuse_multi_process, refuse_population

_MYAVG_REFUSED_TRUST = ("enable_secagg", "enable_fhe", "enable_contribution")


def refuse_unported_myavg(cfg) -> None:
    """The reference's refusals that need no model: ``sp``, the trust
    features that change the aggregation protocol, and a defense that
    replaces the aggregation."""
    if cfg.backend_sim == C.SIMULATION_BACKEND_SP:
        raise NotImplementedError("MyAvg runs as the batched round; the sequential sp twin is "
                                  "not provided for it (set backend_sim='MESH')")
    refuse_population(cfg, "MyAvg")
    refuse_multi_process(cfg, "MyAvg")
    active = [f for f in _MYAVG_REFUSED_TRUST if getattr(cfg, f, False)]
    if active:
        # masked or encrypted sums hide the individual deltas that the CKA
        # personalization needs; contribution replay assumes FedAvg's server
        raise NotImplementedError(f"trust features {active} are not wired into the MyAvg "
                                  "round; use a FedAvg-family optimizer for them")
    if getattr(cfg, "enable_defense", False):
        defense = create_defense(cfg)
        if type(defense).on_agg is not Defense.on_agg:
            # an aggregation-replacing defense collapses the m client deltas
            # to one aggregate: the per-client structure CKA personalizes from
            raise NotImplementedError(
                f"defense {type(defense).name!r} replaces the aggregation (on_agg); MyAvg needs "
                "per-client deltas — use a transforming defense (e.g. norm_diff_clipping, "
                "weak_dp, foolsgold) or a FedAvg-family optimizer")


class LayerFilter:
    """Substring layer selection (reference ``LayerFilter``): a dotted leaf
    path is kept iff it contains no ``unselect`` key, all ``all_select``
    keys and, if any are given, at least one ``any_select`` key.  An empty
    filter keeps everything."""

    def __init__(self, unselect: Sequence[str] = (), all_select: Sequence[str] = (),
                 any_select: Sequence[str] = ()):
        self.unselect = tuple(unselect or ())
        self.all_select = tuple(all_select or ())
        self.any_select = tuple(any_select or ())

    def __call__(self, path: str) -> bool:
        if not (self.unselect or self.all_select or self.any_select):
            return True
        return (all(k not in path for k in self.unselect)
                and all(k in path for k in self.all_select)
                and (not self.any_select or any(k in path for k in self.any_select)))


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """Dotted path per leaf in the leaf order (``params.Dense_0.kernel``):
    the names the substring filters match."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def as_rows(delta: torch.Tensor) -> torch.Tensor:
    """The lanes' layer deltas ``(m, ...)`` reduced to the ``(m, rows,
    cols)`` matrices CKA runs on (reference ``_as_rows``), rows the output
    features: a Dense kernel is already ``(out, in)`` here, a conv kernel
    ``(O, I, H, W)`` is mean-pooled over its spatial dims, a 1-D leaf
    becomes a column and a scalar a 1x1 matrix (the reference transposes
    flax's ``(in, out)`` and HWIO to the same)."""
    m = delta.shape[0]
    if delta.ndim == 1:
        return delta.reshape(m, 1, 1)
    if delta.ndim == 2:
        return delta[:, :, None]
    if delta.ndim == 3:
        return delta
    return delta.mean(dim=tuple(range(3, delta.ndim)))


def linear_cka_matrix(deltas: torch.Tensor) -> torch.Tensor:
    """Pairwise linear CKA over ``m`` clients' reduced layer matrices
    ``(m, r, c)`` (reference L117): with ``Kc = H X X^T H``, ``CKA(i, j) =
    <Kc_i, Kc_j> / (|Kc_i| |Kc_j|)``, 1 on the diagonal (also for a zero
    delta), clipped to <= 1."""
    m = deltas.shape[0]
    x = deltas.to(torch.float32)
    k = torch.bmm(x, x.transpose(1, 2))  # per-client kernel (m, r, r)
    k = k - k.mean(dim=1, keepdim=True)
    k = k - k.mean(dim=2, keepdim=True)
    flat = k.reshape(m, -1)
    gram = flat @ flat.T
    diag = torch.sqrt(torch.clamp(torch.diagonal(gram), min=0.0))
    denom = diag[:, None] * diag[None, :]
    pos = denom > 0
    cka = torch.where(pos, gram / torch.where(pos, denom, torch.ones_like(denom)),
                      torch.zeros_like(gram))
    eye = torch.eye(m, dtype=torch.bool, device=gram.device)
    cka = torch.where(eye, torch.ones_like(cka), cka)
    return torch.clamp(cka, max=1.0)


def partner_weights(cka: torch.Tensor, weights: torch.Tensor, k: int, lo: float,
                    hi: float) -> torch.Tensor:
    """Each client's partner weights ``(m, m)`` from its CKA row (reference
    ``partner_select``, L313): its ``k`` most similar clients within ``[lo,
    hi]``, itself always, weighted by sample counts and normalised.  On
    equal CKA values the lower client index ranks first, as ``lax.top_k``
    breaks ties: a stable sort of the negated row (``torch.topk`` promises
    no order among ties)."""
    m = cka.shape[0]
    top = torch.argsort(-cka, dim=1, stable=True)[:, :k]
    in_topk = torch.zeros_like(cka).scatter_(1, top, 1.0)
    ok = in_topk * (cka >= lo).to(cka.dtype) * (cka <= hi).to(cka.dtype)
    diag = torch.arange(m, device=cka.device)
    ok[diag, diag] = 1.0
    pw = weights[None, :] * ok
    return pw / torch.clamp(pw.sum(dim=1, keepdim=True), min=1e-12)


def _project_conflicts(g_cka: torch.Tensor, g_all: torch.Tensor) -> torch.Tensor:
    """The negative-projection correction of a >=2-D leaf (reference
    L393-406): where a client's partner delta points against the global mean
    delta, the conflicting component is projected out; the result is
    rescaled to the mean of the two norms."""
    axes = tuple(range(1, g_cka.ndim))
    a_n = torch.sqrt((g_cka ** 2).sum(dim=axes))
    gl_n = torch.sqrt((g_all ** 2).sum())
    a_hat = g_cka / pt.per_lane(torch.clamp(a_n, min=1e-12), g_cka)
    g_hat = g_all / torch.clamp(gl_n, min=1e-12)
    b = (a_hat * g_hat[None]).sum(dim=axes)
    a_opt = torch.where(pt.per_lane(b < 0, a_hat), a_hat - pt.per_lane(b, a_hat) * g_hat[None],
                        a_hat)
    return a_opt * pt.per_lane((a_n + gl_n) / 2.0, a_opt)


class MyAvgSimulator(MeshSimulator):
    """The engine with the MyAvg round (module docstring); ``client_states``
    holds every client's personal model."""

    def __init__(self, cfg, dataset, model, logger=None, device=None, sampler=None):
        refuse_unported_myavg(cfg)
        name = cfg.federated_optimizer
        # local training is plain client SGD; the MyAvg logic is the server's
        super().__init__(dataclasses.replace(cfg, federated_optimizer=C.FEDERATED_OPTIMIZER_FEDAVG),
                         dataset, model, logger=logger, device=device, sampler=sampler)
        self.cfg = dataclasses.replace(self.cfg, federated_optimizer=name)
        self._train_lanes = make_batched_local_train_fn(model, self.hp)
        n = dataset.n_clients
        self.client_states = pt.tree_map(
            lambda t: t.unsqueeze(0).repeat((n,) + (1,) * t.ndim), self.global_vars)
        self._personal_test = self._place_personal_test(dataset)

        paths = leaf_paths(self.global_vars)
        self._paths = paths
        self._mods = [int(mi) for mi in cfg.agg_mod_list]
        if any(mi <= 0 for mi in self._mods):
            raise ValueError(f"agg_mod_list entries must be positive, got {self._mods}")
        filters = [LayerFilter(cfg.agg_unselect_layer, cfg.agg_all_select_layer,
                               cfg.agg_any_select_layer)]
        for mi in self._mods:
            spec = cfg.agg_mod_dict.get(mi, cfg.agg_mod_dict.get(str(mi), {}))
            filters.append(LayerFilter(spec.get("agg_unselect_layer", ()),
                                       spec.get("agg_all_select_layer", ()),
                                       spec.get("agg_any_select_layer", ())))
        # [leaf][config id] -> does the leaf aggregate under that config
        self._agg_table = [[bool(f(p)) for f in filters] for p in paths]
        cka_f = LayerFilter(cfg.cka_unselect_layer, cfg.cka_all_select_layer,
                            cfg.cka_any_select_layer)
        self._cka_flags = [bool(cka_f(p)) for p in paths]
        # a filter substring that matches no leaf (a torch-vs-flax naming
        # slip) would silently degenerate MyAvg to FedAvg
        subs = (set(cfg.agg_unselect_layer) | set(cfg.agg_all_select_layer)
                | set(cfg.agg_any_select_layer) | set(cfg.cka_unselect_layer)
                | set(cfg.cka_all_select_layer) | set(cfg.cka_any_select_layer))
        for spec in cfg.agg_mod_dict.values():
            for key in ("agg_unselect_layer", "agg_all_select_layer", "agg_any_select_layer"):
                subs |= set(spec.get(key, ()))
        dead = sorted(s for s in subs if not any(s in p for p in paths))
        if dead:
            raise ValueError(f"MyAvg layer-filter substrings {dead} match NO model leaf "
                             f"path; known paths: {paths}")
        if (cfg.cka_any_select_layer or cfg.cka_all_select_layer or cfg.cka_unselect_layer) \
                and not any(self._cka_flags):
            raise ValueError("cka_*_select_layer is configured but selects zero leaves: the "
                             "CKA personalization would silently never run")
        self._topk = int(cfg.cka_select_topk)
        self._thresh = (float(cfg.cka_low_thresh), float(cfg.cka_high_thresh))
        #: rounds in which the CKA partner selection ran on some leaf
        self.cka_rounds = 0

    def _place_personal_test(self, dataset) -> Optional[tuple]:
        """Each client's test shard, cyclic-padded to one capacity (a
        multiple of the eval batch), on the device: ``(x, y, counts)``."""
        if dataset.test_client_idx is None:
            return None
        caps = [len(ix) for ix in dataset.test_client_idx]
        empty = [i for i, c in enumerate(caps) if c == 0]
        if empty:
            raise ValueError(f"clients {empty} have EMPTY per-client test shards; personalized "
                             "eval needs at least one test sample per client")
        cap = -(-max(caps) // self._eval_bs) * self._eval_bs
        reps = np.stack([np.resize(ix, cap) for ix in dataset.test_client_idx])
        return (torch.from_numpy(np.ascontiguousarray(dataset.test_x[reps])).to(self.device),
                torch.from_numpy(np.ascontiguousarray(dataset.test_y[reps])).to(self.device,
                                                                                 torch.long),
                caps)

    def config_id(self, round_idx: int) -> int:
        """The first ``agg_mod_list`` entry dividing ``round_idx`` wins;
        round 0 always takes the default filter (id 0)."""
        if round_idx == 0:
            return 0
        for i, mi in enumerate(self._mods):
            if round_idx % mi == 0:
                return i + 1
        return 0

    def _cka_personalize(self, delta: torch.Tensor, g_all: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
        """Each lane's partner-averaged delta of one leaf."""
        cka = linear_cka_matrix(as_rows(delta))
        pw = partner_weights(cka, weights, min(self._topk, delta.shape[0]), *self._thresh)
        g_cka = torch.tensordot(pw, delta, dims=1)
        return _project_conflicts(g_cka, g_all) if delta.ndim >= 3 else g_cka

    def _run_round_mesh(self, r: int) -> dict:
        """The sampled clients train from their personal models as lanes,
        then the server rebuilds the global and their personal models leaf
        by leaf."""
        sampled = np.asarray(self.sampler.sample(r))
        m = len(sampled)
        lanes = to_device(sampled, self.device, torch.long)
        counts = self.counts[sampled]
        perms = torch.stack([self.sampler.perms(r, int(ci), self.hp.epochs, self.capacity)
                             for ci in sampled])
        drops = client_dropout(self.sampler, self.model, self.hp, r, sampled, counts, self.device)
        trained, metrics = self._train_lanes(
            pt.tree_take(self.client_states, lanes), self._data[0], self._data[1], lanes, counts,
            perms, None, None if drops is None else lane_dropout_table(drops))
        weights = to_device(counts, self.device, torch.float32)
        old = self.global_vars
        # the clients keep their clean trained models; the trust hooks
        # transform only the copy the server aggregates from
        retained = trained
        if self.trust is not None:
            trained, weights = self.trust.on_client_outputs(trained, weights, sampled, old, r)
            trained, weights, agg = self.trust.on_aggregation(
                trained, weights, old, r, prev_delta=self.defense_history)
            if agg is not None:
                raise NotImplementedError("the trust pipeline returned an aggregation override; "
                                          "MyAvg needs per-client deltas")
        wnorm = weights / torch.clamp(weights.sum(), min=1e-12)
        cid = self.config_id(r)
        new_g, new_p, cka_ran = [], [], False
        with torch.no_grad():
            for li, (g, t, t_clean) in enumerate(zip(pt.tree_leaves(old), pt.tree_leaves(trained),
                                                     pt.tree_leaves(retained))):
                if not self._agg_table[li][cid]:
                    # gated off: the global keeps its leaf, each client its
                    # clean locally trained one
                    new_g.append(g)
                    new_p.append(t_clean)
                    continue
                delta = (t - g[None]).to(torch.float32)
                g_all = torch.tensordot(wnorm, delta, dims=1)  # the weighted mean delta
                new_g.append((g + g_all).to(g.dtype))
                if self._cka_flags[li] and g.ndim > 0:
                    pers = self._cka_personalize(delta, g_all, weights)
                    cka_ran = True
                else:
                    pers = g_all.expand((m,) + tuple(g.shape))
                new_p.append((g[None] + pers).to(t.dtype))
            new_global = pt.tree_unflatten_like(old, new_g)
            if self.trust is not None:
                # central DP and the defense's after() on the global only
                new_global = self.trust.on_after_aggregation(new_global, old, r)
            self.global_vars = new_global
            pt.tree_scatter_(self.client_states, lanes, pt.tree_unflatten_like(old, new_p))
            if self.defense_history is not None:
                self.defense_history = flatten_reference(new_global)[0] - flatten_reference(old)[0]
        self.cka_rounds += int(cka_ran)
        out = {k: v.to(torch.float32).mean() for k, v in metrics.items()}
        out["myavg_config_id"] = torch.tensor(float(cid), device=self.device)
        return out

    def evaluate(self) -> dict:
        """The global model's test eval and the personal models'."""
        out = super().evaluate()
        out.update(self.evaluate_personalized())
        return out

    def evaluate_personalized(self) -> dict:
        """Mean and min test accuracy of the clients' personal models, each
        on its own test shard where the dataset has them."""
        accs = []
        for i in range(self.dataset.n_clients):
            personal = pt.tree_map(lambda t: t[i], self.client_states)
            if self._personal_test is not None:
                tx, ty, caps = self._personal_test
                res = self._eval_fn(personal, tx[i], ty[i], caps[i])
            else:
                res = self._eval_fn(personal, *self._test)
            accs.append(res["test_acc"])
        accs = torch.stack(accs).cpu()
        return {"personalized_test_acc_mean": float(accs.mean()),
                "personalized_test_acc_min": float(accs.min())}
