"""LightSecAgg: Lagrange-coded one-shot mask reconstruction (the port's
copy of ``fedml_tpu/trust/secagg/lightsecagg.py``: numpy int64 modular
math, bitwise the reference's for the same seed).

Each client draws a random mask ``z_i`` over F_p, splits it into ``U - T``
chunks, appends ``T`` random chunks and encodes them at ``N`` evaluation
points (one share per client); to unmask, each surviving client sends ONE
aggregate of the shares it holds from the survivors, and the server
interpolates the sum of the survivors' masks from any ``U`` of those
aggregates.  ``T`` colluders learn nothing; any ``N - U`` may drop.
"""

from __future__ import annotations

import numpy as np

from .field import DEFAULT_PRIME, gen_lagrange_coeffs


class LightSecAggProtocol:
    def __init__(self, n_clients: int, privacy_t: int, target_u: int, p: int = DEFAULT_PRIME,
                 seed: int = 0):
        """``N`` clients, privacy threshold ``T``, reconstruction target
        ``U`` (``T < U <= N``).  ``seed`` may be any non-negative int (a
        client feeds 256 bits of OS entropy): it seeds the mask stream
        through ``SeedSequence``."""
        if not 0 <= privacy_t < target_u <= n_clients:
            raise ValueError(f"LightSecAgg needs T({privacy_t}) < U({target_u}) <= "
                             f"N({n_clients})")
        self.n = n_clients
        self.t = privacy_t
        self.u = target_u
        self.p = p
        self.rng = np.random.RandomState(np.random.SeedSequence(seed).generate_state(8))
        # interpolation points of the U chunks and evaluation points of the
        # N clients: all distinct and non-zero
        self.alphas = np.arange(1, self.u + 1, dtype=np.int64)
        self.betas = np.arange(self.u + 1, self.u + self.n + 1, dtype=np.int64)

    def pad_len(self, d: int) -> int:
        """``d`` rounded up to a multiple of ``U - T``."""
        k = self.u - self.t
        return ((d + k - 1) // k) * k

    def gen_mask(self, d: int) -> np.ndarray:
        return self.rng.randint(0, self.p, size=self.pad_len(d), dtype=np.int64)

    def encode_mask(self, mask: np.ndarray, noise: np.ndarray = None) -> np.ndarray:
        """``(N, d' / (U - T))`` encoded sub-masks, row ``j`` for client
        ``j + 1`` (reference L47).  ``noise``, the ``T`` privacy chunks, is
        drawn from the protocol's stream unless given."""
        k = self.u - self.t
        chunks = mask.reshape(k, -1)
        if noise is None:
            noise = self.rng.randint(0, self.p, size=(self.t, chunks.shape[1]), dtype=np.int64)
        else:
            noise = np.asarray(noise, dtype=np.int64).reshape(self.t, chunks.shape[1])
        extended = np.concatenate([chunks, noise], axis=0)  # (U, s)
        w = gen_lagrange_coeffs(self.betas, self.alphas, self.p)  # (N, U)
        # reduced after every term: each product of two residues fits int64
        out = np.zeros((self.n, chunks.shape[1]), dtype=np.int64)
        for j in range(self.u):
            out = (out + w[:, j:j + 1] * extended[j:j + 1, :]) % self.p
        return out

    @staticmethod
    def aggregate_encoded_masks(shares: list) -> np.ndarray:
        """A surviving client's sum of the encoded sub-masks it holds from
        the survivors."""
        out = shares[0].copy()
        for s in shares[1:]:
            out = (out + s) % DEFAULT_PRIME
        return out

    def decode_aggregate_mask(self, agg_shares: dict, d_pad: int) -> np.ndarray:
        """The server's one-shot decode (reference L75): the sum of the
        survivors' masks interpolated from the first ``U`` aggregates by
        0-based client index."""
        survivors = sorted(agg_shares.keys())[: self.u]
        if len(survivors) < self.u:
            raise ValueError(f"need {self.u} aggregate masks, have {len(agg_shares)}")
        eval_pts = self.betas[np.array(survivors)]
        w = gen_lagrange_coeffs(self.alphas[: self.u - self.t], eval_pts, self.p)  # (U-T, U)
        s = agg_shares[survivors[0]].shape[0]
        chunks = np.zeros((self.u - self.t, s), dtype=np.int64)
        for col, cid in enumerate(survivors):
            chunks = (chunks + w[:, col:col + 1] * agg_shares[cid][None, :]) % self.p
        return chunks.reshape(-1)[:d_pad]
