"""Additively homomorphic RLWE encryption for federated aggregation (the
port of ``fedml_tpu/trust/fhe/rlwe.py``; host numpy, bitwise the
reference's).

A BFV-style scheme over R_q = Z_q[x]/(x^N + 1)::

    keygen:   s <- {-1, 0, 1}^N (ternary secret)
    encrypt:  a <- U(Z_q^N);  e <- small noise
              ct = (c0, c1) = (-(a*s) + e + delta * m,  a)      delta = q // t
    add:      component-wise mod q (the noise adds linearly)
    scale:    integer plaintext scalar w: (w*c0, w*c1)
    decrypt:  m = round_t((c0 + c1 * s mod q, centred) / delta)

Floats are fixed point at ``2^frac_bits`` in Z_t, negatives wrapped.  The
exact integer arithmetic runs on numpy object arrays (a negacyclic product
reaches q^2 N ~ 2^110, past any machine integer: ``np.convolve`` on object
ints); the wire form is int64 (q < 2^62).

The encryption draws (``a`` and ``e``) come from OS entropy, as in the
reference; a cipher built with ``rng`` (a ``numpy.random.RandomState``)
draws them from it instead, so a test can hand both packages the same
draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class RLWEParams:
    n: int = 1024               # ring dimension (a power of two)
    q: int = 1 << 50            # ciphertext modulus
    t: int = 1 << 30            # plaintext modulus
    noise_bound: int = 4        # uniform noise in [-b, b]
    frac_bits: int = 16         # fixed-point fraction bits

    @property
    def delta(self) -> int:
        return self.q // self.t


def poly_mul_negacyclic(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Exact ``(a * b) mod (x^N + 1, q)`` by an object-int convolution."""
    n = len(a)
    full = np.convolve(a.astype(object), b.astype(object))
    out = full[:n].copy()
    out[: len(full) - n] -= full[n:]  # x^N = -1
    return np.mod(out, q)


def keygen(params: RLWEParams, rng: np.random.RandomState) -> np.ndarray:
    return rng.randint(-1, 2, size=params.n).astype(object)


@dataclass
class Ciphertext:
    c0: np.ndarray  # object ints mod q
    c1: np.ndarray

    def to_int64(self) -> np.ndarray:
        """The ``(2, N)`` int64 wire form (q < 2^62)."""
        return np.stack([self.c0.astype(np.int64), self.c1.astype(np.int64)])

    @classmethod
    def from_int64(cls, arr: np.ndarray) -> "Ciphertext":
        return cls(arr[0].astype(object), arr[1].astype(object))


class RLWECipher:
    """The shared-context cipher: every party built with the same
    ``key_seed`` holds the same secret key."""

    def __init__(self, params: RLWEParams = RLWEParams(), key_seed: int = 0,
                 rng: Optional[np.random.RandomState] = None):
        self.params = params
        self._s = keygen(params, np.random.RandomState(
            np.random.SeedSequence(key_seed).generate_state(8)))
        # the encryption randomness is never shared: OS entropy by default
        self._rng = rng if rng is not None else np.random.RandomState(
            np.random.SeedSequence().generate_state(8))

    # -- fixed point -------------------------------------------------------------
    def encode(self, x: np.ndarray) -> np.ndarray:
        p = self.params
        q = np.round(np.asarray(x, dtype=np.float64) * (1 << p.frac_bits)).astype(object)
        return np.mod(q, p.t)

    def decode(self, m: np.ndarray) -> np.ndarray:
        p = self.params
        m = np.mod(m.astype(object), p.t)
        signed = np.where(m > p.t // 2, m - p.t, m)
        return signed.astype(np.float64) / (1 << p.frac_bits)

    # -- one block ---------------------------------------------------------------
    def encrypt_poly(self, m: np.ndarray) -> Ciphertext:
        p = self.params
        a = self._rng.randint(0, 1 << 62, size=p.n).astype(object) % p.q
        e = self._rng.randint(-p.noise_bound, p.noise_bound + 1, size=p.n).astype(object)
        c0 = np.mod(-poly_mul_negacyclic(a, self._s, p.q) + e + p.delta * m, p.q)
        return Ciphertext(c0, a)

    def decrypt_poly(self, ct: Ciphertext) -> np.ndarray:
        p = self.params
        raw = np.mod(ct.c0 + poly_mul_negacyclic(ct.c1, self._s, p.q), p.q)
        centered = np.where(raw > p.q // 2, raw - p.q, raw)
        # an exact rounding division on object ints (float64 drops bits at 2^50)
        d = p.delta
        m = np.array([(int(v) + d // 2) // d for v in centered], dtype=object)
        return np.mod(m, p.t)

    # -- vectors -----------------------------------------------------------------
    def encrypt_vector(self, x: np.ndarray) -> List[np.ndarray]:
        """A float vector -> its ``(2, N)`` int64 ciphertext blocks."""
        p = self.params
        m = self.encode(x)
        m = np.concatenate([m, np.zeros((-len(m)) % p.n, dtype=object)])
        return [self.encrypt_poly(m[i: i + p.n]).to_int64() for i in range(0, len(m), p.n)]

    def decrypt_vector(self, blocks: List[np.ndarray], length: int) -> np.ndarray:
        out = np.concatenate([self.decrypt_poly(Ciphertext.from_int64(b)) for b in blocks])
        return self.decode(out[:length])


def add_ciphertexts(blocks_list: List[List[np.ndarray]], q: int) -> List[np.ndarray]:
    """The server's one operation: the component-wise sum of the clients'
    block lists, mod q (no key needed)."""
    out = []
    for b in range(len(blocks_list[0])):
        acc = np.zeros_like(blocks_list[0][b], dtype=object)
        for blocks in blocks_list:
            acc = acc + blocks[b].astype(object)
        out.append(np.mod(acc, q).astype(np.int64))
    return out


def scale_ciphertext(blocks: List[np.ndarray], w: int, q: int) -> List[np.ndarray]:
    """An integer plaintext scalar times every block."""
    return [np.mod(b.astype(object) * int(w), q).astype(np.int64) for b in blocks]
