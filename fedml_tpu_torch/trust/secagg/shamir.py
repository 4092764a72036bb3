"""Shamir secret sharing + pairwise-mask SecAgg math (the port's copy of
``fedml_tpu/trust/secagg/shamir.py``: numpy, bitwise the reference).

t-of-n Shamir shares over F_p, pairwise masks derived from shared seeds, and
mask reconstruction for dropped clients.
"""

from __future__ import annotations

import numpy as np

from .field import DEFAULT_PRIME, mod_inverse


def shamir_share(secret: int, n: int, t: int, rng: np.random.RandomState, p: int = DEFAULT_PRIME):
    """Split ``secret`` into n shares, any t reconstruct.  Returns
    [(x_i, y_i)] with x_i = 1..n."""
    coeffs = [int(secret) % p] + [int(rng.randint(0, p)) for _ in range(t - 1)]
    shares = []
    for x in range(1, n + 1):
        y = 0
        for a in reversed(coeffs):
            y = (y * x + a) % p
        shares.append((x, y))
    return shares


def shamir_reconstruct(shares, p: int = DEFAULT_PRIME) -> int:
    """Lagrange interpolation at 0 from >= t shares."""
    total = 0
    for i, (xi, yi) in enumerate(shares):
        num, den = 1, 1
        for j, (xj, _) in enumerate(shares):
            if i != j:
                num = (num * (-xj % p)) % p
                den = (den * ((xi - xj) % p)) % p
        total = (total + yi * num * mod_inverse(den, p)) % p
    return int(total)


def pairwise_mask(seed: int, d: int, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Deterministic mask vector from a shared pairwise seed."""
    return np.random.RandomState(seed % (2**31)).randint(0, p, size=d, dtype=np.int64)


def masked_input(x_field: np.ndarray, client_id: int, peer_seeds: dict[int, int], self_seed: int,
                 p: int = DEFAULT_PRIME) -> np.ndarray:
    """y_i = x_i + PRG(b_i) + sum_{j>i} PRG(s_ij) - sum_{j<i} PRG(s_ij)  (mod p)."""
    d = len(x_field)
    y = (x_field + pairwise_mask(self_seed, d, p)) % p
    for j, s in peer_seeds.items():
        m = pairwise_mask(s, d, p)
        if j > client_id:
            y = (y + m) % p
        elif j < client_id:
            y = (y - m) % p
    return y


def unmask_sum(masked: dict[int, np.ndarray], self_seeds: dict[int, int],
               dropped_pair_seeds: dict[tuple[int, int], int], p: int = DEFAULT_PRIME) -> np.ndarray:
    """Server: sum survivors' masked inputs, remove survivors' self-masks
    (revealed via Shamir) and dropped clients' pairwise masks."""
    ids = sorted(masked.keys())
    d = len(next(iter(masked.values())))
    total = np.zeros(d, dtype=np.int64)
    for i in ids:
        total = (total + masked[i]) % p
    return unmask_streamed(total, self_seeds, dropped_pair_seeds, p)


def unmask_streamed(total: np.ndarray, self_seeds: dict[int, int],
                    dropped_pair_seeds: dict[tuple[int, int], int],
                    p: int = DEFAULT_PRIME) -> np.ndarray:
    """Unmask a pre-summed field total."""
    total = np.asarray(total, np.int64) % p
    d = total.shape[0]
    for i, b in self_seeds.items():
        total = (total - pairwise_mask(b, d, p)) % p
    for (i, j), s in dropped_pair_seeds.items():
        m = pairwise_mask(s, d, p)
        # survivor j's masked input carries the uncancelled half of the (i, j)
        # pair mask: for j > i it added -m (peer i < j), for j < i it added +m
        if j > i:
            total = (total + m) % p
        else:
            total = (total - m) % p
    return total
