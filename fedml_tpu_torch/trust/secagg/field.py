"""Finite-field primitives for secure aggregation (the port's copy of
``fedml_tpu/trust/secagg/field.py``: numpy, bitwise the reference).

int64 modular arithmetic over the Mersenne prime M31; the prime is < 2^31,
so products fit in int64 without overflow.
"""

from __future__ import annotations

import numpy as np

DEFAULT_PRIME = 2**31 - 1  # Mersenne prime M31


def mod_inverse(a: int, p: int = DEFAULT_PRIME) -> int:
    """Fermat inverse (p prime)."""
    return pow(int(a) % p, p - 2, p)


def gen_lagrange_coeffs(eval_points: np.ndarray, interp_points: np.ndarray,
                        p: int = DEFAULT_PRIME) -> np.ndarray:
    """``(len(eval), len(interp))`` Lagrange basis coefficients over F_p:
    ``coeff[i, j] = prod_{k != j} (e_i - t_k) / (t_j - t_k)  (mod p)``."""
    ev = np.asarray(eval_points, dtype=np.int64) % p
    tp = np.asarray(interp_points, dtype=np.int64) % p
    ne, nt = len(ev), len(tp)
    out = np.zeros((ne, nt), dtype=np.int64)
    for j in range(nt):
        den = 1
        for k in range(nt):
            if k != j:
                den = (den * ((tp[j] - tp[k]) % p)) % p
        den_inv = mod_inverse(den, p)
        for i in range(ne):
            num = 1
            for k in range(nt):
                if k != j:
                    num = (num * ((ev[i] - tp[k]) % p)) % p
            out[i, j] = (num * den_inv) % p
    return out


def quantize_to_field(x: np.ndarray, p: int = DEFAULT_PRIME, bits: int = 16) -> np.ndarray:
    """Float -> field element: fixed point with 2^bits scale, negatives wrap
    mod p."""
    scale = float(2**bits)
    q = np.round(np.asarray(x, dtype=np.float64) * scale).astype(np.int64)
    return np.mod(q, p)


def dequantize_from_field(q: np.ndarray, n_summands: int, p: int = DEFAULT_PRIME,
                          bits: int = 16) -> np.ndarray:
    """Field element -> float, values above p/2 read as negative.
    ``n_summands`` bounds the accumulated negative wrap."""
    q = np.asarray(q, dtype=np.int64) % p
    half = p // 2
    signed = np.where(q > half, q - p, q)
    return signed.astype(np.float64) / float(2**bits)
