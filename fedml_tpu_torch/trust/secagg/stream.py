"""Streaming pairwise-mask secure aggregation, the field-domain fold (the
port's copy of ``fedml_tpu/trust/secagg/stream.py``: numpy, bitwise the
reference).

Pairwise-mask SecAgg is a sum over a modular ring, so masked uploads fold one
at a time into a running field total (peak buffered <= 2 at any cohort
size) and the masks come out once, at finalize.

- :class:`MaskedRing` / :func:`ring_for`: the masking ring a config implies
  (the dense fixed-point M31 field, or with ``comm_compression: qsgd8`` the
  quantize-then-mask ring).
- :func:`quantize_stochastic_int8` / :func:`dequantize_sum`: the qsgd8
  ring's int8 grid at a config-shared scale, and its decode.
- :func:`ring_mask` / :func:`mask_vector` / :func:`unmask_ring_total`: the
  masking equation over the ring, expanded with PCG64.
- :func:`pack_ring` / :func:`unpack_ring`: the smallest unsigned wire dtype
  that holds the ring.
- :class:`FieldStreamAccumulator` (the port's copy of
  ``fedml_tpu/parallel/stream_fold.py:196``) and :class:`StreamingMaskedSum`,
  the server-side fold.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from .field import DEFAULT_PRIME, dequantize_from_field

#: the dense path keeps the prime field M31; its wire is u32
DENSE_RING_BITS = 31

#: int8-grid value width of the qsgd8 composition (values in [-127, 127])
Q8_VALUE_BITS = 8


def ring_bits_for(value_bits: int, n_clients: int) -> int:
    """Bits of the power-of-two masking ring for sums of ``n_clients``
    values of ``value_bits`` signed width."""
    return value_bits + int(math.ceil(math.log2(max(int(n_clients), 1)))) + 1


class MaskedRing:
    """One masking ring: modulus, wire width and the quantizer it carries
    (``"dense"``: fixed point at ``frac_bits`` over M31; ``"qsgd8"``: the
    int8 grid at ``frac_bits`` over a cohort-sized power-of-two ring)."""

    __slots__ = ("codec", "modulus", "bits", "frac_bits", "n_clients")

    def __init__(self, codec: str, n_clients: int, frac_bits: int):
        self.codec = str(codec)
        self.n_clients = int(n_clients)
        self.frac_bits = int(frac_bits)
        if self.codec == "dense":
            self.bits = DENSE_RING_BITS
            self.modulus = DEFAULT_PRIME
        elif self.codec == "qsgd8":
            self.bits = ring_bits_for(Q8_VALUE_BITS, n_clients)
            self.modulus = 1 << self.bits
        else:
            raise ValueError(f"unknown secagg stream codec {self.codec!r}")

    def meta(self, length: int) -> dict:
        """Control-plane description of an upload (cross-checked by the
        server, so a ring mismatch is a loud reject)."""
        return {"codec": self.codec, "ring_bits": int(self.bits),
                "frac_bits": int(self.frac_bits), "length": int(length)}

    def wire_nbytes(self, length: int) -> int:
        """Bytes of a packed upload of ``length`` ring values (1-4 a value)."""
        return length * (1 if self.bits <= 8 else 2 if self.bits <= 16 else
                         3 if self.bits <= 24 else 4)

    def matches(self, meta: dict) -> bool:
        return (meta.get("codec") == self.codec
                and int(meta.get("ring_bits", -1)) == self.bits
                and int(meta.get("frac_bits", -1)) == self.frac_bits)


def ring_for(codec: Optional[str], n_clients: int, *, q_bits: int,
             q8_frac_bits: int) -> MaskedRing:
    """The ring a config implies: ``qsgd8`` selects the quantize-then-mask
    ring, anything else the dense fixed-point field (``q_bits`` fractional
    bits)."""
    if codec == "qsgd8":
        return MaskedRing("qsgd8", n_clients, q8_frac_bits)
    return MaskedRing("dense", n_clients, q_bits)


def quantize_stochastic_int8(flat: np.ndarray, frac_bits: int, seed) -> np.ndarray:
    """Vector -> int8-range integers on the fixed grid ``2^-frac_bits``,
    stochastically rounded (``floor(x * 2^bits + u)``, ``u`` from
    ``np.random.default_rng(seed)``: the qsgd8 rounding rule at a shared
    scale, so masked sums stay decodable); beyond the grid clipped to
    [-127, 127]."""
    scaled = np.asarray(flat, np.float64) * float(1 << int(frac_bits))
    u = np.random.default_rng(seed).random(scaled.shape)
    q = np.floor(scaled + u)
    return np.clip(q, -127, 127).astype(np.int64)


def dequantize_sum(total_signed: np.ndarray, ring: MaskedRing, n_summands: int) -> np.ndarray:
    """Centered ring total -> the f64 mean over ``n_summands`` uploads."""
    return (dequantize_from_field(total_signed, n_summands, p=ring.modulus, bits=ring.frac_bits)
            / max(int(n_summands), 1)).astype(np.float64)


# -- mask expansion -------------------------------------------------------------

def ring_mask(seed: int, d: int, modulus: int) -> np.ndarray:
    """Deterministic mask vector over the ring from a shared seed (PCG64)."""
    return np.random.default_rng(int(seed) % (2**31)).integers(
        0, int(modulus), size=d, dtype=np.int64)


def mask_vector(x_field: np.ndarray, client_id: int, peer_seeds: dict,
                self_seed: int, modulus: int) -> np.ndarray:
    """``y = x + PRG(b) + sum_{j>i} PRG(s_ij) - sum_{j<i} PRG(s_ij)  (mod
    ring)``."""
    d = len(x_field)
    y = (np.asarray(x_field, np.int64) + ring_mask(self_seed, d, modulus)) % modulus
    for j, s in peer_seeds.items():
        m = ring_mask(s, d, modulus)
        if j > client_id:
            y = (y + m) % modulus
        elif j < client_id:
            y = (y - m) % modulus
    return y


def unmask_ring_total(total: np.ndarray, self_seeds: dict,
                      dropped_pair_seeds: dict, modulus: int) -> np.ndarray:
    """Unmask a pre-summed ring total: subtract the survivors' self-masks,
    cancel the orphaned halves of dropped clients' pair masks."""
    total = np.asarray(total, np.int64) % modulus
    d = total.shape[0]
    for _u, b in self_seeds.items():
        total = (total - ring_mask(b, d, modulus)) % modulus
    for (i, j), s in dropped_pair_seeds.items():
        m = ring_mask(s, d, modulus)
        # survivor j's upload carries the uncancelled half of the (i, j)
        # pair mask: for j > i it added -m, for j < i it added +m
        if j > i:
            total = (total + m) % modulus
        else:
            total = (total - m) % modulus
    return total


# -- wire packing -----------------------------------------------------------------

def pack_ring(vec: np.ndarray, bits: int) -> np.ndarray:
    """Field elements in [0, 2^bits) -> the smallest little-endian unsigned
    wire array that holds them (u8 / u16 / packed 3 bytes / u32)."""
    v = np.asarray(vec, np.int64)
    if bits <= 8:
        return v.astype("<u1")
    if bits <= 16:
        return v.astype("<u2")
    if bits <= 24:
        quads = np.ascontiguousarray(v.astype("<u4")).view(np.uint8)
        return np.ascontiguousarray(quads.reshape(-1, 4)[:, :3]).reshape(-1)
    if bits <= 32:
        return v.astype("<u4")
    raise ValueError(f"ring of {bits} bits exceeds the 32-bit wire limit")


def unpack_ring(raw: np.ndarray, bits: int, length: int) -> np.ndarray:
    """Inverse of :func:`pack_ring` -> int64 field elements."""
    a = np.asarray(raw)
    if bits <= 16:
        out = a.view(f"<u{1 if bits <= 8 else 2}").astype(np.int64)
    elif bits <= 24:
        trip = a.view(np.uint8).reshape(-1, 3)
        quads = np.zeros((trip.shape[0], 4), np.uint8)
        quads[:, :3] = trip
        out = quads.reshape(-1).view("<u4").astype(np.int64)
    elif bits <= 32:
        out = a.view("<u4").astype(np.int64)
    else:
        raise ValueError(f"ring of {bits} bits exceeds the 32-bit wire limit")
    if out.shape[0] != int(length):
        raise ValueError(f"packed length {out.shape[0]} != declared {length}")
    return out


# -- the server-side streaming fold -------------------------------------------------

class FieldStreamAccumulator:
    """Per-leaf int64 sums over a masking ring.  Field sums are exact; the
    modulus comes out lazily (raw int64 adds carry ~2^62 / modulus folds
    before a reduce), so a fold costs one vector add."""

    def __init__(self, templates: Sequence[np.ndarray], modulus: int,
                 sums: Optional[Sequence[np.ndarray]] = None):
        self.modulus = int(modulus)
        init = sums if sums is not None else templates
        self._sums = [np.zeros(np.shape(t), np.int64) if sums is None
                      else np.asarray(t, np.int64) for t in init]
        self._pending = 0
        self._reduce_every = max(1, (2**62) // self.modulus)

    def fold_leaf(self, i: int, arr) -> None:
        self._sums[i] += np.asarray(arr, dtype=np.int64)
        if i == 0:
            self._pending += 1
            if self._pending >= self._reduce_every:
                self._reduce()

    def _reduce(self) -> None:
        for i, s in enumerate(self._sums):
            np.mod(s, self.modulus, out=self._sums[i])
        self._pending = 0

    def host_sums(self) -> list:
        """Per-leaf field totals, reduced mod the ring."""
        self._reduce()
        return [np.asarray(s) for s in self._sums]


class StreamingMaskedSum:
    """Fold masked field vectors one at a time; unmask once at finalize.
    ``peak_buffered`` counts the running total plus the one upload being
    folded (the <= 2 bound)."""

    def __init__(self, dim: int, ring: MaskedRing):
        self.ring = ring
        self.dim = int(dim)
        self._acc = FieldStreamAccumulator([np.zeros(self.dim, np.int64)], ring.modulus)
        self.folded = 0
        self.peak_buffered = 0

    def fold(self, vec: np.ndarray) -> None:
        v = np.asarray(vec, np.int64)
        if v.shape != (self.dim,):
            raise ValueError(f"masked vector shape {v.shape} != ({self.dim},)")
        self.peak_buffered = max(self.peak_buffered, (1 if self.folded else 0) + 1)
        self._acc.fold_leaf(0, v)
        self.folded += 1

    def masked_total(self) -> np.ndarray:
        """The reduced field total of everything folded so far."""
        return self._acc.host_sums()[0]

    def finalize(self, self_seeds: dict, dropped_pair_seeds: dict) -> np.ndarray:
        """Unmask the streamed total (centered signed int64)."""
        total = unmask_ring_total(self.masked_total(), self_seeds,
                                  dropped_pair_seeds, self.ring.modulus)
        half = self.ring.modulus // 2
        return np.where(total > half, total - self.ring.modulus, total)
