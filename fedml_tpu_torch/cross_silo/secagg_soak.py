"""Simulated-cohort soak of streaming secure aggregation (the port of
``fedml_tpu/cross_silo/secagg_soak.py``).

Drives the server-side machinery of the Shamir protocol's streaming path
(``trust/secagg/stream.py``: :class:`StreamingMaskedSum` over the field
accumulator, ``mask_vector`` masking, the seed-reconstructed unmask at
finalize) at cohort sizes no thread-a-client harness reaches.  The masks
use the k-regular ring topology of scalable SecAgg (each client pair-masks
with ``neighbors`` peers a side), which changes nothing at the server.
``drop_before`` clients finish set-up but never upload (their orphaned pair
masks are cancelled from reconstructed seeds); ``drop_after`` clients
upload and vanish before the reveal (their self-masks are taken as
reconstructed from the others' shares, which is what the reveal yields).

Each client's local training is a cheap deterministic proxy (a short loop
of ``(PROXY_HIDDEN x d)`` matvecs), so the secure / plain throughput ratio
is an overhead bound.  What the soak asserts is the peak of buffered
updates (<= 2) and that the streamed masked sum equals the exact sum of the
quantized updates as an integer identity.  All of it is numpy on the host:
it launches no kernel.
"""

from __future__ import annotations

import time

import numpy as np

from ..trust.secagg import stream as secagg_stream
from ..trust.secagg.field import quantize_to_field
from .secagg_shamir import derive_round_seed

__all__ = ["run_secagg_stream_soak"]

#: hidden width and step count of the proxy local train
PROXY_HIDDEN = 64
PROXY_STEPS = 16


def _neighbors(u: int, cohort: int, k: int) -> list[int]:
    """The k-regular ring neighbourhood of client ``u`` (ids from 1)."""
    out = []
    for off in range(1, k + 1):
        out.append((u - 1 + off) % cohort + 1)
        out.append((u - 1 - off) % cohort + 1)
    return sorted(set(out) - {u})


def _pair_seed(u: int, v: int, round_idx: int) -> int:
    lo, hi = min(u, v), max(u, v)
    return derive_round_seed(lo * 1_000_003 + hi, round_idx)


def _self_seed(u: int, round_idx: int) -> int:
    return derive_round_seed(0xB00000 + u, round_idx)


def _proxy_update(w: np.ndarray, u: int, round_idx: int, dim: int, seed: int) -> np.ndarray:
    """A deterministic stand-in for a client's local delta."""
    rng = np.random.default_rng([seed, round_idx, u])
    x = rng.standard_normal(dim).astype(np.float32)
    d = np.zeros(dim, np.float32)
    for _ in range(PROXY_STEPS):
        h = np.tanh(w @ (x + d))
        d = d + 0.01 * (w.T @ h) / PROXY_HIDDEN
    return (d + 0.001 * x).astype(np.float32)


def run_secagg_stream_soak(cohort: int = 10_000, dim: int = 4096, rounds: int = 2,
                           neighbors: int = 2, codec: str = "qsgd8", frac_bits: int = 7,
                           q_bits: int = 16, drop_before_frac: float = 0.001,
                           drop_after_frac: float = 0.001, seed: int = 0) -> dict:
    """``rounds`` streamed secure rounds at ``cohort`` clients against the
    same rounds with SecAgg off (the plain f32 fold of the same proxy
    updates); returns the measurements and the integer identity's
    verdict."""
    ring = secagg_stream.ring_for(codec if codec == "qsgd8" else None, cohort, q_bits=q_bits,
                                  q8_frac_bits=frac_bits)
    id_rng = np.random.default_rng([seed, 0xD07])
    ids = np.arange(1, cohort + 1)
    n_db = int(round(cohort * drop_before_frac))
    n_da = int(round(cohort * drop_after_frac))
    struck = id_rng.choice(ids, size=n_db + n_da, replace=False)
    drop_before = set(int(u) for u in struck[:n_db])
    drop_after = set(int(u) for u in struck[n_db:])
    w_proxy = np.random.default_rng([seed, 0x17]).standard_normal(
        (PROXY_HIDDEN, dim)).astype(np.float32) / np.sqrt(dim)

    def quantize(x: np.ndarray, u: int, r: int) -> np.ndarray:
        if ring.codec == "qsgd8":
            q = secagg_stream.quantize_stochastic_int8(x, ring.frac_bits, [seed, r, u])
            return np.mod(q, ring.modulus)
        return quantize_to_field(x, p=ring.modulus, bits=ring.frac_bits)

    secure_s = plain_s = 0.0
    peak = 0
    bitwise = True
    uploaded: list[int] = []
    for r in range(rounds):
        # SecAgg on: quantize, mask, streamed fold, unmask
        msum = secagg_stream.StreamingMaskedSum(dim, ring)
        expect = np.zeros(dim, np.int64)  # the oracle, untimed
        uploaded = [int(u) for u in ids if u not in drop_before]
        t0 = time.perf_counter()
        for u in uploaded:
            xf = quantize(_proxy_update(w_proxy, u, r, dim, seed), u, r)
            peers = {v: _pair_seed(u, v, r) for v in _neighbors(u, cohort, neighbors)}
            msum.fold(secagg_stream.mask_vector(xf, u, peers, _self_seed(u, r), ring.modulus))
            t_oracle = time.perf_counter()
            expect += xf
            t0 += time.perf_counter() - t_oracle
        self_seeds = {u: _self_seed(u, r) for u in uploaded}
        dropped_pairs = {(u, v): _pair_seed(u, v, r)
                         for u in drop_before
                         for v in _neighbors(u, cohort, neighbors) if v not in drop_before}
        total = msum.finalize(self_seeds, dropped_pairs)
        secure_s += time.perf_counter() - t0
        peak = max(peak, msum.peak_buffered)
        half = ring.modulus // 2
        exp_mod = np.mod(expect, ring.modulus)
        exp_signed = np.where(exp_mod > half, exp_mod - ring.modulus, exp_mod)
        bitwise = bitwise and bool(np.array_equal(total, exp_signed))

        # SecAgg off: the same updates through the plain f32 fold
        acc = np.zeros(dim, np.float32)
        t0 = time.perf_counter()
        for u in uploaded:
            acc += np.float32(1.0) * _proxy_update(w_proxy, u, r, dim, seed)
        acc = acc / np.float32(len(uploaded))
        plain_s += time.perf_counter() - t0

    versions_on = rounds / max(secure_s, 1e-9)
    versions_off = rounds / max(plain_s, 1e-9)
    dense_ring = secagg_stream.ring_for(None, cohort, q_bits=q_bits, q8_frac_bits=frac_bits)
    return {
        "cohort": int(cohort),
        "dim": int(dim),
        "rounds": int(rounds),
        "codec": ring.codec,
        "ring_bits": int(ring.bits),
        "neighbors": int(neighbors),
        "dropped_before": len(drop_before),
        "dropped_after": len(drop_after),
        "peak_buffered": int(peak),
        "bitwise_identity": bool(bitwise),
        "versions_per_sec_on": round(versions_on, 3),
        "versions_per_sec_off": round(versions_off, 3),
        "throughput_ratio": round(versions_on / max(versions_off, 1e-9), 3),
        "bytes_per_round": int(ring.wire_nbytes(dim) * len(uploaded)),
        "bytes_per_round_dense_mask": int(dense_ring.wire_nbytes(dim) * len(uploaded)),
        "bytes_per_round_legacy_int64": int(8 * dim * len(uploaded)),
    }
