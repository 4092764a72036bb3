"""Ring attention: exact attention over a sequence split across ranks (the
port of ``fedml_tpu/ops/ring_attention.py``).

The reference shards the sequence over a mesh axis under ``shard_map``;
K/V blocks rotate around the ring by ``ppermute`` while each device keeps
its Q block and an online softmax ``(m, l, o)`` in f32, and causality skips
the blocks strictly in a device's future.  Here the ring is the ``seq``
ranks of the gloo process group (``parallel/multihost.py``), and a rotation
is one ``isend`` / ``irecv`` pair over host copies (K and V packed into one
buffer).  The block update is the reference's ``_block_attn_accum`` op for
op, in f32.

It is a ``torch.autograd.Function``: the forward keeps each row's
log-sum-exp, and the backward (the flash-attention backward) runs the ring
again with the K/V blocks rotating together with their ``dK`` / ``dV``
accumulators, which come home after a full turn, so the LLM trainer
differentiates it.  The plain version is :func:`ops.attention.dense_attention`
over the whole sequence (the reference's ``dense_attention``).  The
reference computes both in plain jnp, outside any Pallas kernel; so does
this, in torch.

RoPE takes the global positions (``ring.index * s_local + i``) and GQA
repeats the K/V heads before the ring (``models/transformer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import multihost
from .attention import NEG_INF, dense_attention


class Ring:
    """The ranks of one ring (global ranks, in ring order) and this rank's
    place in it; ``group`` the gloo group over them (None: the world)."""

    def __init__(self, ranks, rank: int, group=None):
        self.ranks = [int(r) for r in ranks]
        self.index = self.ranks.index(int(rank))
        self.size = len(self.ranks)
        self.group = group

    def rotate(self, *blocks: torch.Tensor) -> list:
        """Every block sent to the next rank of the ring and the previous
        rank's received (one packed f32 buffer a step)."""
        flat = torch.cat([b.reshape(-1) for b in blocks])
        got = multihost.send_recv(flat, self.ranks[(self.index + 1) % self.size],
                                  self.ranks[(self.index - 1) % self.size], self.group)
        return [g.view_as(b) for g, b in zip(got.split([b.numel() for b in blocks]), blocks)]


def _logits(q, k, q_off: int, k_off: int, causal: bool, scale: float):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[1], device=q.device)
        k_pos = k_off + torch.arange(k.shape[1], device=q.device)
        logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits, NEG_INF)
    return logits


def _block_attn_accum(q, k, v, q_off, k_off, m, l, o, causal: bool, scale: float):
    """One online-softmax update (the reference's): q ``(b, sq, h, d)``, k/v
    ``(b, sk, h, d)``, m/l ``(b, h, sq)``, o ``(b, sq, h, d)``, all f32."""
    logits = _logits(q, k, q_off, k_off, causal, scale)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.permute(0, 2, 1)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _visits(ring: Ring, causal: bool):
    """``(step, block origin, computed)`` of each of the ring's steps: the
    block held at step ``t`` came from ``index - t``; a causal ring skips
    the blocks in its future."""
    for step in range(ring.size):
        src = (ring.index - step) % ring.size
        yield step, src, (not causal or src <= ring.index)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, ring: Ring, causal: bool, scale: float):
        b, s, h, d = q.shape
        qf, kb, vb = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
        m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        for step, src, compute in _visits(ring, causal):
            if compute:
                m, l, o = _block_attn_accum(qf, kb, vb, ring.index * s, src * s, m, l, o,
                                            causal, scale)
            if step < ring.size - 1:
                kb, vb = ring.rotate(kb, vb)
        l = torch.clamp_min(l, 1e-30)
        out = o / l.permute(0, 2, 1)[..., None]
        ctx.save_for_backward(qf, k, v, out, m + torch.log(l))
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        qf, k, v, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        s = qf.shape[1]
        do = grad.to(torch.float32)
        delta = (do * out).sum(dim=-1).permute(0, 2, 1)  # (b, h, s)
        dq = torch.zeros_like(qf)
        kb, vb = k.to(torch.float32), v.to(torch.float32)
        dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
        for step, src, compute in _visits(ring, causal):
            if compute:
                p = torch.exp(_logits(qf, kb, ring.index * s, src * s, causal, scale)
                              - lse[..., None])
                dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
                ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vb) - delta[..., None])
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
                dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            # the accumulators travel with their block and are home after a
            # full turn; the blocks themselves are not needed after the last
            if step < ring.size - 1:
                kb, vb, dk, dv = ring.rotate(kb, vb, dk, dv)
            else:
                dk, dv = ring.rotate(dk, dv)
        qd, kd, vd = ctx.dtypes
        return dq.to(qd), dk.to(kd), dv.to(vd), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: Optional[Ring],
                   causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's ``(b, s_local, h, d)`` blocks of
    ``q``, ``k``, ``v`` (rank ``ring.index`` holds sequence positions
    ``[index * s_local, (index + 1) * s_local)``); returns this rank's
    block of the output in q's dtype.  A ring of one rank (or None) is
    :func:`dense_attention`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if ring is None or ring.size == 1:
        return dense_attention(q, k, v, causal=causal, scale=scale)
    return _RingAttention.apply(q, k, v, ring, causal, float(scale))
