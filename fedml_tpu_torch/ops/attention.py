"""Dense causal attention (the port of ``dense_attention`` in
``fedml_tpu/ops/ring_attention.py``).

The reference computes it in plain jnp, outside any Pallas kernel, and so
does this: the logits and the softmax in f32 from q and k upcast, a causal
``tril`` mask with ``NEG_INF``, the product with v upcast, then a cast back
to q's dtype.  Ring attention over a ``seq`` axis of ranks is
``ops/ring_attention.py``; this is its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``q, k, v``: ``(b, s, h, d)`` -> ``(b, s, h, d)`` in q's dtype."""
    s, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32)).to(q.dtype)
