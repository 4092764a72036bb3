"""Llama-style decoder-only transformer (the port of
``fedml_tpu/models/transformer.py``): RMSNorm, rotary embeddings,
(grouped-query) causal attention, a SwiGLU MLP.

The modules are ``nn.Module``s whose parameters carry flax's names and
layouts, so the variable tree (:meth:`Transformer.variables`) is the
reference's ``params`` tree key for key and shape for shape:

- ``embed/embedding`` ``(vocab, d_model)``;
- ``layer_{i}/attn/wq|wk|wv/kernel`` ``(d_model, heads, head_dim)`` and
  ``layer_{i}/attn/wo/kernel`` ``(heads, head_dim, d_model)`` (flax
  ``DenseGeneral``);
- ``layer_{i}/mlp/w_gate|w_up/kernel`` ``(d_model, d_ff)``,
  ``layer_{i}/mlp/w_down/kernel`` ``(d_ff, d_model)``;
- ``layer_{i}/attn_norm|mlp_norm/scale``, ``final_norm/scale``
  ``(d_model,)``; ``lm_head/kernel`` ``(d_model, vocab)``.

The forward takes the tree explicitly (``model(tokens, params)``; the
module's own parameters when ``params`` is None), so LoRA trains through
``merge(base, lora)`` without touching the module.  Its products are plain
``torch.matmul`` / ``einsum``: the reference computes them outside any
Pallas kernel.

flax's dtype rules, with explicit casts: parameters are f32; each Dense,
DenseGeneral and Embed casts its input and its kernel to ``cfg.dtype``
(``lm_head`` to ``cfg.logits_dtype``); ``RMSNorm`` rounds ``x * rsqrt(var)``
to x's dtype, then multiplies by its f32 scale, so it returns f32 and the
residual stream stays in ``cfg.dtype``; ``rope`` computes in f32 and casts
back; attention computes in f32 (``ops/attention.py``).

``cfg.remat`` checkpoints each block (``torch.utils.checkpoint``,
non-reentrant) and recomputes all of it in the backward, whatever
``cfg.remat_policy`` says: the field is kept for parity with the
reference's config.  Remat changes no number.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..ops.attention import dense_attention
from ..ops.ring_attention import ring_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "dots"  # the reference's field; every block recomputes in full
    logits_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, vocab_size: int = 1024):
        return cls(vocab_size=vocab_size, d_model=128, n_layers=2, n_heads=4,
                   n_kv_heads=4, d_ff=352, max_seq_len=512)

    @classmethod
    def llama_7b(cls):
        """Llama-2-7B's widths (the reference's FedLLM target model)."""
        return cls(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=32, d_ff=11008, max_seq_len=4096)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class _Kernel(nn.Module):
    """A flax ``Dense`` / ``DenseGeneral`` without bias: one ``kernel``."""

    def __init__(self, shape, device=None):
        super().__init__()
        self.kernel = _param(shape, device)


def _dense(x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype, in_dims: int = 1):
    """flax ``DenseGeneral`` over x's last ``in_dims`` axes: input and kernel
    cast to ``dtype``, one matrix product over the flattened axes."""
    n_in = math.prod(kernel.shape[:in_dims])
    xs = x.to(dtype).reshape(x.shape[:x.ndim - in_dims] + (n_in,))
    y = torch.matmul(xs, kernel.to(dtype).reshape(n_in, -1))
    return y.reshape(y.shape[:-1] + kernel.shape[in_dims:])


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), device)

    def forward(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
        return (x.to(torch.float32) * torch.rsqrt(var + self.eps)).to(x.dtype) * p["scale"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding, HF-Llama half-split convention, in f32
    and cast back to x's dtype.  x: ``(b, s, h, d)``."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[:, :, None, None].to(torch.float32) * freqs  # (b, s, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2].to(torch.float32), x[..., d // 2:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = _Kernel((cfg.d_model, cfg.n_heads, hd), device)
        self.wk = _Kernel((cfg.d_model, cfg.n_kv_heads, hd), device)
        self.wv = _Kernel((cfg.d_model, cfg.n_kv_heads, hd), device)
        self.wo = _Kernel((cfg.n_heads, hd, cfg.d_model), device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, p: dict,
                ring=None) -> torch.Tensor:
        cfg = self.cfg
        q = _dense(x, p["wq"]["kernel"], cfg.dtype)
        k = _dense(x, p["wk"]["kernel"], cfg.dtype)
        v = _dense(x, p["wv"]["kernel"], cfg.dtype)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.n_kv_heads != cfg.n_heads:  # GQA: each kv head serves rep query heads
            rep = cfg.n_heads // cfg.n_kv_heads
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        if ring is not None:  # the sequence split over the seq ranks
            out = ring_attention(q, k, v, ring, causal=True)
        else:
            out = dense_attention(q, k, v, causal=True)
        return _dense(out, p["wo"]["kernel"], cfg.dtype, in_dims=2)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.w_gate = _Kernel((cfg.d_model, cfg.d_ff), device)
        self.w_up = _Kernel((cfg.d_model, cfg.d_ff), device)
        self.w_down = _Kernel((cfg.d_ff, cfg.d_model), device)

    def forward(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        dtype = self.cfg.dtype
        gate = _dense(x, p["w_gate"]["kernel"], dtype)
        up = _dense(x, p["w_up"]["kernel"], dtype)
        # jax.nn.silu is x * sigmoid(x), and jax lowers the sigmoid to
        # 1 / (1 + exp(-x)) rounded op by op; in bf16 torch.sigmoid rounds
        # once, so a third of the elements differ (ROADMAP Queue 3)
        return _dense(gate * torch.sigmoid(gate) * up, p["w_down"]["kernel"], dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, p: dict,
                ring=None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x, p["attn_norm"]), positions, p["attn"], ring)
        return x + self.mlp(self.mlp_norm(x, p["mlp_norm"]), p["mlp"])


class _Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.embedding = _param((vocab, dim), device)


class Transformer(nn.Module):
    """``tokens (b, s)`` -> logits ``(b, s, vocab)`` in ``cfg.logits_dtype``.

    ``ring`` (``ops/ring_attention.Ring``, the reference's ``mesh`` /
    ``seq_axis``): the tokens are this rank's contiguous block of the
    sequence; RoPE takes the global positions and attention runs over the
    ring."""

    def __init__(self, cfg: TransformerConfig, device=None, ring=None):
        super().__init__()
        self.cfg = cfg
        self.ring = ring
        self.embed = _Embed(cfg.vocab_size, cfg.d_model, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg, device))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = _Kernel((cfg.d_model, cfg.vocab_size), device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "Transformer":
        """flax's initializers, drawn from ``generator`` on the parameters'
        device in the order of :meth:`variables`' leaves: the embedding
        ``normal(1 / d_model)``, every kernel lecun-normal over its input
        axes (a normal truncated to 2 std), every norm scale ones."""
        for path, t in sorted(self.named_parameters()):
            name = path.rsplit(".", 1)[-1]
            if name == "scale":
                t.fill_(1.0)
            elif name == "embedding":
                t.normal_(0.0, t.shape[1] ** -0.5, generator=generator)
            else:
                fan_in = math.prod(t.shape[:2 if path.endswith("wo.kernel") else 1])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        return self

    def variables(self) -> dict:
        """The module's parameters as the flax ``params`` tree (nested
        dicts keyed by the flax names; the leaves are the Parameters)."""
        tree: dict = {}
        for path, t in self.named_parameters():
            *parents, leaf = path.split(".")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = t
        return tree

    def forward(self, tokens: torch.Tensor, params: Optional[dict] = None) -> torch.Tensor:
        cfg = self.cfg
        p = self.variables() if params is None else params
        b, s = tokens.shape
        ring = self.ring if self.ring is not None and self.ring.size > 1 else None
        offset = 0 if ring is None else ring.index * s
        positions = torch.arange(offset, offset + s, device=tokens.device).expand(b, s)
        x = p["embed"]["embedding"][tokens].to(cfg.dtype)
        for i in range(cfg.n_layers):
            block = partial(getattr(self, f"layer_{i}"), p=p[f"layer_{i}"], ring=ring)
            if cfg.remat and torch.is_grad_enabled():
                x = ckpt.checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = self.final_norm(x, p["final_norm"])
        return _dense(x, p["lm_head"]["kernel"], cfg.logits_dtype)
