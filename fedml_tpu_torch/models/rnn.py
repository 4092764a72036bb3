"""Character and word LSTMs for the text benchmarks (the port of
``fedml_tpu/models/rnn.py``): ``CharLSTM`` (Shakespeare next character,
the reference's ``RNN_OriginalFedAvg``: an 8-wide embedding, two LSTM
layers of 256, a Dense over the vocabulary) and ``WordLSTM``
(StackOverflow next word, ``RNN_StackOverFlow``: a 96-wide embedding, one
LSTM of 670, ``Dense(96)``, a Dense over the vocabulary).

Variables keep flax's tree in torch layouts (``models/resnet.py``)::

    {"params": {"Embed_0": {"embedding": (vocab, embed)},
                "StackedLSTM_0": {"OptimizedLSTMCell_k": {
                    "ii" | "if" | "ig" | "io": {"kernel": (hidden, in)},
                    "hi" | "hf" | "hg" | "ho": {"kernel": (hidden, hidden), "bias": (hidden,)}}},
                "Dense_0": {"kernel": (out, in), "bias": (out,)}, ...}}

(``OptimizedLSTMCell``'s per-gate input kernels have no bias, its
recurrent ones do; a gate kernel is a Dense kernel, transposed; the
embedding table is not.)  The cell, from a zero carry, as flax computes it::

    z = (h W_h + b_h) + x W_i      (the four gates side by side)
    i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
    c' = f * c + i * g;  h' = o * tanh(c')

in f32 (the reference's LSTMs take no dtype).  Tokens are integer ids and
are never cast.

Lanes: tokens ``(L, N, T)`` with lane-stacked variables run ``L`` models at
once: the embedding is one gather from the lanes' tables laid end to end,
each layer's input products for all steps one ``torch.bmm``, each step's
recurrent product one ``torch.bmm`` (the time loop is a Python loop), each
Dense one ``torch.bmm``.  One model alone is the lane form with one lane.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.pytree import tree_map
from .resnet import _lecun_normal
from .simple import single_lane

_GATES = ("i", "f", "g", "o")


def _dense_init(c_in: int, c_out: int, g: torch.Generator) -> dict:
    return {"kernel": _lecun_normal((c_out, c_in), c_in, g), "bias": torch.zeros(c_out)}


def _cell_init(c_in: int, hidden: int, g: torch.Generator) -> dict:
    """flax ``OptimizedLSTMCell``'s variables: ``lecun_normal`` input
    kernels, orthogonal recurrent kernels, zero biases."""
    cell = {}
    for gate in _GATES:
        cell[f"i{gate}"] = {"kernel": _lecun_normal((hidden, c_in), c_in, g)}
        rec = torch.empty(hidden, hidden)
        torch.nn.init.orthogonal_(rec, generator=g)
        cell[f"h{gate}"] = {"kernel": rec, "bias": torch.zeros(hidden)}
    return cell


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """flax ``Embed`` of each lane: ``(L, V, E)`` tables, ``(L, N, T)``
    ids -> ``(L, N, T, E)``, one gather from the tables laid end to end."""
    lanes, vocab, _ = table.shape
    offsets = torch.arange(lanes, device=tokens.device).mul_(vocab).view(lanes, 1, 1)
    return torch.nn.functional.embedding(tokens.long() + offsets, table.reshape(lanes * vocab, -1))


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense`` (f32) of each lane over the last axis of ``(L, ...,
    in)``."""
    kernel = p["kernel"]
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    y = torch.bmm(flat, kernel.transpose(1, 2)) + p["bias"][:, None, :]
    return y.reshape(x.shape[:-1] + (kernel.shape[1],))


def lstm_layer(cell: dict, x: torch.Tensor) -> torch.Tensor:
    """``nn.RNN(OptimizedLSTMCell)`` of each lane: ``(L, N, T, in)`` ->
    ``(L, N, T, hidden)``, the carry from zero (module docstring)."""
    lanes, n, steps, c_in = x.shape
    w_in = torch.cat([cell[f"i{g}"]["kernel"] for g in _GATES], dim=1).transpose(1, 2)
    w_rec = torch.cat([cell[f"h{g}"]["kernel"] for g in _GATES], dim=1).transpose(1, 2)
    b_rec = torch.cat([cell[f"h{g}"]["bias"] for g in _GATES], dim=1)[:, None, :]
    hidden = w_rec.shape[1]
    x_proj = torch.bmm(x.reshape(lanes, n * steps, c_in), w_in).reshape(lanes, n, steps, -1)
    h = x.new_zeros((lanes, n, hidden))
    c = x.new_zeros((lanes, n, hidden))
    outs = []
    for t in range(steps):
        z = (torch.bmm(h, w_rec) + b_rec) + x_proj[:, :, t]
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h = torch.sigmoid(zo) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=2)


def stacked_lstm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``StackedLSTM`` (reference L18): its cells in order."""
    for k in range(len(p)):
        x = lstm_layer(p[f"OptimizedLSTMCell_{k}"], x)
    return x


class _TextModel:
    """Shared init / apply frame of the LSTMs."""

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        g = generator
        table = torch.empty(self.vocab_size, self.embed_dim)
        # flax Embed: variance_scaling(1.0, "fan_in", "normal", out_axis=0)
        torch.nn.init.normal_(table, std=1.0 / math.sqrt(self.embed_dim), generator=g)
        params = {"Embed_0": {"embedding": table}}
        cells, c_in = {}, self.embed_dim
        for k in range(self.layers):
            cells[f"OptimizedLSTMCell_{k}"] = _cell_init(c_in, self.hidden, g)
            c_in = self.hidden
        params["StackedLSTM_0"] = cells
        for k, c_out in enumerate(self._head()):
            params[f"Dense_{k}"] = _dense_init(c_in, c_out, g)
            c_in = c_out
        return tree_map(lambda t: t.to(device), {"params": params})

    def apply(self, variables: dict, tokens: torch.Tensor, train: bool = True):
        """``(N, T)`` ids -> ``(logits, {})``, f32 ``(N, T, vocab)``;
        ``(L, N, T)`` with lane-stacked variables -> ``(L, N, T, vocab)``."""
        p = variables["params"]
        if p["Embed_0"]["embedding"].ndim == 2:
            return single_lane(self, variables, tokens, train)
        x = stacked_lstm(p["StackedLSTM_0"], _embed(p["Embed_0"]["embedding"], tokens))
        for k in range(len(self._head())):
            x = _dense(p[f"Dense_{k}"], x)
        return x, {}


@dataclass(frozen=True)
class CharLSTM(_TextModel):
    """``CharLSTM`` (reference L33): 820,522 parameters at vocab 90."""

    vocab_size: int = 90
    embed_dim: int = 8
    hidden: int = 256
    layers: int = 2

    def _head(self) -> tuple:
        return (self.vocab_size,)


@dataclass(frozen=True)
class WordLSTM(_TextModel):
    """``WordLSTM`` (reference L47): 4,050,748 parameters at vocab 10,004."""

    vocab_size: int = 10004
    embed_dim: int = 96
    hidden: int = 670
    layers: int = 1

    def _head(self) -> tuple:
        return (self.embed_dim, self.vocab_size)
