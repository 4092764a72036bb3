"""Small models (the port of ``fedml_tpu/models/simple.py``): the logistic
regression of the ``lr`` recipes.

A model here follows the port's model interface (``models/resnet.py``): a
frozen description with ``init(generator, device)`` and ``apply(variables,
x, train) -> (logits, new_batch_stats)`` over the flax variable tree in
torch layouts, ``{"params": {"Dense_0": {"kernel": (out, in), "bias":
(out,)}}}``.

Semantics kept from flax: the input is flattened per sample; the reference's
``Dense`` has no ``dtype``, so it computes in the promoted dtype of its
input and its f32 parameters, which is f32 (a bf16 input, as local
training casts it, is widened); the product comes first and the bias is
added after it; init is ``lecun_normal`` for the kernel and zeros for the
bias.  The product is a plain ``torch.bmm``: the reference computes it
outside any Pallas kernel.

Lanes (the simulator's MESH round): a kernel with a leading lane axis,
``(L, out, in)``, marks lane-stacked variables, and ``x`` is then
``(L, N, ...)``.  The lane form is decided from the parameters, not from
``x``: the input is flattened, so a lane batch of images and a single batch
of higher rank look alike.  One model alone is the lane form with one
lane, so every lane computes what it computes alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .resnet import _lecun_normal


@dataclass(frozen=True)
class LogisticRegression:
    """``LogisticRegression`` (reference L16): one Dense layer over the
    flattened input."""

    num_classes: int = 10
    in_features: int = 60

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        kernel = _lecun_normal((self.num_classes, self.in_features), self.in_features, generator)
        dense = {"kernel": kernel, "bias": torch.zeros(self.num_classes)}
        return {"params": {"Dense_0": {k: v.to(device) for k, v in dense.items()}}}

    def apply(self, variables: dict, x: torch.Tensor, train: bool = True):
        """``x`` -> ``(logits, {})``: f32 ``(N, classes)``, or ``(L, N,
        classes)`` for lane-stacked variables."""
        dense = variables["params"]["Dense_0"]
        kernel, bias = dense["kernel"], dense["bias"]
        if kernel.ndim == 2:
            logits, _ = self.apply({"params": {"Dense_0": {"kernel": kernel[None],
                                                           "bias": bias[None]}}}, x[None], train)
            return logits[0], {}
        flat = x.reshape(x.shape[0], x.shape[1], -1).to(kernel.dtype)
        return torch.bmm(flat, kernel.transpose(1, 2)) + bias[:, None, :], {}
