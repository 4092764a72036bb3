"""Privacy attacks: DLG gradient inversion and label revelation (the port of
``fedml_tpu/trust/attack/dlg.py``).

DLG ("Deep Leakage from Gradients", Zhu et al.) reconstructs a victim's
training inputs by optimizing dummy data until its gradients match the
victim's; the inversion attack ("Inverting Gradients", Geiping et al.)
matches them by cosine distance with known labels and a total-variation
prior.  Both differentiate the matching objective through a gradient of
the model: ``grad_fn`` builds its gradients with ``create_graph=True``.
The optimizer is optax's ``adam(lr)`` in its order of operations
(``fl/optim.Adam``), one step a loop iteration, as the reference's
``lax.scan`` steps it.

The random starts are arguments (``x0``, ``y0``): tests hand in the
reference's ``jax.random`` draws; without them the port draws its own
(``torch.randn * 0.1`` from ``seed``).  Through a model built with
``fused_blocks`` the second-order pass raises (``ops/fused_block.py``
``SECOND_ORDER_REFUSAL``), as the reference fails there.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...core import pytree as pt
from ...fl.optim import Adam


def revealing_labels_from_gradients(last_layer_grad_b: torch.Tensor) -> torch.Tensor:
    """Labels present in the victim batch from the last dense layer's bias
    gradient (the iDLG sign rule: ``dL/db_c < 0`` exactly when class ``c``
    appears, for reasonably calibrated logits); ``(classes,)`` bool."""
    return last_layer_grad_b < 0


def _start(shape: tuple, given: Optional[torch.Tensor], seed: int, device) -> torch.Tensor:
    if given is not None:
        return torch.as_tensor(given, dtype=torch.float32, device=device).clone()
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, device=device) * 0.1


def _tree_sum(values) -> torch.Tensor:
    """``tree_reduce(add, values, 0.0)``: a left fold from f32 zero."""
    total = None
    for v in values:
        total = v if total is None else total + v
    return torch.zeros(()) if total is None else total


def dlg_attack(grad_fn: Callable, victim_grads, x_shape: tuple, n_classes: int, *,
               x0: Optional[torch.Tensor] = None, y0: Optional[torch.Tensor] = None,
               seed: int = 0, steps: int = 200, lr: float = 0.1, device=None):
    """Reconstruct ``(x, y probabilities)`` whose gradients match
    ``victim_grads``.  ``grad_fn(x, y_soft)`` returns the model's gradients
    (a tree or sequence aligned with ``victim_grads``, built with
    ``create_graph=True``).  Returns ``(x_hat, y_soft_hat, final_loss)``,
    the loss of the last step (before its update)."""
    victim = pt.tree_leaves(victim_grads) if isinstance(victim_grads, dict) else list(victim_grads)
    device = device if device is not None else victim[0].device
    xy = {"x": _start(tuple(x_shape), x0, seed, device),
          "y": _start((x_shape[0], n_classes), y0, seed + 1, device)}
    opt = Adam(lr)
    state = opt.init(xy)
    loss = None
    for _ in range(steps):
        x = xy["x"].detach().requires_grad_(True)
        y = xy["y"].detach().requires_grad_(True)
        g = grad_fn(x, torch.softmax(y, dim=-1))
        g = pt.tree_leaves(g) if isinstance(g, dict) else list(g)
        loss = _tree_sum(torch.sum((a - b) ** 2) for a, b in zip(g, victim))
        gx, gy = torch.autograd.grad(loss, (x, y))
        xy, state = opt.update({"x": gx, "y": gy}, state, {"x": x.detach(), "y": y.detach()})
    return xy["x"], torch.softmax(xy["y"], dim=-1), loss.detach()


def _total_variation(x: torch.Tensor) -> torch.Tensor:
    """The TV prior over an image batch ``(b, h, w, ...)``; zero for flat
    feature vectors."""
    if x.ndim >= 3:
        dh = torch.abs(x[:, 1:, :] - x[:, :-1, :]).mean()
        dw = torch.abs(x[:, :, 1:] - x[:, :, :-1]).mean()
        return dh + dw
    return torch.zeros((), dtype=torch.float32, device=x.device)


def invert_gradient_attack(grad_fn: Callable, victim_grads, x_shape: tuple,
                           labels: torch.Tensor, *, x0: Optional[torch.Tensor] = None,
                           seed: int = 0, steps: int = 300, lr: float = 0.1,
                           tv_weight: float = 1e-2, n_classes: int = 0):
    """The inversion attack (reference ``invert_gradient_attack``): known
    labels, the sum over gradient tensors of the cosine distance ``1 -
    <a, b> / (|a| |b| + 1e-12)``, plus ``tv_weight`` times the TV prior,
    minimized by Adam on the gradient's sign.  ``grad_fn(x, y_onehot)``
    returns the gradients (``create_graph=True``); pass ``n_classes`` when
    the last 1-D gradient leaf is not the head's bias.  Returns ``(x_hat,
    final_loss)``."""
    victim = pt.tree_leaves(victim_grads) if isinstance(victim_grads, dict) else list(victim_grads)
    labels = torch.as_tensor(labels, device=victim[0].device).long()
    n = n_classes or victim_grads_classes(victim_grads, labels)
    y_onehot = torch.nn.functional.one_hot(labels, n).to(torch.float32)
    xs = {"x": _start(tuple(x_shape), x0, seed, victim[0].device)}
    opt = Adam(lr)
    state = opt.init(xs)
    loss = None
    for _ in range(steps):
        x = xs["x"].detach().requires_grad_(True)
        g = grad_fn(x, y_onehot)
        g = pt.tree_leaves(g) if isinstance(g, dict) else list(g)
        dists = (1.0 - torch.sum(a * b)
                 / (torch.linalg.vector_norm(a.reshape(-1)) * torch.linalg.vector_norm(b.reshape(-1))
                    + 1e-12) for a, b in zip(g, victim))
        loss = _tree_sum(dists) + tv_weight * _total_variation(x)
        (gx,) = torch.autograd.grad(loss, (x,))
        # signed gradient descent (the paper's choice under the cosine
        # objective's scale)
        xs, state = opt.update({"x": torch.sign(gx)}, state, {"x": x.detach()})
    return xs["x"], loss.detach()


def victim_grads_classes(victim_grads, labels) -> int:
    """The class count from the last 1-D gradient leaf (the head's bias)
    when there is one, else from the labels."""
    leaves = pt.tree_leaves(victim_grads) if isinstance(victim_grads, dict) else list(victim_grads)
    for leaf in reversed(leaves):
        if leaf.ndim == 1:
            return int(leaf.shape[0])
    return int(torch.as_tensor(labels).max()) + 1
