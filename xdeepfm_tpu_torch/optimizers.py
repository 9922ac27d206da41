"""Dense optimizers (port of the optax half of ``xdeepfm_tpu``'s
``basemodel._get_optimizer``; the lazy row-sparse embedding optimizers of
``xdeepfm_tpu/optimizers.py`` are not ported yet).

``sgd`` and ``adam`` are ``torch.optim.SGD`` and ``torch.optim.Adam``: their
update math is optax's (Adam's bias-corrected m/(sqrt(v) + eps) is the same
expression).  ``adagrad`` and ``rmsprop`` are not: optax starts adagrad's
accumulator at 0.1 and adds eps inside the square root of both, where
``torch.optim`` starts at 0 and adds eps outside.  So they are written here to
optax's math.  PyTorch picks its ``foreach`` implementation on CUDA tensors by
default; nothing here asks for ``fused``.
"""

from __future__ import annotations

import torch


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``: acc starts at ``initial_accumulator_value``;
    acc += g**2; p -= lr * g * rsqrt(acc + eps) where acc > 0."""

    def __init__(self, params, lr=0.01, eps=1e-7, initial_accumulator_value=0.1):
        super().__init__(
            params, dict(lr=lr, eps=eps, initial_accumulator_value=initial_accumulator_value)
        )

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                acc = state["sum"]
                acc.addcmul_(p.grad, p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.add_(scale * p.grad, alpha=-group["lr"])


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (not centered, no momentum): nu starts at 0;
    nu = decay * nu + (1 - decay) * g**2; p -= lr * g * rsqrt(nu + eps)."""

    def __init__(self, params, lr=0.01, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.add_(torch.rsqrt(nu + group["eps"]) * p.grad, alpha=-group["lr"])


def get_optimizer(optimizer, params, lr=None):
    """A name -> the optimizer over ``params`` with the JAX package's defaults
    (``xdeepfm_tpu/basemodel.py:76-89``, themselves the reference's torch
    defaults).  Any other callable is a factory, called with the parameter
    list (e.g. ``torch.optim.SGD`` or ``lambda ps: torch.optim.Adam(ps, 3e-4)``):
    it takes the place of an optax transformation."""
    params = list(params)
    if not isinstance(optimizer, str):
        if not callable(optimizer):
            raise TypeError("optimizer must be a name or a factory of torch.optim.Optimizer")
        return optimizer(params)
    if optimizer == "sgd":
        return torch.optim.SGD(params, lr=0.01 if lr is None else lr)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=1e-3 if lr is None else lr, eps=1e-8)
    if optimizer == "adagrad":
        return Adagrad(params, lr=0.01 if lr is None else lr, eps=1e-10)
    if optimizer == "rmsprop":
        return RMSprop(params, lr=0.01 if lr is None else lr, decay=0.99, eps=1e-8)
    raise NotImplementedError(optimizer)
