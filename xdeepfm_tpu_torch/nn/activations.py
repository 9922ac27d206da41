"""Activations (port of ``xdeepfm_tpu/nn/activations.py``; reference
``deepctr/layers/activation.py``).

Stateless activations are plain functions on tensors; ``PReLU`` carries one
learnable slope and ``Dice`` a slope per channel and a BatchNorm.
``Identity`` and ``activation_layer`` carry the reference's names.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn


class PReLU(nn.Module):
    """torch nn.PReLU: single learnable slope, init 0.25 (parameter path
    ``alpha`` as in the JAX module)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x, training: bool = False):
        return torch.where(x >= 0, x, self.alpha * x)


class Dice(nn.Module):
    """Data-adaptive activation from DIN (``activation.py:16-61``):
    ``alpha * (1 - p) * x + p * x`` with ``p = sigmoid(bn(x))``.

    ``dim=2``: input [B, C]; ``dim=3``: input [B, T, C], the statistics over
    (B, T), padded steps included.  Parameters ``alpha`` (zeros; (C,) at dim
    2, (C, 1) at dim 3, the reference's layout) and ``bn`` (flax BatchNorm,
    eps 1e-8, momentum 0.9, its statistics updated when ``training``)."""

    def __init__(self, emb_size: int, dim: int = 2, epsilon: float = 1e-8):
        super().__init__()
        from .core import BatchNorm  # core imports this module

        if dim not in (2, 3):
            raise ValueError(f"Dice dim must be 2 or 3, not {dim}")
        self.dim = dim
        self.alpha = nn.Parameter(torch.zeros((emb_size,) if dim == 2 else (emb_size, 1)))
        self.bn = BatchNorm(emb_size, momentum=0.9, eps=epsilon)

    def forward(self, x, training: bool = False):
        if x.ndim != self.dim:
            raise ValueError(f"Dice(dim={self.dim}) expects rank-{self.dim} input, "
                             f"got rank {x.ndim}")
        p = torch.sigmoid(self.bn(x, training=training))
        alpha = self.alpha if self.dim == 2 else self.alpha[:, 0]
        return alpha * (1 - p) * x + p * x


def _identity(x):
    return x


def activation_fn(name: str) -> Callable:
    """Stateless activations by name (subset of ``activation.py:57-84``)."""
    name = name.lower()
    if name == "sigmoid":
        return torch.sigmoid
    if name == "linear":
        return _identity
    if name == "relu":
        return torch.relu
    if name == "tanh":
        return torch.tanh
    if name == "leakyrelu":
        return F.leaky_relu  # slope 0.01, as flax's leaky_relu
    raise NotImplementedError(name)


def make_activation(
    act: Union[str, Callable],
    hidden_size: Optional[int] = None,
    dice_dim: int = 2,
):
    """Factory mirroring ``activation_layer`` (``activation.py:57-84``).

    Returns either a stateless callable or a parameterized module (Dice of
    ``hidden_size`` channels at rank ``dice_dim``, PReLU), which must be
    called with ``(x, training)``; call via :func:`apply_activation`.
    """
    if callable(act):
        return act
    act_l = act.lower()
    if act_l == "dice":
        if hidden_size is None:
            raise ValueError("Dice needs hidden_size")
        return Dice(hidden_size, dim=dice_dim)
    if act_l == "prelu":
        return PReLU()
    return activation_fn(act_l)


def apply_activation(act, x, training: bool = False):
    if isinstance(act, (Dice, PReLU)):
        return act(x, training=training)
    return act(x)


class Identity(nn.Module):
    """Pass-through activation (reference ``activation.py:48-54``)."""

    def forward(self, x):
        return x


# the reference's name for the str -> activation factory (``activation.py:57-84``)
activation_layer = make_activation
