"""Activations (port of ``xdeepfm_tpu/nn/activations.py``; reference
``deepctr/layers/activation.py``).

Stateless activations are plain functions on tensors; ``PReLU`` carries one
learnable slope.  ``Dice`` (BatchNorm statistics) is not ported yet (D3).
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

    Returns either a stateless callable or a parameterized module (PReLU),
    which must be called with ``(x, training)``; call via
    :func:`apply_activation`.
    """
    if callable(act):
        return act
    act_l = act.lower()
    if act_l == "dice":
        raise NotImplementedError("Dice is not ported yet: ROADMAP.md, deferred item D3")
    if act_l == "prelu":
        return PReLU()
    return activation_fn(act_l)


def apply_activation(act, x, training: bool = False):
    if isinstance(act, PReLU):
        return act(x, training=training)
    return act(x)
