"""Core layers (port of ``xdeepfm_tpu/nn/core.py``; reference
``deepctr/layers/core.py``): BatchNorm, DNN, PredictionLayer,
LocalActivationUnit, ConvSame and Conv2dSame.

Parameters are created on the CPU from a ``torch.Generator`` seeded by the
model, so a seed gives the same weights on every device; the model moves them
to its device afterwards.  ``nn.Linear`` weights are ``[out, in]``, the
transpose of the JAX package's flax ``Dense`` kernels (``weights.py`` maps
one to the other).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import batch_ranks, batch_sum
from .activations import apply_activation, make_activation


def torch_linear_init(weight: torch.Tensor, generator: torch.Generator) -> None:
    """torch nn.Linear default init, in place: kaiming_uniform(a=sqrt(5)) ==
    U(±1/sqrt(fan_in)), with fan_in = weight.shape[1] for an ``[out, in]``
    weight."""
    fan_in = weight.shape[1]
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def torch_bias_init(
    bias: torch.Tensor, fan_in: int, generator: torch.Generator
) -> None:
    """torch nn.Linear default bias init U(±1/sqrt(fan_in)), in place."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        bias.uniform_(-bound, bound, generator=generator)


def glorot_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``glorot_uniform`` in place: U(±sqrt(6 / (fan_in + fan_out)))
    with the fans of flax's ``variance_scaling`` (in axis -2, out axis -1,
    each times the product of the other axes, the receptive field)."""
    receptive = math.prod(t.shape[:-2])
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout whose mask comes from ``generator`` (on x's device)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` (flax 0.12.3, ``use_fast_variance=True``) over
    the feature axis ``axis`` of its input.

    When ``training``: the batch statistics over every other axis, the mean
    E[x] and the biased variance max(E[x^2] - E[x]^2, 0), normalise the
    input, and the running values become ``momentum * running + (1 -
    momentum) * batch``.  Otherwise the running values normalise.  The output
    is (x - mean) * (rsqrt(var + eps) * scale) + bias, in fp32 at least.
    Leaves: the parameters ``scale`` (1) and ``bias`` (0), the buffers
    ``mean`` (0) and ``var`` (1), the JAX ``batch_stats`` of the same path
    (``weights.py``).  There is no batch counter.
    """

    def __init__(self, num_features: int, axis: int = -1, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.axis, self.momentum, self.eps = axis, momentum, eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x, training: bool = False):
        # at least fp32, as flax promotes: a bf16 product's statistics too
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        axis = self.axis % x.ndim
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        if training:
            dims = tuple(i for i in range(x.ndim) if i != axis)
            if batch_ranks() > 1:
                # on a rank grid: the moments of the global batch, as GSPMD
                # computes flax's mean over the sharded batch
                count = x.numel() // x.shape[axis] * batch_ranks()
                sums = batch_sum(torch.stack([x.sum(dims), (x * x).sum(dims)])) / count
                mean, mean_sq = sums[0], sums[1]
            else:
                mean, mean_sq = x.mean(dims), (x * x).mean(dims)
            # torch.maximum splits the gradient at a tie, as jnp.maximum does
            var = torch.maximum(mean_sq - mean * mean, mean.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class DNN(nn.Module):
    """MLP: Linear -> BatchNorm (``use_bn``) -> activation -> dropout per
    layer (reference: ``core.py:67-134``).

    Weight init: normal(std=init_std) as in ``core.py:114-116``; biases keep the
    torch Linear default U(±1/sqrt(fan_in)), which the reference does not
    re-init.  Layers are ``linear_{i}``, ``bn_{i}`` (eps 1e-5, momentum 0.9)
    and ``act_{i}`` as in the JAX parameter paths.
    """

    def __init__(
        self,
        inputs_dim: int,
        hidden_units: Sequence[int],
        activation: Union[str, Callable] = "relu",
        l2_reg: float = 0.0,
        dropout_rate: float = 0.0,
        use_bn: bool = False,
        init_std: float = 1e-4,
        dice_dim: int = 3,
        seed: int = 1024,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if len(hidden_units) == 0:
            raise ValueError("hidden_units is empty!!")
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.dropout_rate = dropout_rate
        self.use_bn = use_bn
        units = [inputs_dim] + list(hidden_units)
        self.n_layers = len(units) - 1
        self.acts = []
        for i in range(self.n_layers):
            lin = nn.Linear(units[i], units[i + 1])
            with torch.no_grad():
                lin.weight.normal_(0.0, init_std, generator=generator)
            torch_bias_init(lin.bias, units[i], generator)
            self.add_module(f"linear_{i}", lin)
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(units[i + 1]))
            act = make_activation(activation, units[i + 1], dice_dim)
            if isinstance(act, nn.Module):
                self.add_module(f"act_{i}", act)
            self.acts.append(act)

    def forward(self, x, training: bool = False, generator=None):
        """``generator`` draws the dropout masks when ``training``; the
        BatchNorm and Dice statistics update when ``training``."""
        h = x
        for i in range(self.n_layers):
            h = getattr(self, f"linear_{i}")(h)
            if self.use_bn:
                h = getattr(self, f"bn_{i}")(h, training=training)
            h = apply_activation(self.acts[i], h, training=training)
            if training:
                h = dropout(h, self.dropout_rate, generator)
        return h


class PredictionLayer(nn.Module):
    """Adds a scalar bias; sigmoid iff task == 'binary'
    (reference: ``core.py:137-160``)."""

    def __init__(self, task: str = "binary", use_bias: bool = True):
        super().__init__()
        if task not in ["binary", "multiclass", "regression"]:
            raise ValueError("task must be binary,multiclass or regression")
        self.task = task
        self.use_bias = use_bias
        if use_bias:
            self.global_bias = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        out = x
        if self.use_bias:
            out = out + self.global_bias
        if self.task == "binary":
            out = torch.sigmoid(out)
        return out


class LocalActivationUnit(nn.Module):
    """DIN attention MLP over [q, k, q - k, q * k] (reference
    ``core.py:10-64``): query [B, 1, E], keys [B, T, E] -> scores [B, T, 1].
    Parameters ``dnn`` (a :class:`DNN` over 4E inputs) and ``dense`` (one
    output, torch-Linear init).  Batch-major; the JAX ``call_t`` computed
    the same in its transposed layout."""

    def __init__(
        self,
        hidden_units: Sequence[int] = (64, 32),
        embedding_dim: int = 4,
        activation: Union[str, Callable] = "sigmoid",
        dropout_rate: float = 0.0,
        dice_dim: int = 3,
        l2_reg: float = 0.0,
        use_bn: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dnn = DNN(4 * embedding_dim, hidden_units, activation=activation, l2_reg=l2_reg,
                       dropout_rate=dropout_rate, use_bn=use_bn, dice_dim=dice_dim,
                       generator=generator)
        self.dense = nn.Linear(hidden_units[-1], 1)
        torch_linear_init(self.dense.weight, generator)
        torch_bias_init(self.dense.bias, hidden_units[-1], generator)

    def forward(self, query, user_behavior, training: bool = False, generator=None):
        q = query.expand(-1, user_behavior.shape[1], -1)
        att_input = torch.cat([q, user_behavior, q - user_behavior, q * user_behavior], dim=-1)
        return self.dense(self.dnn(att_input, training=training, generator=generator))


class ConvSame(nn.Module):
    """flax's ``nn.Conv`` with ``padding="SAME"`` and the reference's init,
    NHWC in and out: [B, H, W, C] -> [B, ceil(H / sh), ceil(W / sw),
    features].  CCPM's ``conv_{i}`` (``interaction.py:614-625``) and the
    inside of :class:`Conv2dSame`.

    Raw parameters in the flax layout: ``kernel`` [kh, kw, C, features]
    (:func:`glorot_uniform_`, the reference's ``xavier_uniform_``) and
    ``bias`` [features] (torch Conv2d's U(±1/sqrt(C * kh * kw))); the weights
    map carries them untransposed.  The padding is XLA's SAME: the total
    pad of an axis is max((out - 1) * stride + k - in, 0), the smaller half
    before.

    The convolution is one matmul of the kh * kw shifted windows, stacked
    along the channels in the kernel's (i, j, c) order, with the kernel
    reshaped to [kh * kw * C, features]: its products are an fp32 GEMM on
    the card, as every ``nn.Linear`` of the port, and cuDNN's TF32 default
    (``torch.backends.cudnn.allow_tf32``) never reaches them, forward or
    backward; the windows' backward is slices and adds, no atomics."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides=(1, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(1024)
        kh, kw = kernel_size
        self.kernel_size, self.strides = (kh, kw), tuple(strides)
        self.kernel = nn.Parameter(glorot_uniform_(torch.empty(kh, kw, in_channels, features),
                                                   generator))
        self.bias = nn.Parameter(torch.empty(features))
        torch_bias_init(self.bias, in_channels * kh * kw, generator)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        _, H, W, C = x.shape
        oh, ow = -(-H // sh), -(-W // sw)
        ph, pw = max((oh - 1) * sh + kh - H, 0), max((ow - 1) * sw + kw - W, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        windows = torch.cat([x[:, i : i + (oh - 1) * sh + 1 : sh, j : j + (ow - 1) * sw + 1 : sw]
                             for i in range(kh) for j in range(kw)], dim=-1)
        return windows @ self.kernel.reshape(kh * kw * C, -1) + self.bias


class Conv2dSame(nn.Module):
    """TF-style SAME-padding 2-D convolution, NHWC in and out (reference
    ``core.py:163-185``, a torch shim for what flax's NHWC ``Conv`` does;
    ``xdeepfm_tpu/nn/core.py:216-235``): one :class:`ConvSame` under the
    flax name ``Conv_0``, so its parameters are ``Conv_0/kernel`` and
    ``Conv_0/bias`` as in the JAX module."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides=(1, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = ConvSame(in_channels, features, kernel_size, strides, generator)

    def forward(self, x):
        return self.Conv_0(x)
