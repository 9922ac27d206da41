"""Attention-pooled CIN (port of ``xdeepfm_tpu/nn/cin_attention.py``;
reference ``deepctr/layers/cin_attention.py``).

Replaces the CIN's sum-pool over the embedding axis with MHSA over the
feature-map axis and attention pooling.  The block runs transposed,
[B, E, S] (S feature maps), as the row-major CIN stack emits it.  Routing
follows the JAX package exactly:

* V1 (:class:`CINAttention`) takes the fused block (``ops.attn_block``) when
  ``attn_dropout == 0 or not training``, and the fused gate allows it;
* V2 (:class:`CINAttentionV2`) takes it only with ``num_attn_layers == 1``
  (and the same dropout rule);
* everything else takes the unfused route, each MHSA through
  ``ops.attention.small_attention``; with dropout in training, the plain
  einsum path with dropout on the probabilities (no kernel).

Each module's ``backend`` (None: by device, or "torch") reaches every kernel
it runs: the CIN contraction, the attention and the fused block.  Parameter
names follow the JAX paths (``mhsa/W_q/kernel`` is ``mhsa.W_q.weight``,
``layer_norm/scale``, ``attn_pooling/fc1``, ``output_proj``; V2 ``mhsa_{i}``
and ``ln_{i}``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..dispatch import Switch
from ..ops import attn_block as abp
from ..ops.attention import mhsa_attention_packed, mhsa_attention_packed_t
from .activations import make_activation
from .core import dropout
from .interaction import cin_feature_maps_t, cin_featuremap_num, make_cin_params


def glorot_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``glorot_uniform`` on an ``nn.Linear`` weight [out, in]."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


class DenseT(nn.Linear):
    """``nn.Linear`` (weight [out, in], the flax kernel's transpose, so its
    canonical path is ``.../kernel``) whose default call contracts the
    channel axis of a transposed [B, E, S] tensor (``cin_attention.py:33``);
    :meth:`last_axis` is the classic last-axis contraction."""

    def __init__(self, features: int, in_features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, bias=use_bias)
        glorot_uniform_(self.weight, generator)
        if use_bias:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x_t):
        y = torch.einsum("bes,fe->bfs", x_t, self.weight)
        if self.bias is not None:
            y = y + self.bias[None, :, None]
        return y

    def last_axis(self, x):
        return nn.functional.linear(x, self.weight, self.bias)


class LayerNormT(nn.Module):
    """LayerNorm over the E axis of a transposed [B, E, S] tensor, with the
    JAX parameter names ``scale`` and ``bias`` and its numerics: the fast
    variance E[x^2] - mu^2, eps 1e-5 (``cin_attention.py:67-88``)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mu = x.mean(-2, keepdim=True)
        var = (x * x).mean(-2, keepdim=True) - mu * mu
        y = (x - mu) * torch.rsqrt(var + self.epsilon)
        return y * self.scale[None, :, None] + self.bias[None, :, None]


def get_valid_num_heads(embed_dim: int, num_heads: int) -> int:
    """Shrink the head count until it divides embed_dim
    (``cin_attention.py:91-99``)."""
    if embed_dim % num_heads == 0:
        return num_heads
    for h in range(num_heads, 0, -1):
        if embed_dim % h == 0:
            return h
    return 1


class MultiHeadSelfAttention(nn.Module):
    """MHSA over the feature-map axis (``cin_attention.py:102-171``):
    [B, S, E] -> [B, S, E], or [B, E, S] when ``transposed``."""

    def __init__(self, embed_dim: int, num_heads: int = 4, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.W_q = DenseT(embed_dim, embed_dim, use_bias=False, generator=generator)
        self.W_k = DenseT(embed_dim, embed_dim, use_bias=False, generator=generator)
        self.W_v = DenseT(embed_dim, embed_dim, use_bias=False, generator=generator)
        self.W_o = DenseT(embed_dim, embed_dim, use_bias=False, generator=generator)

    def forward(self, x, training: bool = False, transposed: bool = False, generator=None,
                backend=None):
        """``generator`` draws the dropout mask when training with dropout;
        ``backend`` goes to ``small_attention``."""
        heads = get_valid_num_heads(self.embed_dim, self.num_heads)
        dh = self.embed_dim // heads
        scale = math.sqrt(dh)
        if transposed:
            B, E, S = x.shape
            Q, K, V = self.W_q(x), self.W_k(x), self.W_v(x)
        else:
            B, S, E = x.shape
            Q, K, V = self.W_q.last_axis(x), self.W_k.last_axis(x), self.W_v.last_axis(x)
        if self.dropout == 0.0 or not training:
            fn = mhsa_attention_packed_t if transposed else mhsa_attention_packed
            out = fn(Q, K, V, 1.0 / scale, heads, kernel_backend=backend)
        elif transposed:
            Qr, Kr, Vr = (t.reshape(B, heads, dh, S) for t in (Q, K, V))
            probs = torch.softmax(torch.einsum("bhds,bhdt->bhst", Qr, Kr) / scale, dim=-1)
            probs = dropout(probs, self.dropout, generator)
            out = torch.einsum("bhst,bhdt->bhds", probs, Vr).reshape(B, E, S)
        else:
            Qr, Kr, Vr = (t.reshape(B, S, heads, dh) for t in (Q, K, V))
            probs = torch.softmax(torch.einsum("bshd,bthd->bhst", Qr, Kr) / scale, dim=-1)
            probs = dropout(probs, self.dropout, generator)
            out = torch.einsum("bhst,bthd->bshd", probs, Vr).reshape(B, S, E)
        return self.W_o(out) if transposed else self.W_o.last_axis(out)


class AttentionPooling(nn.Module):
    """tanh-MLP scores -> softmax over the sequence -> weighted sum
    (``cin_attention.py:174-202``): [B, S, E], or [B, E, S] when
    ``transposed``, -> [B, E]."""

    def __init__(self, embed_dim: int, hidden_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = hidden_dim or embed_dim
        self.fc1 = DenseT(hidden, embed_dim, generator=generator)
        self.fc2 = DenseT(1, hidden, use_bias=False, generator=generator)

    def pooling_params(self):
        """(w1 [E, hidden], b1 [hidden], w2 [hidden, 1]) in the JAX layout,
        for the fused block."""
        return self.fc1.weight.t(), self.fc1.bias, self.fc2.weight.t()

    def forward(self, x, transposed: bool = False):
        if transposed:
            h = torch.tanh(self.fc1(x))
            weights = torch.softmax(self.fc2(h), dim=-1)  # [B, 1, S]
            return torch.einsum("bos,bes->be", weights, x)
        h = torch.tanh(self.fc1.last_axis(x))
        weights = torch.softmax(self.fc2.last_axis(h), dim=1)  # [B, S, 1]
        return (weights * x).sum(1)


def _fused_block_apply(x_t, mhsas, layer_norms, pooling, num_heads, use_residual,
                       use_layer_norm, backend=None):
    """The fused block over the transposed CIN output (``cin_attention.py:205``);
    ``mhsas`` / ``layer_norms``: per-layer module lists.  Returns pooled
    [B, E], or None when the fused route is off (``set_backend("xla")``)."""
    B, E, S = x_t.shape
    if not abp.use_fused_block(seq_len=S):
        return None
    heads = get_valid_num_heads(E, num_heads)
    dh = E // heads
    wq = torch.cat([abp.pack_projection(m.W_q.weight, heads) for m in mhsas])  # [L*H, E, dh]
    wk = torch.cat([abp.pack_projection(m.W_k.weight, heads) for m in mhsas])
    wv = torch.cat([abp.pack_projection(m.W_v.weight, heads) for m in mhsas])
    wo = torch.cat([abp.pack_out_projection(m.W_o.weight, heads) for m in mhsas])  # [L*H, dh, E]
    L = len(mhsas)
    if use_layer_norm:
        gamma = torch.stack([ln.scale for ln in layer_norms])[:, :, None]
        beta = torch.stack([ln.bias for ln in layer_norms])[:, :, None]
    else:
        gamma = x_t.new_ones((L, E, 1))
        beta = x_t.new_zeros((L, E, 1))
    w1, b1, w2 = pooling.pooling_params()
    cfg = abp.BlockCfg(layers=L, heads=heads, scale=1.0 / math.sqrt(dh),
                       use_residual=use_residual, use_layer_norm=use_layer_norm, eps=1e-5)
    return abp.attn_block(cfg, x_t, wq, wk, wv, wo, gamma, beta, w1, b1[:, None], w2,
                          backend=backend)


class _CINAttentionBase(nn.Module):
    backend = Switch()

    def __init__(self, field_size, embedding_size, layer_size, activation, split_half,
                 num_heads, attn_dropout, use_layer_norm, use_residual, generator, backend):
        super().__init__()
        if len(layer_size) == 0:
            raise ValueError("layer_size must be a list(tuple) of length greater than 1")
        self.embedding_size = embedding_size
        self.layer_size = tuple(layer_size)
        self.split_half = split_half
        self.num_heads = num_heads
        self.attn_dropout = attn_dropout
        self.use_layer_norm = use_layer_norm
        self.use_residual = use_residual
        self.backend = backend
        make_cin_params(self, field_size, self.layer_size, split_half, generator)
        self.act = make_activation(activation)
        self.featuremap_num = cin_featuremap_num(self.layer_size, split_half)

    def _feature_maps(self, inputs, training):
        n = len(self.layer_size)
        return cin_feature_maps_t(
            inputs,
            [getattr(self, f"conv_w_{i}") for i in range(n)],
            [getattr(self, f"conv_b_{i}") for i in range(n)],
            self.act, self.layer_size, self.split_half,
            training=training, backend=self.backend,
        )  # [B, E, featuremap_num]

    def _fuse(self, result, mhsas, layer_norms):
        return _fused_block_apply(result, mhsas, layer_norms if self.use_layer_norm else [],
                                  self.attn_pooling, self.num_heads, self.use_residual,
                                  self.use_layer_norm, self.backend)

    def _unfused_layer(self, x, mhsa, layer_norm, training, generator):
        out = mhsa(x, training=training, transposed=True, generator=generator,
                   backend=self.backend)
        if self.use_residual:
            out = out + x
        if self.use_layer_norm:
            out = layer_norm(out)
        return out


class CINAttention(_CINAttentionBase):
    """CIN cross layers + MHSA + residual + LayerNorm + attention pooling +
    projection back to featuremap_num (``cin_attention.py:252-332``):
    [B, M, E] -> [B, featuremap_num]."""

    def __init__(self, field_size: int, embedding_size: int,
                 layer_size: Sequence[int] = (128, 128), activation: str = "relu",
                 split_half: bool = True, num_heads: int = 4, attn_dropout: float = 0.0,
                 use_layer_norm: bool = True, use_residual: bool = True, l2_reg: float = 1e-5,
                 seed: int = 1024, generator: Optional[torch.Generator] = None,
                 backend: Optional[str] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        super().__init__(field_size, embedding_size, layer_size, activation, split_half,
                         num_heads, attn_dropout, use_layer_norm, use_residual, generator,
                         backend)
        self.mhsa = MultiHeadSelfAttention(embedding_size, num_heads, attn_dropout, generator)
        if use_layer_norm:
            self.layer_norm = LayerNormT(embedding_size)
        self.attn_pooling = AttentionPooling(embedding_size, embedding_size, generator)
        self.output_proj = nn.Linear(embedding_size, self.featuremap_num, bias=False)
        glorot_uniform_(self.output_proj.weight, generator)

    def forward(self, inputs, training: bool = False, generator=None):
        result = self._feature_maps(inputs, training)
        pooled = None
        if self.attn_dropout == 0.0 or not training:
            pooled = self._fuse(result, [self.mhsa], [getattr(self, "layer_norm", None)])
        if pooled is None:
            out = self._unfused_layer(result, self.mhsa, getattr(self, "layer_norm", None),
                                      training, generator)
            pooled = self.attn_pooling(out, transposed=True)  # [B, E]
        return self.output_proj(pooled)  # [B, featuremap_num]


class CINAttentionV2(_CINAttentionBase):
    """V2: ``num_attn_layers`` stacked MHSA (+ LayerNorm) blocks and no
    output projection (``cin_attention.py:335-418``): [B, M, E] -> [B, E]."""

    def __init__(self, field_size: int, embedding_size: int,
                 layer_size: Sequence[int] = (128, 128), activation: str = "relu",
                 split_half: bool = True, num_heads: int = 4, attn_dropout: float = 0.0,
                 use_layer_norm: bool = True, use_residual: bool = True,
                 num_attn_layers: int = 1, l2_reg: float = 1e-5, seed: int = 1024,
                 generator: Optional[torch.Generator] = None, backend: Optional[str] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        super().__init__(field_size, embedding_size, layer_size, activation, split_half,
                         num_heads, attn_dropout, use_layer_norm, use_residual, generator,
                         backend)
        self.num_attn_layers = num_attn_layers
        # registered as mhsa_{i} / ln_{i}, the JAX module names
        for i in range(num_attn_layers):
            self.add_module(f"mhsa_{i}", MultiHeadSelfAttention(
                embedding_size, num_heads, attn_dropout, generator))
        if use_layer_norm:
            for i in range(num_attn_layers):
                self.add_module(f"ln_{i}", LayerNormT(embedding_size))
        self.attn_pooling = AttentionPooling(embedding_size, embedding_size, generator)

    def forward(self, inputs, training: bool = False, generator=None):
        result = self._feature_maps(inputs, training)
        n = self.num_attn_layers
        mhsas = [getattr(self, f"mhsa_{i}") for i in range(n)]
        lns = [getattr(self, f"ln_{i}", None) for i in range(n)]
        # the fused block only for a single layer (cin_attention.py:392-408)
        if n == 1 and (self.attn_dropout == 0.0 or not training):
            pooled = self._fuse(result, mhsas, lns)
            if pooled is not None:
                return pooled
        for mhsa, ln in zip(mhsas, lns):
            result = self._unfused_layer(result, mhsa, ln, training, generator)
        return self.attn_pooling(result, transposed=True)  # [B, E]
