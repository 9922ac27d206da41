"""AutoDis — learned soft discretization of dense features (port of
``xdeepfm_tpu/pro/autodis.py``; reference ``deepctr/xdeepfm_pro/autodis.py``).

All features run batched through parameters stacked per feature, one einsum
per stage, with the JAX package's names and shapes: ``proj_w1`` [F, 1, K],
``proj_b1`` [F, K], ``proj_w2`` [F, K, K], ``proj_b2`` [F, K],
``meta_embeddings`` [F, K, E], ``feature_temperatures`` [F].  The projections
keep the JAX [in, out] layout (they are not ``nn.Linear`` weights).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, fan_in, generator):
    """torch's Linear init U(±1/sqrt(fan_in)) (``nn/core.torch_linear_init``)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class AutoDisLayer(nn.Module):
    """Per dense feature: MLP(1 -> buckets -> buckets, LeakyReLU 0.2) ->
    softmax(scores / learned temperature) -> weighted sum of meta-embeddings
    (reference ``autodis.py:20-127``).

    Input dense values [B, F]; output ([B, F*E], [B, F, E]).
    """

    def __init__(self, num_features: int, num_buckets: int = 16, embedding_dim: int = 8,
                 temperature: float = 1.0, keep_raw: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_features = num_features
        self.num_buckets = num_buckets
        self.embedding_dim = embedding_dim
        self.keep_raw = keep_raw
        F_, K, E = num_features, num_buckets, embedding_dim
        if F_ == 0:
            return
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.meta_embeddings = nn.Parameter(
            torch.empty(F_, K, E).normal_(0.0, 0.01, generator=gen)
        )
        self.proj_w1 = nn.Parameter(_uniform((F_, 1, K), 1, gen))
        self.proj_b1 = nn.Parameter(_uniform((F_, K), 1, gen))
        self.proj_w2 = nn.Parameter(_uniform((F_, K, K), K, gen))
        self.proj_b2 = nn.Parameter(_uniform((F_, K), K, gen))
        self.feature_temperatures = nn.Parameter(torch.full((F_,), float(temperature)))

    def _scores(self, dense_values):
        h = dense_values[:, :, None] * self.proj_w1[None, :, 0, :] + self.proj_b1[None]
        h = F.leaky_relu(h, negative_slope=0.2)
        return torch.einsum("bfk,fkj->bfj", h, self.proj_w2) + self.proj_b2[None]

    def forward(self, dense_values) -> Tuple[torch.Tensor, torch.Tensor]:
        B = dense_values.shape[0]
        if self.num_features == 0:
            z = dense_values.new_zeros((B, 0))
            return z, dense_values.new_zeros((B, 0, self.embedding_dim))
        scores = self._scores(dense_values)
        weights = torch.softmax(scores / self.feature_temperatures[None, :, None], dim=-1)
        emb = torch.einsum("bfk,fke->bfe", weights, self.meta_embeddings)  # [B, F, E]
        return emb.reshape(B, -1), emb

    def bucket_indices(self, dense_values):
        """Dominant bucket per feature, [B, F] (reference ``autodis.py:129-149``)."""
        return torch.argmax(self._scores(dense_values), dim=-1)


class DenseFeatureEncoder(nn.Module):
    """AutoDis or passthrough (reference ``autodis.py:152-238``)."""

    def __init__(self, num_features: int, embedding_dim: int = 8, use_autodis: bool = True,
                 num_buckets: int = 16, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_features = num_features
        self.embedding_dim = embedding_dim
        self.use_autodis = use_autodis
        if use_autodis and num_features > 0:
            self.autodis = AutoDisLayer(num_features, num_buckets, embedding_dim, temperature,
                                        generator=generator)

    def forward(self, dense_values):
        """(encoded [B, ...], embeddings [B, F, E], the raw dense values)."""
        B = dense_values.shape[0]
        if self.num_features == 0:
            z = dense_values.new_zeros((B, 0))
            return z, dense_values.new_zeros((B, 0, self.embedding_dim)), z
        if self.use_autodis:
            flat, emb = self.autodis(dense_values)
            return flat, emb, dense_values
        return dense_values, dense_values[:, :, None], dense_values

    def get_output_dim(self) -> int:
        if self.use_autodis:
            return self.num_features * self.embedding_dim
        return self.num_features
