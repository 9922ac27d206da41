"""ONN / NFFM (port of ``xdeepfm_tpu/models/onn.py``; reference
``deepctr/models/onn.py:37-158``).

The linear term plus a DNN over the field-aware second-order products: pair
(i, j) of the sparse fields multiplies its own embedding of feature i's id
by its own embedding of feature j's id, then the dense values follow.  The
pair tables are grouped by feature as in the JAX package: feature k's
``second_order_emb1_f{k}`` [vocab_k, (F - 1 - k) * E] holds its side of
the pairs (k, j > k), ``second_order_emb2_f{k}`` [vocab_k, k * E] its side
of (i < k, k); the first feature has no emb2, the last no emb1.  Both are
drawn normal(init_std), as the JAX package does (``onn.py:64``).  Each
feature's two tables share its ids, so one :func:`~xdeepfm_tpu_torch.
embeddings.fused_gather` fetches both (a fixed-order backward).  The
second sides come in (j, i) order and are put in pair order by a static
permutation whose backward is the inverse permutation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..basemodel import BaseModel
from ..embeddings import LinearModel, _device_list, fused_gather
from ..features import DenseFeat, FeatureSchema, SparseFeat
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import _pair_indices


class _PermutePairs(torch.autograd.Function):
    """``x[:, perm]`` on the pair axis of [B, P, E] for a permutation
    ``perm``; the backward takes ``g[:, inverse]``: a copy each way, no
    scatter-add."""

    @staticmethod
    def forward(ctx, x, perm, inverse):
        ctx.inverse = inverse
        return x.index_select(1, perm)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return g.index_select(1, ctx.inverse), None, None


class ONNModule(nn.Module):
    """Parameters follow the JAX paths: ``linear_model``,
    ``second_order_emb1_f{k}`` and ``second_order_emb2_f{k}`` at the root,
    ``dnn``, ``dnn_linear``, ``out``.  There is no ``embedding_dict``: the
    JAX module declares one and never reads it, so flax makes none."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        embedding_size: int,
        dnn_hidden_units: Sequence[int] = (128, 128),
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        dnn_use_bn: bool = False,
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.schema = schema
        self.embedding_size = E = embedding_size
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        self._sp = [f for f in self.dnn_cols if isinstance(f, SparseFeat)]
        F_ = len(self._sp)
        for k, f in enumerate(self._sp):
            for side, n in (("emb1", F_ - 1 - k), ("emb2", k)):
                if n:
                    t = torch.empty(f.vocabulary_size, n * E).normal_(0.0, init_std,
                                                                      generator=gen)
                    self.register_parameter(f"second_order_{side}_f{k}", nn.Parameter(t))
        # the second sides arrive sorted by (j, i); pair p of the first-major
        # order sits at place perm[p] of that order (``onn.py:84-93``)
        row, col = _pair_indices(F_)
        second_major = sorted(range(len(row)), key=lambda p: (col[p], row[p]))
        inverse = np.asarray(second_major, dtype=np.int64)
        perm = np.empty_like(inverse)
        perm[inverse] = np.arange(len(row))
        self._perm, self._inverse = perm.tolist(), inverse.tolist()
        self.n_pairs = len(row)
        dense_dim = sum(f.dimension for f in self.dnn_cols if isinstance(f, DenseFeat))
        self.dnn = DNN(
            self.n_pairs * E + dense_dim, dnn_hidden_units, activation=dnn_activation,
            dropout_rate=dnn_dropout, use_bn=dnn_use_bn, init_std=init_std, generator=gen,
        )
        self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
        torch_linear_init(self.dnn_linear.weight, gen)
        self.out = PredictionLayer(task=task)

    def second_order(self, batch) -> torch.Tensor:
        """[B, P * E]: each pair's two embeddings multiplied, pairs in
        first-major order, (p, e) flattened."""
        B, E = batch["sparse"].shape[0], self.embedding_size
        parts1, parts2 = [], []
        for k, f in enumerate(self._sp):
            tables = [getattr(self, f"second_order_{side}_f{k}") for side in ("emb1", "emb2")
                      if hasattr(self, f"second_order_{side}_f{k}")]
            if not tables:  # a single sparse feature has no pairs
                continue
            ids = batch["sparse"][:, self.schema.sparse_index(f.name)]
            rows = fused_gather(tables, ids)
            n1 = (len(self._sp) - 1 - k) * E
            parts1.append(rows[:, :n1])
            parts2.append(rows[:, n1:])
        if not self.n_pairs:
            return batch["sparse"].new_zeros((B, 0), dtype=torch.float32)
        emb1 = torch.cat(parts1, dim=1).reshape(B, self.n_pairs, E)
        emb2 = torch.cat(parts2, dim=1).reshape(B, self.n_pairs, E)
        dev = emb2.device
        emb2 = _PermutePairs.apply(emb2, _device_list(self._perm, dev),
                                   _device_list(self._inverse, dev))
        return (emb1 * emb2).reshape(B, -1)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the DNN's dropout masks when ``training``."""
        linear_logit = self.linear_model(batch)
        parts = [self.second_order(batch)]
        de = [f for f in self.dnn_cols if isinstance(f, DenseFeat)]
        if de:
            parts += [batch["dense"][:, slice(*self.schema.dense_slice(f.name))] for f in de]
        dnn_out = self.dnn(torch.cat(parts, dim=-1), training=training, generator=generator)
        dnn_logit = self.dnn_linear(dnn_out)
        final_logit = dnn_logit + linear_logit if len(self.dnn_cols) > 0 else linear_logit
        return {"pred": self.out(final_logit)}


class ONN(BaseModel):
    """Drop-in equivalent of the reference ONN class
    (``deepctr/models/onn.py:37-158``).  ``device=None`` means "cuda".  The
    pair tables take ``l2_reg_embedding`` (``onn.py:73``)."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns,
        dnn_hidden_units=(128, 128), l2_reg_embedding=1e-5, l2_reg_linear=1e-5,
        l2_reg_dnn=0, dnn_dropout=0, init_std=0.0001, seed=1024,
        dnn_use_bn=False, dnn_activation="relu", task="binary", device=None,
        gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.add_regularization_weight(("second_order_emb",), l2=l2_reg_embedding)
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return ONNModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self.embedding_size,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
