"""NFM (port of ``xdeepfm_tpu/models/nfm.py``; reference
``deepctr/models/nfm.py:16-78``).

The linear term plus a DNN over the bi-interaction pooling of the sparse
embeddings (dropped out by ``bi_dropout``) and the dense values.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import FeatureSchema, compute_input_dim, split_columns
from ..nn.core import DNN, PredictionLayer, dropout, torch_linear_init
from ..nn.interaction import BiInteractionPooling


class NFMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``dnn``, ``dnn_linear``, ``out`` (``bi_pooling`` has none)."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        embedding_size: int,
        dnn_hidden_units: Sequence[int] = (128, 128),
        bi_dropout: float = 0.0,
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.bi_dropout = bi_dropout
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        self.dnn = DNN(
            compute_input_dim(self.dnn_cols, include_sparse=False) + embedding_size,
            dnn_hidden_units, activation=dnn_activation, dropout_rate=dnn_dropout,
            init_std=init_std, generator=gen,
        )
        self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
        torch_linear_init(self.dnn_linear.weight, gen)
        self.bi_pooling = BiInteractionPooling()
        self.out = PredictionLayer(task=task)
        sp = split_columns(self.dnn_cols)[0]
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the dropout masks when ``training``."""
        sparse_stack, dense_vals, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        logit = self.linear_model(batch, sparse_rows=lin_rows)
        bi_out = self.bi_pooling(sparse_stack)
        if training:
            bi_out = dropout(bi_out, self.bi_dropout, generator)
        parts = [bi_out.reshape(bi_out.shape[0], -1)]
        if dense_vals is not None:
            parts.append(dense_vals)
        dnn_out = self.dnn(torch.cat(parts, dim=-1), training=training, generator=generator)
        return {"pred": self.out(logit + self.dnn_linear(dnn_out))}


class NFM(BaseModel):
    """Drop-in equivalent of the reference NFM class
    (``deepctr/models/nfm.py:16-78``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns,
        dnn_hidden_units=(128, 128), l2_reg_embedding=1e-5, l2_reg_linear=1e-5,
        l2_reg_dnn=0, init_std=0.0001, seed=1024, bi_dropout=0, dnn_dropout=0,
        dnn_activation="relu", task="binary", device=None, gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.bi_dropout = bi_dropout
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return NFMModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self.embedding_size,
            dnn_hidden_units=self.dnn_hidden_units,
            bi_dropout=self.bi_dropout,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
