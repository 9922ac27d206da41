"""Wide & Deep (port of ``xdeepfm_tpu/models/wdl.py``; reference
``deepctr/models/wdl.py:16-75``).

The linear (wide) term plus a DNN over ``fast_inputs``: one stacked lookup
when every embedding dim is equal, else each feature's own (mixed dims).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import (
    EmbeddingCollection,
    LinearModel,
    can_fuse_lookup,
    combined_dnn_input,
    lookup_fast_inputs,
)
from ..features import FeatureSchema, compute_input_dim, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init


class WDLModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``dnn``, ``dnn_linear``, ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        dnn_hidden_units: Sequence[int] = (256, 128),
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
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        self.use_dnn = len(self.dnn_cols) > 0 and len(dnn_hidden_units) > 0
        if self.use_dnn:
            self.dnn = DNN(
                compute_input_dim(self.dnn_cols), dnn_hidden_units, activation=dnn_activation,
                dropout_rate=dnn_dropout, use_bn=dnn_use_bn, init_std=init_std, generator=gen,
            )
            self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
            torch_linear_init(self.dnn_linear.weight, gen)
        self.out = PredictionLayer(task=task)
        sp = split_columns(self.dnn_cols)[0]
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the DNN's dropout masks when ``training``."""
        sparse_list, dense_list, lin_rows = lookup_fast_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        logit = self.linear_model(batch, sparse_rows=lin_rows)
        if self.use_dnn:
            dnn_out = self.dnn(combined_dnn_input(sparse_list, dense_list), training=training,
                               generator=generator)
            logit = logit + self.dnn_linear(dnn_out)
        return {"pred": self.out(logit)}


class WDL(BaseModel):
    """Drop-in equivalent of the reference WDL class
    (``deepctr/models/wdl.py:16-75``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns,
        dnn_hidden_units=(256, 128), l2_reg_linear=1e-5, l2_reg_embedding=1e-5,
        l2_reg_dnn=0, init_std=0.0001, seed=1024, dnn_dropout=0,
        dnn_activation="relu", dnn_use_bn=False, task="binary", device=None,
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
        if len(dnn_feature_columns) > 0 and len(self.dnn_hidden_units) > 0:
            self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
            self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return WDLModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
