"""AFN (port of ``xdeepfm_tpu/models/afn.py``; reference
``deepctr/models/afn.py:17-74``).

The linear term plus a BatchNorm DNN over the logarithmic transformation
layer of the stacked sparse embeddings; dense features reach only the linear
logit.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import FeatureSchema, split_columns
from ..nn.core import DNN, PredictionLayer, torch_bias_init, torch_linear_init
from ..nn.interaction import LogTransformLayer


class AFNModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``ltl``, ``afn_dnn`` (BatchNorm always on), ``afn_dnn_linear`` (with a
    bias, as ``afn.py:56``), ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        embedding_size: int,
        field_num: int,
        ltl_hidden_size: int = 256,
        afn_dnn_hidden_units: Sequence[int] = (256, 128),
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
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
        self.ltl = LogTransformLayer(field_num, embedding_size, ltl_hidden_size, generator=gen)
        self.afn_dnn = DNN(
            embedding_size * ltl_hidden_size, afn_dnn_hidden_units, activation=dnn_activation,
            dropout_rate=dnn_dropout, use_bn=True, init_std=init_std, generator=gen,
        )
        self.afn_dnn_linear = nn.Linear(afn_dnn_hidden_units[-1], 1)
        torch_linear_init(self.afn_dnn_linear.weight, gen)
        torch_bias_init(self.afn_dnn_linear.bias, afn_dnn_hidden_units[-1], gen)
        self.out = PredictionLayer(task=task)
        sp = split_columns(self.dnn_cols)[0]
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the DNN's dropout masks when ``training``, when
        the BatchNorm statistics also update."""
        sparse_stack, _, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        logit = self.linear_model(batch, sparse_rows=lin_rows)
        if sparse_stack is None:
            raise ValueError(
                "Sparse embeddings not provided. AFN only accepts sparse embeddings as input."
            )
        afn_out = self.afn_dnn(self.ltl(sparse_stack, training=training), training=training,
                               generator=generator)
        return {"pred": self.out(logit + self.afn_dnn_linear(afn_out))}


class AFN(BaseModel):
    """Drop-in equivalent of the reference AFN class
    (``deepctr/models/afn.py:17-74``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns, ltl_hidden_size=256,
        afn_dnn_hidden_units=(256, 128), l2_reg_linear=0.00001,
        l2_reg_embedding=0.00001, l2_reg_dnn=0, init_std=0.0001, seed=1024,
        dnn_dropout=0, dnn_activation="relu", task="binary", device=None,
        gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.ltl_hidden_size = ltl_hidden_size
        self.afn_dnn_hidden_units = tuple(afn_dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self._finalize()

    def _build_module(self):
        sp, _, vl = split_columns(self.dnn_feature_columns)
        return AFNModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self.embedding_size,
            field_num=len(sp) + len(vl),
            ltl_hidden_size=self.ltl_hidden_size,
            afn_dnn_hidden_units=self.afn_dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
