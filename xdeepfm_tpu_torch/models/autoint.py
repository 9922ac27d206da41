"""AutoInt (port of ``xdeepfm_tpu/models/autoint.py``; reference
``deepctr/models/autoint.py:16-106``).

linear + stacked ``InteractingLayer``s over the field embeddings + DNN, the
attention output and the DNN output concatenated into ``dnn_linear``
(``autoint.py:66-88``); either tower may be absent.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import FeatureSchema, compute_input_dim, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import InteractingLayer


class AutoIntModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``dnn``, ``int_layer_{i}`` (``W_Query``, ``W_Key``, ``W_Value``,
    ``W_Res``), ``dnn_linear``, ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        embedding_size: int,
        att_layer_num: int = 3,
        att_head_num: int = 2,
        att_res: bool = True,
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
        sp = split_columns(self.dnn_cols)[0]
        self.att_layer_num = att_layer_num
        self.use_dnn = len(self.dnn_cols) > 0 and len(dnn_hidden_units) > 0
        if self.use_dnn:
            self.dnn = DNN(
                compute_input_dim(self.dnn_cols), dnn_hidden_units, activation=dnn_activation,
                dropout_rate=dnn_dropout, use_bn=dnn_use_bn, init_std=init_std, generator=gen,
            )
        for i in range(att_layer_num):
            self.add_module(f"int_layer_{i}", InteractingLayer(
                embedding_size, head_num=att_head_num, use_res=att_res, generator=gen))
        # dnn_linear reads the flattened attention output, the DNN output or
        # their concat (autoint.py:79-87)
        width = (len(sp) * embedding_size if att_layer_num > 0 else 0) + (
            dnn_hidden_units[-1] if self.use_dnn else 0)
        self.dnn_linear = nn.Linear(width, 1, bias=False)
        torch_linear_init(self.dnn_linear.weight, gen)
        self.out = PredictionLayer(task=task)
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def int_layers(self):
        return [getattr(self, f"int_layer_{i}") for i in range(self.att_layer_num)]

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors (``sparse`` int [B, F], ``dense`` f32).
        Returns ``{"pred": [B, 1]}``.  ``generator`` draws the DNN's dropout
        masks when ``training``."""
        sparse_stack, dense_vals, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        logit = self.linear_model(batch, sparse_rows=lin_rows)
        att = sparse_stack
        for layer in self.int_layers():
            att = layer(att, training=training)
        att_output = att.reshape(att.shape[0], -1)
        parts = [sparse_stack.reshape(sparse_stack.shape[0], -1)]
        if dense_vals is not None:
            parts.append(dense_vals)
        towers = []
        if self.att_layer_num > 0:
            towers.append(att_output)
        if self.use_dnn:
            towers.append(self.dnn(torch.cat(parts, dim=-1), training=training,
                                   generator=generator))
        logit = logit + self.dnn_linear(torch.cat(towers, dim=-1))
        return {"pred": self.out(logit)}


class AutoInt(BaseModel):
    """Drop-in equivalent of the reference AutoInt class
    (``deepctr/models/autoint.py:16-106``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns, att_layer_num=3,
        att_head_num=2, att_res=True, dnn_hidden_units=(256, 128),
        dnn_activation="relu", l2_reg_dnn=0, l2_reg_embedding=1e-5,
        dnn_use_bn=False, dnn_dropout=0, init_std=0.0001, seed=1024,
        task="binary", device=None, gpus=None,
    ):
        # the reference passes l2_reg_linear=0 (autoint.py:44)
        super().__init__(
            linear_feature_columns, dnn_feature_columns, l2_reg_linear=0,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed,
            task=task, device=device, gpus=gpus,
        )
        if len(dnn_hidden_units) <= 0 and att_layer_num <= 0:
            raise ValueError("Either hidden_layer or att_layer_num must > 0")
        self.att_layer_num = att_layer_num
        self.att_head_num = att_head_num
        self.att_res = att_res
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        if len(dnn_feature_columns) > 0 and len(self.dnn_hidden_units) > 0:
            self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return AutoIntModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self.embedding_size,
            att_layer_num=self.att_layer_num,
            att_head_num=self.att_head_num,
            att_res=self.att_res,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
