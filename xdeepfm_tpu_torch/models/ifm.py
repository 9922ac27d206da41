"""IFM (port of ``xdeepfm_tpu/models/ifm.py``; reference
``deepctr/models/ifm.py:16-87``).

A factor-estimating DNN over the sparse embeddings gives each field an
input-aware factor (a softmax scaled by the field count), which refines the
linear term's per-field logits and the FM's inputs.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import FeatureSchema, SparseFeat, VarLenSparseFeat, compute_input_dim, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import FM


class IFMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``factor_estimating_net``, ``transform_weight_matrix_P``, ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        sparse_feat_num: int,
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
        self.sparse_feat_num = sparse_feat_num
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        # the stacked lookup's dim check, which the JAX model's first forward
        # runs at its construction
        self.embedding_dict.uniform_dim()
        self.fm = FM()
        self.factor_estimating_net = DNN(
            compute_input_dim(self.dnn_cols, include_dense=False), dnn_hidden_units,
            activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
            init_std=init_std, generator=gen,
        )
        self.transform_weight_matrix_P = nn.Linear(dnn_hidden_units[-1], sparse_feat_num,
                                                   bias=False)
        torch_linear_init(self.transform_weight_matrix_P.weight, gen)
        self.out = PredictionLayer(task=task)
        sp = split_columns(self.dnn_cols)[0]
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the DNN's dropout masks when ``training``."""
        sparse_stack, _, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        if sparse_stack is None:
            raise ValueError("there are no sparse features")
        dnn_output = self.factor_estimating_net(
            sparse_stack.reshape(sparse_stack.shape[0], -1), training=training,
            generator=generator)
        factor = self.sparse_feat_num * torch.softmax(
            self.transform_weight_matrix_P(dnn_output), dim=1)
        logit = self.linear_model(batch, sparse_rows=lin_rows, sparse_feat_refine_weight=factor)
        logit = logit + self.fm(sparse_stack * factor[:, :, None])
        return {"pred": self.out(logit)}


class IFM(BaseModel):
    """Drop-in equivalent of the reference IFM class
    (``deepctr/models/ifm.py:16-87``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns,
        dnn_hidden_units=(256, 128), l2_reg_linear=0.00001,
        l2_reg_embedding=0.00001, l2_reg_dnn=0, init_std=0.0001, seed=1024,
        dnn_dropout=0, dnn_activation="relu", dnn_use_bn=False, task="binary",
        device=None, gpus=None,
    ):
        if not len(dnn_hidden_units) > 0:
            raise ValueError("dnn_hidden_units is null!")
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.add_regularization_weight(("factor_estimating_net/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("transform_weight_matrix_P/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        sparse_feat_num = len(
            [f for f in self.dnn_feature_columns if isinstance(f, (SparseFeat, VarLenSparseFeat))]
        )
        return IFMModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            sparse_feat_num=sparse_feat_num,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
