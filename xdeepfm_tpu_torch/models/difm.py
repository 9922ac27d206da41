"""DIFM (port of ``xdeepfm_tpu/models/difm.py``; reference
``deepctr/models/difm.py:16-106``).

A vector-wise ``InteractingLayer`` (scaled) and a bit-wise DNN over the
sparse embeddings give per-field weights m_x = P_vec(att) + P_bit(dnn),
which refine the linear term's per-field logits and the FM's inputs
(``difm.py:67-83``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import FeatureSchema, SparseFeat, VarLenSparseFeat, compute_input_dim, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import FM, InteractingLayer


class DIFMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``vector_wise_net`` (``W_*``), ``bit_wise_net``,
    ``transform_matrix_P_vec``, ``transform_matrix_P_bit``, ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        embedding_size: int,
        sparse_feat_num: int,
        att_head_num: int = 4,
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
        self.fm = FM()
        self.vector_wise_net = InteractingLayer(
            embedding_size, head_num=att_head_num, use_res=att_res, scaling=True, generator=gen)
        self.bit_wise_net = DNN(
            compute_input_dim(self.dnn_cols, include_dense=False), dnn_hidden_units,
            activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
            init_std=init_std, generator=gen,
        )
        sp = split_columns(self.dnn_cols)[0]
        self.transform_matrix_P_vec = nn.Linear(len(sp) * embedding_size, sparse_feat_num,
                                                bias=False)
        self.transform_matrix_P_bit = nn.Linear(dnn_hidden_units[-1], sparse_feat_num, bias=False)
        for lin in (self.transform_matrix_P_vec, self.transform_matrix_P_bit):
            torch_linear_init(lin.weight, gen)
        self.out = PredictionLayer(task=task)
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors (``sparse`` int [B, F], ``dense`` f32).
        Returns ``{"pred": [B, 1]}``.  ``generator`` draws the bit-wise DNN's
        dropout masks when ``training``."""
        sparse_stack, _, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        if sparse_stack is None:
            raise ValueError("there are no sparse features")
        att_out = self.vector_wise_net(sparse_stack, training=training)
        m_vec = self.transform_matrix_P_vec(att_out.reshape(att_out.shape[0], -1))
        dnn_output = self.bit_wise_net(sparse_stack.reshape(sparse_stack.shape[0], -1),
                                       training=training, generator=generator)
        m_x = m_vec + self.transform_matrix_P_bit(dnn_output)
        logit = self.linear_model(batch, sparse_rows=lin_rows, sparse_feat_refine_weight=m_x)
        logit = logit + self.fm(sparse_stack * m_x[:, :, None])
        return {"pred": self.out(logit)}


class DIFM(BaseModel):
    """Drop-in equivalent of the reference DIFM class
    (``deepctr/models/difm.py:16-106``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns, att_head_num=4,
        att_res=True, dnn_hidden_units=(256, 128), l2_reg_linear=0.00001,
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
        self.att_head_num = att_head_num
        self.att_res = att_res
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.add_regularization_weight(("vector_wise_net/",), l2=l2_reg_dnn)
        self.add_regularization_weight(("bit_wise_net/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("transform_matrix_P_vec/",), l2=l2_reg_dnn)
        self.add_regularization_weight(("transform_matrix_P_bit/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        sparse_feat_num = len(
            [f for f in self.dnn_feature_columns if isinstance(f, (SparseFeat, VarLenSparseFeat))]
        )
        return DIFMModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self.embedding_size,
            sparse_feat_num=sparse_feat_num,
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
