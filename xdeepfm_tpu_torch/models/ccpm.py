"""CCPM (port of ``xdeepfm_tpu/models/ccpm.py``; reference
``deepctr/models/ccpm.py:21-83``).

The linear term plus a DNN over a convolution stack on the sparse
embeddings: [B, F, E, 1] (NHWC, one channel), each layer a SAME (width, 1)
convolution along the fields, tanh and k-max pooling over the fields
(:class:`~xdeepfm_tpu_torch.nn.interaction.ConvLayer`), flattened in the
JAX (field, embedding, channel) order.  Dense features are refused in the
DNN columns, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import FeatureSchema, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import ConvLayer


class CCPMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``conv_layer/conv_{i}/kernel`` [width, 1, in, out] and ``bias`` (raw, in
    the flax layout), ``dnn``, ``dnn_linear``, ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        field_size: int,
        embedding_size: int,
        conv_kernel_width: Sequence[int] = (6, 5),
        conv_filters: Sequence[int] = (4, 4),
        dnn_hidden_units: Sequence[int] = (256,),
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
        if split_columns(self.dnn_cols)[1]:  # the JAX model's first forward, at its construction
            raise ValueError("DenseFeat is not supported in dnn_feature_columns")
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        self.conv_layer = ConvLayer(field_size, conv_kernel_width, conv_filters, generator=gen)
        filed_shape = ConvLayer.output_field_size(field_size, len(conv_filters))
        self.dnn = DNN(
            filed_shape * embedding_size * conv_filters[-1], dnn_hidden_units,
            activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
            init_std=init_std, generator=gen,
        )
        self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
        torch_linear_init(self.dnn_linear.weight, gen)
        self.out = PredictionLayer(task=task)
        sp = split_columns(self.dnn_cols)[0]
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the DNN's dropout masks when ``training``."""
        sparse_stack, _, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused,
            support_dense=False,
        )
        linear_logit = self.linear_model(batch, sparse_rows=lin_rows)
        if sparse_stack is None:
            raise ValueError(
                "must have the embedding feature,now the embedding feature is None!")
        pooling_result = self.conv_layer(sparse_stack[:, :, :, None])  # [B, F', E, C]
        flat = pooling_result.flatten(1)
        dnn_out = self.dnn(flat, training=training, generator=generator)
        return {"pred": self.out(linear_logit + self.dnn_linear(dnn_out))}


class CCPM(BaseModel):
    """Drop-in equivalent of the reference CCPM class
    (``deepctr/models/ccpm.py:21-83``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns,
        conv_kernel_width=(6, 5), conv_filters=(4, 4), dnn_hidden_units=(256,),
        l2_reg_linear=1e-5, l2_reg_embedding=1e-5, l2_reg_dnn=0, dnn_dropout=0,
        init_std=0.0001, seed=1024, task="binary", device=None, dnn_use_bn=False,
        dnn_activation="relu", gpus=None,
    ):
        if len(conv_kernel_width) != len(conv_filters):
            raise ValueError("conv_kernel_width must have same element with conv_filters")
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.conv_kernel_width = tuple(conv_kernel_width)
        self.conv_filters = tuple(conv_filters)
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_use_bn = dnn_use_bn
        self.dnn_activation = dnn_activation
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return CCPMModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            field_size=self.compute_input_dim(self.dnn_feature_columns, include_dense=False,
                                              feature_group=True),
            embedding_size=self.embedding_size,
            conv_kernel_width=self.conv_kernel_width,
            conv_filters=self.conv_filters,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
