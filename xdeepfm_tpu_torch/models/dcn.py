"""DCN (port of ``xdeepfm_tpu/models/dcn.py``; reference
``deepctr/models/dcn.py:20-96``).

The linear term plus a cross network and a DNN side by side over
``fast_inputs`` (mixed embedding dims allowed), their outputs concatenated
into ``dnn_linear``; either tower alone when the other is empty
(``dcn.py:66-76``).
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
from ..nn.interaction import CrossNet


class DCNModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``dnn``, ``crossnet``, ``dnn_linear``, ``out``.  ``cross_factory(d,
    generator)`` builds the cross network over the d inputs (default:
    :class:`CrossNet`; DCN-Mix passes its own); a tower whose size is 0 is
    not built, as the JAX module never calls it."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        cross_num: int = 2,
        cross_parameterization: str = "vector",
        dnn_hidden_units: Sequence[int] = (128, 128),
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        dnn_use_bn: bool = False,
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
        cross_factory=None,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        in_dim = compute_input_dim(self.dnn_cols)
        self.use_dnn, self.use_cross = len(dnn_hidden_units) > 0, cross_num > 0
        width = 0
        if self.use_dnn:
            self.dnn = DNN(
                in_dim, dnn_hidden_units, activation=dnn_activation, use_bn=dnn_use_bn,
                dropout_rate=dnn_dropout, init_std=init_std, generator=gen,
            )
            width += dnn_hidden_units[-1]
        if self.use_cross:
            if cross_factory is None:
                self.crossnet = CrossNet(in_dim, layer_num=cross_num,
                                         parameterization=cross_parameterization, generator=gen)
            else:
                self.crossnet = cross_factory(in_dim, gen)
            width += in_dim
        if width:
            self.dnn_linear = nn.Linear(width, 1, bias=False)
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
        dnn_input = combined_dnn_input(sparse_list, dense_list)
        towers = []
        if self.use_cross:
            towers.append(self.crossnet(dnn_input))
        if self.use_dnn:
            towers.append(self.dnn(dnn_input, training=training, generator=generator))
        if towers:
            stack_out = towers[0] if len(towers) == 1 else torch.cat(towers, dim=-1)
            logit = logit + self.dnn_linear(stack_out)
        return {"pred": self.out(logit)}


class DCN(BaseModel):
    """Drop-in equivalent of the reference DCN class
    (``deepctr/models/dcn.py:20-96``).  ``device=None`` means "cuda".
    ``l2_reg_linear`` goes to ``dnn_linear``; the linear model keeps the
    engine's default, as in the JAX class."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns, cross_num=2,
        cross_parameterization="vector", dnn_hidden_units=(128, 128),
        l2_reg_linear=0.00001, l2_reg_embedding=0.00001, l2_reg_cross=0.00001,
        l2_reg_dnn=0, init_std=0.0001, seed=1024, dnn_dropout=0,
        dnn_activation="relu", dnn_use_bn=False, task="binary", device=None,
        gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed,
            task=task, device=device, gpus=gpus,
        )
        self.cross_num = cross_num
        self.cross_parameterization = cross_parameterization
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_linear)
        self.add_regularization_weight(("crossnet/kernels",), l2=l2_reg_cross)
        self._finalize()

    def _build_module(self):
        return DCNModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            cross_num=self.cross_num,
            cross_parameterization=self.cross_parameterization,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
