"""xDeepFM (port of ``xdeepfm_tpu/models/xdeepfm.py``; reference
``deepctr/models/xdeepfm.py``).

linear + CIN + DNN towers, logit sum (``xdeepfm.py:94-103``).
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
    lookup_inputs,
)
from ..features import FeatureSchema, compute_input_dim, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import CIN, cin_featuremap_num


class XDeepFMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``cin``, ``cin_linear``, ``dnn``, ``dnn_linear``, ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        dnn_hidden_units: Sequence[int] = (256, 256),
        cin_layer_size: Sequence[int] = (256, 128),
        cin_split_half: bool = True,
        cin_activation: str = "relu",
        l2_reg_dnn: float = 0.0,
        l2_reg_cin: float = 0.0,
        init_std: float = 1e-4,
        seed: int = 1024,
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        dnn_use_bn: bool = False,
        task: str = "binary",
        cin_factory=None,
    ):
        """``cin_factory(field_num, generator)`` -> (CIN-like module, output
        width) builds the CIN tower (default: :class:`CIN`); the attention
        models pass theirs."""
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(
            linear_cols, schema, init_std=init_std, generator=gen
        )
        sp, _, vl = split_columns(self.dnn_cols)
        self.use_dnn = len(self.dnn_cols) > 0 and len(dnn_hidden_units) > 0
        self.use_cin = len(cin_layer_size) > 0 and len(self.dnn_cols) > 0
        if self.use_dnn:
            self.dnn = DNN(
                compute_input_dim(self.dnn_cols),
                dnn_hidden_units,
                activation=dnn_activation,
                l2_reg=l2_reg_dnn,
                dropout_rate=dnn_dropout,
                use_bn=dnn_use_bn,
                init_std=init_std,
                generator=gen,
            )
            self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
            torch_linear_init(self.dnn_linear.weight, gen)
        if self.use_cin:
            if cin_factory is None:
                self.cin = CIN(
                    len(sp) + len(vl),
                    cin_layer_size,
                    activation=cin_activation,
                    split_half=cin_split_half,
                    l2_reg=l2_reg_cin,
                    generator=gen,
                )
                width = cin_featuremap_num(cin_layer_size, cin_split_half)
            else:
                self.cin, width = cin_factory(len(sp) + len(vl), gen)
            self.cin_linear = nn.Linear(width, 1, bias=False)
            torch_linear_init(self.cin_linear.weight, gen)
        self.out = PredictionLayer(task=task)
        # one gather through the main and linear tables where they allow it
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors (``sparse`` int [B, F], ``dense`` f32).
        Returns ``{"pred": [B, 1]}``.  ``generator`` draws dropout masks when
        ``training``."""
        sparse_stack, dense_vals, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        final_logit = self.linear_model(batch, sparse_rows=lin_rows)
        if self.use_cin:
            cin_output = self.cin(sparse_stack, training=training, generator=generator)
            final_logit = final_logit + self.cin_linear(cin_output)
        if self.use_dnn:
            dnn_input = combined_dnn_input(
                [] if sparse_stack is None else [sparse_stack],
                [] if dense_vals is None else [dense_vals],
            )
            dnn_output = self.dnn(dnn_input, training=training, generator=generator)
            final_logit = final_logit + self.dnn_linear(dnn_output)
        return {"pred": self.out(final_logit)}


class xDeepFM(BaseModel):
    """Drop-in equivalent of the reference xDeepFM class
    (``deepctr/models/xdeepfm.py:17-107``).  ``device=None`` means "cuda"."""

    def __init__(
        self,
        linear_feature_columns,
        dnn_feature_columns,
        dnn_hidden_units=(256, 256),
        cin_layer_size=(256, 128),
        cin_split_half=True,
        cin_activation="relu",
        l2_reg_linear=0.00001,
        l2_reg_embedding=0.00001,
        l2_reg_dnn=0,
        l2_reg_cin=0,
        init_std=0.0001,
        seed=1024,
        dnn_dropout=0,
        dnn_activation="relu",
        dnn_use_bn=False,
        task="binary",
        device=None,
        gpus=None,
    ):
        super().__init__(
            linear_feature_columns,
            dnn_feature_columns,
            l2_reg_linear=l2_reg_linear,
            l2_reg_embedding=l2_reg_embedding,
            init_std=init_std,
            seed=seed,
            task=task,
            device=device,
            gpus=gpus,
        )
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.cin_layer_size = tuple(cin_layer_size)
        self.cin_split_half = cin_split_half
        self.cin_activation = cin_activation
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        # reg registrations mirror xdeepfm.py:57-60,74-75
        if len(dnn_feature_columns) > 0 and len(self.dnn_hidden_units) > 0:
            self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
            self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        if len(self.cin_layer_size) > 0 and len(dnn_feature_columns) > 0:
            self.add_regularization_weight(("cin/", "conv_w"), l2=l2_reg_cin)
        self._l2_reg_dnn = l2_reg_dnn
        self._l2_reg_cin = l2_reg_cin
        self._finalize()

    def _build_module(self):
        return XDeepFMModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            dnn_hidden_units=self.dnn_hidden_units,
            cin_layer_size=self.cin_layer_size,
            cin_split_half=self.cin_split_half,
            cin_activation=self.cin_activation,
            l2_reg_dnn=self._l2_reg_dnn,
            l2_reg_cin=self._l2_reg_cin,
            init_std=self.init_std,
            seed=self.seed,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            task=self.task,
        )
