"""DeepFM (port of ``xdeepfm_tpu/models/deepfm.py``; reference
``deepctr/models/deepfm.py:16-86``).

linear + FM + DNN towers over the stacked sparse embeddings, logit sum.
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
from ..nn.interaction import FM


class DeepFMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``dnn``, ``dnn_linear``, ``out`` (``fm`` has none)."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        use_fm: bool = True,
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
        # the stacked lookup's dim check, which the JAX model's first forward
        # runs at its construction
        self.embedding_dict.uniform_dim()
        self.use_fm = use_fm
        self.use_dnn = len(self.dnn_cols) > 0 and len(dnn_hidden_units) > 0
        if use_fm:
            self.fm = FM()
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
        sparse_stack, dense_vals, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused
        )
        logit = self.linear_model(batch, sparse_rows=lin_rows)
        if self.use_fm and sparse_stack is not None:
            logit = logit + self.fm(sparse_stack)
        if self.use_dnn:
            dnn_input = combined_dnn_input(
                [] if sparse_stack is None else [sparse_stack],
                [] if dense_vals is None else [dense_vals],
            )
            dnn_out = self.dnn(dnn_input, training=training, generator=generator)
            logit = logit + self.dnn_linear(dnn_out)
        return {"pred": self.out(logit)}


class DeepFM(BaseModel):
    """Drop-in equivalent of the reference DeepFM class
    (``deepctr/models/deepfm.py:16-86``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns, use_fm=True,
        dnn_hidden_units=(256, 128), l2_reg_linear=0.00001,
        l2_reg_embedding=0.00001, l2_reg_dnn=0, init_std=0.0001, seed=1024,
        dnn_dropout=0, dnn_activation="relu", dnn_use_bn=False, task="binary",
        device=None, gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.use_fm = use_fm
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        if len(dnn_feature_columns) > 0 and len(self.dnn_hidden_units) > 0:
            self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
            self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return DeepFMModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            use_fm=self.use_fm,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
