"""FiBiNET (port of ``xdeepfm_tpu/models/fibinet.py``; reference
``deepctr/models/fibinet.py:17-102``).

The linear term plus a DNN over two bilinear interactions of the sparse
embeddings: of their squeeze-excitation (``SE``) and of the raw stack, by
ONE shared ``Bilinear`` (the reference shares it too, ``fibinet.py:50,
84-85``), concatenated in that order, then the dense values.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import DenseFeat, FeatureSchema, SparseFeat, VarLenSparseFeat, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import BilinearInteraction, SENETLayer


class FiBiNETModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``SE``, ``Bilinear``, ``dnn``, ``dnn_linear``, ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        field_size: int,
        embedding_size: int,
        bilinear_type: str = "interaction",
        reduction_ratio: int = 3,
        dnn_hidden_units: Sequence[int] = (128, 128),
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.linear_cols, self.dnn_cols = tuple(linear_cols), tuple(dnn_cols)
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        self.SE = SENETLayer(field_size, reduction_ratio, generator=gen)
        self.Bilinear = BilinearInteraction(field_size, embedding_size, bilinear_type,
                                            flatten_output=True, generator=gen)
        dense_dim = sum(f.dimension for f in self.dnn_cols if isinstance(f, DenseFeat))
        self.dnn = DNN(
            field_size * (field_size - 1) * embedding_size + dense_dim, dnn_hidden_units,
            activation=dnn_activation, dropout_rate=dnn_dropout, init_std=init_std,
            generator=gen,
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
        senet_bilinear_out = self.Bilinear(self.SE(sparse_stack, training=training),
                                           training=training)
        bilinear_out = self.Bilinear(sparse_stack, training=training)
        linear_logit = self.linear_model(batch, sparse_rows=lin_rows)
        parts = [senet_bilinear_out, bilinear_out]
        if dense_vals is not None:
            parts.append(dense_vals)
        dnn_out = self.dnn(torch.cat(parts, dim=-1), training=training, generator=generator)
        dnn_logit = self.dnn_linear(dnn_out)
        if len(self.linear_cols) > 0 and len(self.dnn_cols) > 0:
            final_logit = linear_logit + dnn_logit
        elif len(self.linear_cols) == 0:
            final_logit = dnn_logit
        else:
            final_logit = linear_logit
        return {"pred": self.out(final_logit)}


class FiBiNET(BaseModel):
    """Drop-in equivalent of the reference FiBiNET class
    (``deepctr/models/fibinet.py:17-102``).  ``device=None`` means "cuda".
    As in the JAX class, ``l2_reg_dnn`` is accepted and registers nothing."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns,
        bilinear_type="interaction", reduction_ratio=3,
        dnn_hidden_units=(128, 128), l2_reg_linear=1e-5, l2_reg_embedding=1e-5,
        l2_reg_dnn=0, init_std=0.0001, seed=1024, dnn_dropout=0,
        dnn_activation="relu", task="binary", device=None, gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.bilinear_type = bilinear_type
        self.reduction_ratio = reduction_ratio
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self._finalize()

    def _build_module(self):
        field_size = len([f for f in self.dnn_feature_columns
                          if isinstance(f, (SparseFeat, VarLenSparseFeat))])
        return FiBiNETModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            field_size=field_size,
            embedding_size=self.embedding_size,
            bilinear_type=self.bilinear_type,
            reduction_ratio=self.reduction_ratio,
            dnn_hidden_units=self.dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
