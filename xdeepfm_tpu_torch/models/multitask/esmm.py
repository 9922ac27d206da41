"""ESMM (port of ``xdeepfm_tpu/models/multitask/esmm.py``; reference
``deepctr/models/multitask/esmm.py:17-94``).

Two tower DNNs (CTR and CVR) over ``fast_inputs``, each with a bias-free
final layer, and ONE prediction layer ``out`` applied to both logits, so its
``global_bias`` takes the sum of both uses' gradients.  The outputs are
[ctr, ctr * cvr] (``esmm.py:91``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...basemodel import BaseModel
from ...embeddings import EmbeddingCollection, combined_dnn_input
from ...features import FeatureSchema, compute_input_dim
from ...nn.core import DNN, PredictionLayer
from .sharedbottom import final_layer


class ESMMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``ctr_dnn``,
    ``cvr_dnn``, ``ctr_final``, ``cvr_final``, ``out``."""

    def __init__(
        self,
        dnn_cols: tuple,
        schema: FeatureSchema,
        tower_dnn_hidden_units: Sequence[int] = (256, 128),
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        dnn_use_bn: bool = False,
        init_std: float = 1e-4,
        seed: int = 1024,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen)
        input_dim = compute_input_dim(self.dnn_cols)
        dnn_kw = dict(activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                      init_std=init_std, generator=gen)
        self.ctr_dnn = DNN(input_dim, tower_dnn_hidden_units, **dnn_kw)
        self.cvr_dnn = DNN(input_dim, tower_dnn_hidden_units, **dnn_kw)
        self.ctr_final = final_layer(tower_dnn_hidden_units[-1], 1, gen)
        self.cvr_final = final_layer(tower_dnn_hidden_units[-1], 1, gen)
        self.out = PredictionLayer(task="binary")

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 2]}``, the CTR
        and the CTCVR; ``generator`` draws the dropout masks when
        ``training``."""
        sparse_list, dense_list = self.embedding_dict.fast_inputs(batch, self.dnn_cols)
        dnn_input = combined_dnn_input(sparse_list, dense_list)
        ctr = self.out(self.ctr_final(self.ctr_dnn(dnn_input, training=training,
                                                   generator=generator)))
        cvr = self.out(self.cvr_final(self.cvr_dnn(dnn_input, training=training,
                                                   generator=generator)))
        return {"pred": torch.cat([ctr, ctr * cvr], dim=-1)}


class ESMM(BaseModel):
    """Drop-in equivalent of the reference ESMM class
    (``deepctr/models/multitask/esmm.py:17-94``): two binary tasks, compiled
    with a list of two losses.  ``device=None`` means "cuda"."""

    def __init__(
        self, dnn_feature_columns, tower_dnn_hidden_units=(256, 128),
        l2_reg_linear=0.00001, l2_reg_embedding=0.00001, l2_reg_dnn=0,
        init_std=0.0001, seed=1024, dnn_dropout=0, dnn_activation="relu",
        dnn_use_bn=False, task_types=("binary", "binary"),
        task_names=("ctr", "ctcvr"), device=None, gpus=None,
    ):
        super().__init__(
            [], dnn_feature_columns, l2_reg_linear=l2_reg_linear,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed,
            task="binary", device=device, gpus=gpus,
        )
        self.num_tasks = len(task_names)
        if self.num_tasks != 2:
            raise ValueError("the length of task_names must be equal to 2")
        if len(dnn_feature_columns) == 0:
            raise ValueError("dnn_feature_columns is null!")
        if len(task_types) != self.num_tasks:
            raise ValueError("num_tasks must be equal to the length of task_types")
        for task_type in task_types:
            if task_type != "binary":
                raise ValueError("task must be binary in ESMM, {} is illegal".format(task_type))
        self.tower_dnn_hidden_units = tuple(tower_dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.add_regularization_weight(("ctr_dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("cvr_dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("ctr_final/",), l2=l2_reg_dnn)
        self.add_regularization_weight(("cvr_final/",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return ESMMModule(
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            tower_dnn_hidden_units=self.tower_dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
        )
