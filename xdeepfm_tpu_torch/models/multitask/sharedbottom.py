"""SharedBottom (port of ``xdeepfm_tpu/models/multitask/sharedbottom.py``;
reference ``deepctr/models/multitask/sharedbottom.py:17-104``).

One bottom DNN over ``fast_inputs`` shared by every task, then per task an
optional tower DNN, a bias-free final layer and a prediction layer; the
outputs are [B, num_tasks].
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...basemodel import BaseModel
from ...embeddings import EmbeddingCollection, combined_dnn_input
from ...features import FeatureSchema, compute_input_dim
from ...nn.core import DNN, PredictionLayer, torch_linear_init


def check_task_types(task_types, num_tasks):
    """The checks of ``task_types`` that SharedBottom, MMOE and PLE make,
    with the JAX constructors' messages."""
    if len(task_types) != num_tasks:
        raise ValueError("num_tasks must be equal to the length of task_types")
    for task_type in task_types:
        if task_type not in ["binary", "regression"]:
            raise ValueError(
                "task must be binary or regression, {} is illegal".format(task_type))


def final_layer(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    """A bias-free ``nn.Linear`` with torch's default init: the flax
    ``Dense(use_bias=False, kernel_init=torch_linear_init)`` of the towers and
    gates."""
    layer = nn.Linear(in_dim, out_dim, bias=False)
    torch_linear_init(layer.weight, gen)
    return layer


def add_towers(module: nn.Module, width: int, tower_dnn_hidden_units, task_types, dnn_kw,
               gen: torch.Generator) -> None:
    """Each task's head on ``module`` under the JAX names: ``tower_dnn_{i}``
    over ``width`` inputs (none when ``tower_dnn_hidden_units`` is empty),
    the bias-free ``tower_final_{i}`` and the prediction layer ``out_{i}``."""
    module.use_tower = len(tower_dnn_hidden_units) > 0
    final_in = tower_dnn_hidden_units[-1] if module.use_tower else width
    for i, task in enumerate(task_types):
        if module.use_tower:
            module.add_module(f"tower_dnn_{i}", DNN(width, tower_dnn_hidden_units, **dnn_kw))
        module.add_module(f"tower_final_{i}", final_layer(final_in, 1, gen))
        module.add_module(f"out_{i}", PredictionLayer(task=task))


def tower_outputs(module: nn.Module, inputs, training: bool, generator) -> torch.Tensor:
    """[B, num_tasks]: task i's head of :func:`add_towers` over ``inputs[i]``."""
    outs = []
    for i, h in enumerate(inputs):
        if module.use_tower:
            h = getattr(module, f"tower_dnn_{i}")(h, training=training, generator=generator)
        outs.append(getattr(module, f"out_{i}")(getattr(module, f"tower_final_{i}")(h)))
    return torch.cat(outs, dim=-1)


class SharedBottomModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``bottom_dnn``,
    ``tower_dnn_{i}`` (when ``tower_dnn_hidden_units``), ``tower_final_{i}``,
    ``out_{i}``."""

    def __init__(
        self,
        dnn_cols: tuple,
        schema: FeatureSchema,
        bottom_dnn_hidden_units: Sequence[int] = (256, 128),
        tower_dnn_hidden_units: Sequence[int] = (64,),
        dnn_dropout: float = 0.0,
        dnn_activation: str = "relu",
        dnn_use_bn: bool = False,
        init_std: float = 1e-4,
        seed: int = 1024,
        task_types: Sequence[str] = ("binary", "binary"),
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.num_tasks = len(task_types)
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen)
        dnn_kw = dict(activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                      init_std=init_std, generator=gen)
        self.bottom_dnn = DNN(compute_input_dim(self.dnn_cols), bottom_dnn_hidden_units,
                              **dnn_kw)
        add_towers(self, bottom_dnn_hidden_units[-1], tower_dnn_hidden_units, task_types,
                   dnn_kw, gen)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, num_tasks]}``;
        ``generator`` draws the dropout masks when ``training``."""
        sparse_list, dense_list = self.embedding_dict.fast_inputs(batch, self.dnn_cols)
        dnn_input = combined_dnn_input(sparse_list, dense_list)
        shared = self.bottom_dnn(dnn_input, training=training, generator=generator)
        return {"pred": tower_outputs(self, [shared] * self.num_tasks, training, generator)}


class SharedBottom(BaseModel):
    """Drop-in equivalent of the reference SharedBottom class
    (``deepctr/models/multitask/sharedbottom.py:17-104``); compile it with a
    list of losses, one per task.  ``device=None`` means "cuda"."""

    def __init__(
        self, dnn_feature_columns, bottom_dnn_hidden_units=(256, 128),
        tower_dnn_hidden_units=(64,), l2_reg_linear=0.00001,
        l2_reg_embedding=0.00001, l2_reg_dnn=0, init_std=0.0001, seed=1024,
        dnn_dropout=0, dnn_activation="relu", dnn_use_bn=False,
        task_types=("binary", "binary"), task_names=("ctr", "ctcvr"),
        device=None, gpus=None,
    ):
        super().__init__(
            [], dnn_feature_columns, l2_reg_linear=l2_reg_linear,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed,
            device=device, gpus=gpus,
        )
        self.num_tasks = len(task_names)
        if self.num_tasks <= 1:
            raise ValueError("num_tasks must be greater than 1")
        if len(dnn_feature_columns) == 0:
            raise ValueError("dnn_feature_columns is null!")
        check_task_types(task_types, self.num_tasks)
        self.task_names = tuple(task_names)
        self.task_types = tuple(task_types)
        self.bottom_dnn_hidden_units = tuple(bottom_dnn_hidden_units)
        self.tower_dnn_hidden_units = tuple(tower_dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.add_regularization_weight(("bottom_dnn/", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("tower_dnn_", "/kernel"), l2=l2_reg_dnn)
        self.add_regularization_weight(("tower_final_",), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return SharedBottomModule(
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            bottom_dnn_hidden_units=self.bottom_dnn_hidden_units,
            tower_dnn_hidden_units=self.tower_dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task_types=self.task_types,
        )
