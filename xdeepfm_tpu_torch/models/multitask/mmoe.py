"""MMOE (port of ``xdeepfm_tpu/models/multitask/mmoe.py``; reference
``deepctr/models/multitask/mmoe.py:17-143``).

``num_experts`` expert DNNs over ``fast_inputs``, stacked to [B, K, d]; per
task a softmax gate over the K experts (an optional gate DNN, then a
bias-free ``gate_final_{i}``) mixes them, and the task's head of
``sharedbottom.add_towers`` reads the mixture.  The outputs are
[B, num_tasks].
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...basemodel import BaseModel
from ...embeddings import EmbeddingCollection, combined_dnn_input
from ...features import FeatureSchema, compute_input_dim
from ...nn.core import DNN
from .sharedbottom import add_towers, check_task_types, final_layer, tower_outputs


def mix_experts(gate_logits: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """softmax(gate_logits) [B, K] over the K stacked experts [B, K, d] ->
    [B, d] (``mmoe.py:103-104``)."""
    return torch.einsum("bk,bkd->bd", torch.softmax(gate_logits, dim=1), experts)


class MMOEModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``,
    ``expert_dnn_{k}``, ``gate_dnn_{i}`` (when ``gate_dnn_hidden_units``),
    ``gate_final_{i}``, ``tower_dnn_{i}`` (when ``tower_dnn_hidden_units``),
    ``tower_final_{i}``, ``out_{i}``."""

    def __init__(
        self,
        dnn_cols: tuple,
        schema: FeatureSchema,
        num_experts: int = 3,
        expert_dnn_hidden_units: Sequence[int] = (256, 128),
        gate_dnn_hidden_units: Sequence[int] = (64,),
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
        self.num_experts = num_experts
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen)
        input_dim = compute_input_dim(self.dnn_cols)
        dnn_kw = dict(activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                      init_std=init_std, generator=gen)
        for k in range(num_experts):
            self.add_module(f"expert_dnn_{k}", DNN(input_dim, expert_dnn_hidden_units, **dnn_kw))
        self.use_gate_dnn = len(gate_dnn_hidden_units) > 0
        gate_in = gate_dnn_hidden_units[-1] if self.use_gate_dnn else input_dim
        for i in range(self.num_tasks):
            if self.use_gate_dnn:
                self.add_module(f"gate_dnn_{i}", DNN(input_dim, gate_dnn_hidden_units, **dnn_kw))
            self.add_module(f"gate_final_{i}", final_layer(gate_in, num_experts, gen))
        add_towers(self, expert_dnn_hidden_units[-1], tower_dnn_hidden_units, task_types,
                   dnn_kw, gen)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, num_tasks]}``;
        ``generator`` draws the dropout masks when ``training``."""
        sparse_list, dense_list = self.embedding_dict.fast_inputs(batch, self.dnn_cols)
        dnn_input = combined_dnn_input(sparse_list, dense_list)
        experts = torch.stack([
            getattr(self, f"expert_dnn_{k}")(dnn_input, training=training, generator=generator)
            for k in range(self.num_experts)], dim=1)  # [B, K, d]
        mixed = []
        for i in range(self.num_tasks):
            g = dnn_input
            if self.use_gate_dnn:
                g = getattr(self, f"gate_dnn_{i}")(g, training=training, generator=generator)
            mixed.append(mix_experts(getattr(self, f"gate_final_{i}")(g), experts))
        return {"pred": tower_outputs(self, mixed, training, generator)}


class MMOE(BaseModel):
    """Drop-in equivalent of the reference MMOE class
    (``deepctr/models/multitask/mmoe.py:17-143``); compile it with a list of
    losses, one per task.  ``device=None`` means "cuda"."""

    def __init__(
        self, dnn_feature_columns, num_experts=3,
        expert_dnn_hidden_units=(256, 128), gate_dnn_hidden_units=(64,),
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
        if num_experts <= 1:
            raise ValueError("num_experts must be greater than 1")
        if len(dnn_feature_columns) == 0:
            raise ValueError("dnn_feature_columns is null!")
        check_task_types(task_types, self.num_tasks)
        self.num_experts = num_experts
        self.task_names = tuple(task_names)
        self.task_types = tuple(task_types)
        self.expert_dnn_hidden_units = tuple(expert_dnn_hidden_units)
        self.gate_dnn_hidden_units = tuple(gate_dnn_hidden_units)
        self.tower_dnn_hidden_units = tuple(tower_dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        for pat in (
            ("expert_dnn_", "/kernel"),
            ("gate_dnn_", "/kernel"),
            ("gate_final_",),
            ("tower_dnn_", "/kernel"),
            ("tower_final_",),
        ):
            self.add_regularization_weight(pat, l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return MMOEModule(
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            num_experts=self.num_experts,
            expert_dnn_hidden_units=self.expert_dnn_hidden_units,
            gate_dnn_hidden_units=self.gate_dnn_hidden_units,
            tower_dnn_hidden_units=self.tower_dnn_hidden_units,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            init_std=self.init_std,
            seed=self.seed,
            task_types=self.task_types,
        )
