"""PLE / CGC (port of ``xdeepfm_tpu/models/multitask/ple.py``; reference
``deepctr/models/multitask/ple.py:17-219``).

``num_levels`` customized gate control (CGC) levels.  At each level every task
has ``specific_expert_num`` expert DNNs over its own input and the level has
``shared_expert_num`` shared experts over the shared input; task i's softmax
gate mixes its own experts and the shared ones, and the shared gate mixes
them all.  Level 0's inputs are all the DNN input; a later level's are the
mixtures of the one before.  The heads of ``sharedbottom.add_towers`` read
the last level's task mixtures.

The JAX module keeps the reference's quirk of building the shared experts
with ``specific_expert_num`` modules while its forward calls
``shared_expert_num`` of them, and flax makes parameters only for the
modules that are called.  So this module builds exactly the shared experts
that the forward calls, ``shared_expert_{level}_0_{k}`` for k below
``shared_expert_num``, and raises ``IndexError`` where the JAX constructor
does (``shared_expert_num > specific_expert_num``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...basemodel import BaseModel
from ...embeddings import EmbeddingCollection, combined_dnn_input
from ...features import FeatureSchema, compute_input_dim
from ...nn.core import DNN
from .mmoe import mix_experts
from .sharedbottom import add_towers, check_task_types, final_layer, tower_outputs


class PLEModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, per level l
    ``specific_expert_{l}_{task}_{e}``, ``shared_expert_{l}_0_{e}``,
    ``specific_gate_dnn_{l}_{task}_0`` and ``shared_gate_dnn_{l}`` (when
    ``gate_dnn_hidden_units``), ``specific_gate_final_{l}_{task}``,
    ``shared_gate_final_{l}``; then ``tower_dnn_{i}`` (when
    ``tower_dnn_hidden_units``), ``tower_final_{i}``, ``out_{i}``."""

    def __init__(
        self,
        dnn_cols: tuple,
        schema: FeatureSchema,
        shared_expert_num: int = 1,
        specific_expert_num: int = 1,
        num_levels: int = 2,
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
        if shared_expert_num > specific_expert_num:
            # the JAX module indexes a tuple of specific_expert_num shared experts
            raise IndexError("tuple index out of range")
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.num_tasks = T = len(task_types)
        self.shared_expert_num = shared_expert_num
        self.specific_expert_num = specific_expert_num
        self.num_levels = num_levels
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen)
        input_dim = compute_input_dim(self.dnn_cols)
        exp_dim = expert_dnn_hidden_units[-1]
        dnn_kw = dict(activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                      init_std=init_std, generator=gen)
        self.use_gate_dnn = len(gate_dnn_hidden_units) > 0
        for level in range(num_levels):
            in_dim = input_dim if level == 0 else exp_dim
            for i in range(T):
                for e in range(specific_expert_num):
                    self.add_module(f"specific_expert_{level}_{i}_{e}",
                                    DNN(in_dim, expert_dnn_hidden_units, **dnn_kw))
            for e in range(shared_expert_num):
                self.add_module(f"shared_expert_{level}_0_{e}",
                                DNN(in_dim, expert_dnn_hidden_units, **dnn_kw))
            if self.use_gate_dnn:
                for i in range(T):
                    self.add_module(f"specific_gate_dnn_{level}_{i}_0",
                                    DNN(in_dim, gate_dnn_hidden_units, **dnn_kw))
                self.add_module(f"shared_gate_dnn_{level}",
                                DNN(in_dim, gate_dnn_hidden_units, **dnn_kw))
            gate_in = gate_dnn_hidden_units[-1] if self.use_gate_dnn else in_dim
            for i in range(T):
                self.add_module(f"specific_gate_final_{level}_{i}",
                                final_layer(gate_in, specific_expert_num + shared_expert_num,
                                            gen))
            self.add_module(f"shared_gate_final_{level}",
                            final_layer(gate_in, T * specific_expert_num + shared_expert_num,
                                        gen))
        add_towers(self, exp_dim, tower_dnn_hidden_units, task_types, dnn_kw, gen)

    def _gate(self, name, dnn_name, x, training, generator):
        """A gate's logits: its DNN (when there are gate DNNs), then its
        final layer."""
        if self.use_gate_dnn:
            x = getattr(self, dnn_name)(x, training=training, generator=generator)
        return getattr(self, name)(x)

    def _cgc(self, inputs, level, training, generator):
        """One CGC level (``ple.py:130-167``): ``inputs`` holds each task's
        input, then the shared one; returns each task's mixture, then the
        shared mixture.  Nothing reads the last level's shared mixture, so
        its gate takes only its L2 gradient, but it runs as in the JAX
        module: its BatchNorm statistics update in training."""
        T, S = self.num_tasks, self.specific_expert_num
        kw = dict(training=training, generator=generator)
        specific = [getattr(self, f"specific_expert_{level}_{i}_{e}")(inputs[i], **kw)
                    for i in range(T) for e in range(S)]
        shared = [getattr(self, f"shared_expert_{level}_0_{e}")(inputs[-1], **kw)
                  for e in range(self.shared_expert_num)]
        outs = []
        for i in range(T):
            experts = torch.stack(specific[i * S : (i + 1) * S] + shared, dim=1)
            logits = self._gate(f"specific_gate_final_{level}_{i}",
                                f"specific_gate_dnn_{level}_{i}_0", inputs[i], **kw)
            outs.append(mix_experts(logits, experts))
        logits = self._gate(f"shared_gate_final_{level}", f"shared_gate_dnn_{level}",
                            inputs[-1], **kw)
        outs.append(mix_experts(logits, torch.stack(specific + shared, dim=1)))
        return outs

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, num_tasks]}``;
        ``generator`` draws the dropout masks when ``training``."""
        sparse_list, dense_list = self.embedding_dict.fast_inputs(batch, self.dnn_cols)
        inputs = [combined_dnn_input(sparse_list, dense_list)] * (self.num_tasks + 1)
        for level in range(self.num_levels):
            inputs = self._cgc(inputs, level, training, generator)
        return {"pred": tower_outputs(self, inputs[: self.num_tasks], training, generator)}


class PLE(BaseModel):
    """Drop-in equivalent of the reference PLE class
    (``deepctr/models/multitask/ple.py:17-219``); compile it with a list of
    losses, one per task.  ``device=None`` means "cuda"."""

    def __init__(
        self, dnn_feature_columns, shared_expert_num=1, specific_expert_num=1,
        num_levels=2, expert_dnn_hidden_units=(256, 128),
        gate_dnn_hidden_units=(64,), tower_dnn_hidden_units=(64,),
        l2_reg_linear=0.00001, l2_reg_embedding=0.00001, l2_reg_dnn=0,
        init_std=0.0001, seed=1024, dnn_dropout=0, dnn_activation="relu",
        dnn_use_bn=False, task_types=("binary", "binary"),
        task_names=("ctr", "ctcvr"), device=None, gpus=None,
    ):
        super().__init__(
            [], dnn_feature_columns, l2_reg_linear=l2_reg_linear,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed,
            device=device, gpus=gpus,
        )
        self.num_tasks = len(task_names)
        if self.num_tasks <= 1:
            raise ValueError("num_tasks must be greater than 1!")
        if len(dnn_feature_columns) == 0:
            raise ValueError("dnn_feature_columns is null!")
        check_task_types(task_types, self.num_tasks)
        self.shared_expert_num = shared_expert_num
        self.specific_expert_num = specific_expert_num
        self.num_levels = num_levels
        self.task_names = tuple(task_names)
        self.task_types = tuple(task_types)
        self.expert_dnn_hidden_units = tuple(expert_dnn_hidden_units)
        self.gate_dnn_hidden_units = tuple(gate_dnn_hidden_units)
        self.tower_dnn_hidden_units = tuple(tower_dnn_hidden_units)
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        # the gate finals match both a gate pattern and ("gate_final",), so
        # their l2 is twice l2_reg_dnn, as in the JAX registry
        for pat in (
            ("specific_expert_", "/kernel"),
            ("shared_expert_", "/kernel"),
            ("specific_gate_", "/kernel"),
            ("shared_gate_", "/kernel"),
            ("gate_final",),
            ("tower_dnn_", "/kernel"),
            ("tower_final_",),
        ):
            self.add_regularization_weight(pat, l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        return PLEModule(
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            shared_expert_num=self.shared_expert_num,
            specific_expert_num=self.specific_expert_num,
            num_levels=self.num_levels,
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
