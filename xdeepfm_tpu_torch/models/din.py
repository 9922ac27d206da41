"""DIN (port of ``xdeepfm_tpu/models/din.py``; reference
``deepctr/models/din.py:15-130``).

Attention pooling of the behaviour sequences (the ``hist_*`` varlen
features) against the target item (the sparse features they are named
after), then a DNN over every embedding with the pooled history last; no
linear term.  The attention MLP's activation is Dice by default, whose
BatchNorm statistics run over every (sample, step), padded steps included.
Every field of the one embedding table is fetched by one gather.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, combined_dnn_input
from ..features import FeatureSchema, SparseFeat, compute_input_dim, split_columns
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.sequence import AttentionSequencePoolingLayer


class DINModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``attention``,
    ``dnn``, ``dnn_linear`` (no bias), ``out``."""

    def __init__(
        self,
        dnn_cols: tuple,
        schema: FeatureSchema,
        history_feature_list: Sequence[str],
        att_emb_dim: int,
        dnn_use_bn: bool = False,
        dnn_hidden_units: Sequence[int] = (256, 128),
        dnn_activation: str = "relu",
        att_hidden_size: Sequence[int] = (64, 16),
        att_activation: str = "dice",
        att_weight_normalization: bool = False,
        dnn_dropout: float = 0.0,
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.schema = schema
        self.history_feature_list = tuple(history_feature_list)
        self.embedding_dict = EmbeddingCollection(self.dnn_cols, schema, init_std=init_std,
                                                  generator=gen)
        sp, de, vl = split_columns(self.dnn_cols)
        hist_names = ["hist_" + x for x in self.history_feature_list]
        self._sparse_cols, self._dense_cols = tuple(sp), tuple(de)
        self._history_cols = tuple(f for f in vl if f.name in hist_names)
        self._other_varlen_cols = tuple(f for f in vl if f.name not in hist_names)
        # the history's length names first (din.py:91-99)
        length_names = [f.length_name for f in self._history_cols + self._other_varlen_cols
                        if f.length_name is not None]
        if not length_names:
            raise ValueError(
                "please add max length column for VarLenSparseFeat of DIN/DIEN input"
            )
        self._length_name = length_names[0]
        self.attention = AttentionSequencePoolingLayer(
            att_hidden_units=att_hidden_size, embedding_dim=att_emb_dim,
            att_activation=att_activation, return_score=False, supports_masking=False,
            weight_normalization=att_weight_normalization, generator=gen,
        )
        self.dnn = DNN(compute_input_dim(self.dnn_cols), dnn_hidden_units,
                       activation=dnn_activation, dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                       init_std=init_std, generator=gen)
        self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
        torch_linear_init(self.dnn_linear.weight, gen)
        self.out = PredictionLayer(task=task)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors (``sparse``, ``dense``, ``vl_*``,
        ``len_*``).  Returns ``{"pred": [B, 1]}``; ``generator`` draws the
        DNN's dropout masks when ``training``, when the BatchNorm and Dice
        statistics also update."""
        n_sp, n_h = len(self._sparse_cols), len(self._history_cols)
        embs = self.embedding_dict.lookup_fields(
            batch, self._sparse_cols + self._history_cols + self._other_varlen_cols)
        sparse_embs = embs[:n_sp]  # [B, 1, dim] per sparse field
        query = torch.cat([e for f, e in zip(self._sparse_cols, sparse_embs)
                           if f.name in self.history_feature_list], dim=-1)  # [B, 1, E]
        keys = torch.cat(embs[n_sp : n_sp + n_h], dim=-1)  # [B, T, E]
        hist = self.attention(query, keys, batch["len_" + self._length_name],
                              training=training)  # [B, 1, E]
        pooled = [self.embedding_dict._pool(batch, f, seq)
                  for f, seq in zip(self._other_varlen_cols, embs[n_sp + n_h :])]
        deep_input_emb = torch.cat(sparse_embs + pooled + [hist], dim=-1)
        deep_input_emb = deep_input_emb.reshape(deep_input_emb.shape[0], -1)
        dense_list = [batch["dense"][:, slice(*self.schema.dense_slice(f.name))]
                      for f in self._dense_cols]
        dnn_input = combined_dnn_input([deep_input_emb[:, None, :]], dense_list)
        dnn_output = self.dnn(dnn_input, training=training, generator=generator)
        return {"pred": self.out(self.dnn_linear(dnn_output))}


class DIN(BaseModel):
    """Drop-in equivalent of the reference DIN class
    (``deepctr/models/din.py:15-130``).  ``device=None`` means "cuda"."""

    def __init__(
        self, dnn_feature_columns, history_feature_list, dnn_use_bn=False,
        dnn_hidden_units=(256, 128), dnn_activation="relu",
        att_hidden_size=(64, 16), att_activation="Dice",
        att_weight_normalization=False, l2_reg_dnn=0.0, l2_reg_embedding=1e-6,
        dnn_dropout=0, init_std=0.0001, seed=1024, task="binary", device=None,
        gpus=None,
    ):
        super().__init__(
            [], dnn_feature_columns, l2_reg_linear=0, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.history_feature_list = tuple(history_feature_list)
        self.dnn_use_bn = dnn_use_bn
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_activation = dnn_activation
        self.att_hidden_size = tuple(att_hidden_size)
        self.att_activation = att_activation
        self.att_weight_normalization = att_weight_normalization
        self.dnn_dropout = dnn_dropout
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        att_emb_dim = sum(
            f.embedding_dim for f in self.dnn_feature_columns
            if isinstance(f, SparseFeat) and f.name in self.history_feature_list
        )
        return DINModule(
            dnn_cols=self.dnn_feature_columns, schema=self.schema,
            history_feature_list=self.history_feature_list, att_emb_dim=att_emb_dim,
            dnn_use_bn=self.dnn_use_bn, dnn_hidden_units=self.dnn_hidden_units,
            dnn_activation=self.dnn_activation, att_hidden_size=self.att_hidden_size,
            att_activation=self.att_activation.lower()
            if isinstance(self.att_activation, str) else self.att_activation,
            att_weight_normalization=self.att_weight_normalization,
            dnn_dropout=self.dnn_dropout, init_std=self.init_std, seed=self.seed,
            task=self.task,
        )
