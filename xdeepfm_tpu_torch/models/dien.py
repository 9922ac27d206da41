"""DIEN (port of ``xdeepfm_tpu/models/dien.py``; reference
``deepctr/models/dien.py:16-381``).

InterestExtractor (a GRU over the behaviour sequence, plus the auxiliary
click / no-click loss with negative sampling) -> InterestEvolving (GRU,
AIGRU, AGRU or AUGRU with DIN attention against the target item) -> DNN.

As in the JAX package everything runs over the full padded batch with masks:
the recurrences freeze their state past each row's length, so a row's last
state is the last step's, and a length-0 row's output is zeroed.  The port
runs batch-major ([B, T, H]) where the JAX package transposed to its TPU lane
layout; the math and the parameter paths are the same.  The auxiliary loss
is computed only when ``training`` (under the JAX package's jitted predict it
is dead code), and every field of the one embedding table is fetched by one
gather.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, combined_dnn_input
from ..features import FeatureSchema, SparseFeat, split_columns
from ..nn.core import DNN, PredictionLayer
from ..nn.sequence import GRU, AttentionSequencePoolingLayer, DynamicGRU, sequence_mask
from ..parallel.mesh import batch_sum


class InterestExtractor(nn.Module):
    """GRU over the behaviour sequence + the auxiliary loss
    (``dien.py:36-92``).  Parameters ``gru`` and ``auxiliary_net``
    (DNN 2H -> 100 -> 50 -> 1, sigmoid)."""

    def __init__(self, input_size: int, use_neg: bool = False, init_std: float = 0.001,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_neg = use_neg
        self.gru = GRU(input_size, input_size, init_std=init_std, generator=generator)
        if use_neg:
            self.auxiliary_net = DNN(input_size * 2, (100, 50, 1), activation="sigmoid",
                                     init_std=init_std, generator=generator)

    def forward(self, keys, keys_length, neg_keys=None, training: bool = False):
        """keys [B, T, H], keys_length [B] -> (FROZEN interests [B, T, H],
        aux_loss); the aux loss is 0 unless ``training`` with negatives."""
        interests = self.gru.run(keys, keys_length)
        aux_loss = keys.new_zeros(())
        if self.use_neg and neg_keys is not None and training:
            aux_loss = self._auxiliary_loss(interests[:, :-1], keys[:, 1:], neg_keys[:, 1:],
                                            keys_length - 1)
        return interests, aux_loss

    def _auxiliary_loss(self, states, click, noclick, lengths):
        """Masked BCE of the aux net on (state, next click) against (state,
        next non-click) over each row's first length - 1 steps
        (``dien.py:71-92``): both halves in one pass of the net."""
        mask = sequence_mask(lengths, states.shape[1]).to(states.dtype)  # [B, T - 1]
        p = self.auxiliary_net(torch.stack([torch.cat([states, click], -1),
                                            torch.cat([states, noclick], -1)]))[..., 0]
        eps = 1e-7
        click_ll = -torch.log(p[0].clamp(eps, 1 - eps))
        noclick_ll = -torch.log((1 - p[1]).clamp(eps, 1 - eps))
        # on a rank grid the global batch's count (mesh.batch_sum)
        n_valid = batch_sum(mask.sum()).clamp(min=1.0)
        return ((click_ll * mask).sum() + (noclick_ll * mask).sum()) / (2.0 * n_valid)


class InterestEvolving(nn.Module):
    """Attention against the target item + the evolving recurrence
    (``dien.py:95-190``).  Parameters ``attention`` and
    ``interest_evolution`` (a GRU for "GRU" and "AIGRU", else a
    DynamicGRU)."""

    def __init__(self, input_size: int, gru_type: str = "GRU", use_neg: bool = False,
                 init_std: float = 0.001, att_hidden_size: Sequence[int] = (64, 16),
                 att_activation: str = "sigmoid", att_weight_normalization: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if gru_type not in ["GRU", "AIGRU", "AGRU", "AUGRU"]:
            raise NotImplementedError(f"gru_type: {gru_type} is not supported")
        self.gru_type = gru_type
        self.attention = AttentionSequencePoolingLayer(
            embedding_dim=input_size, att_hidden_units=att_hidden_size,
            att_activation=att_activation, weight_normalization=att_weight_normalization,
            return_score=gru_type != "GRU", generator=generator,
        )
        if gru_type in ("GRU", "AIGRU"):
            self.interest_evolution = GRU(input_size, input_size, init_std=init_std,
                                          generator=generator)
        else:
            self.interest_evolution = DynamicGRU(input_size, input_size, gru_type=gru_type,
                                                 init_std=init_std, generator=generator)

    def forward(self, query, keys, keys_length, training: bool = False):
        """query [B, H], keys [B, T, H] (the extractor's frozen states),
        keys_length [B] -> [B, H], zero for a length-0 row."""
        valid_row = (keys_length > 0).to(query.dtype)[:, None]
        if self.gru_type == "GRU":
            # zero past each row's length, as the JAX GRU's batch-major
            # outputs: a Dice attention's statistics read the padded steps
            # (masked scores make them inert otherwise)
            valid = sequence_mask(keys_length, keys.shape[1]).to(keys.dtype)
            states = self.interest_evolution.run(keys, keys_length) * valid[:, :, None]
            scores = self.attention.scores(query, states, keys_length, training=training)
            outputs = (scores[:, :, None] * states).sum(1)
        else:
            scores = self.attention.scores(query, keys, keys_length, training=training)
            if self.gru_type == "AIGRU":
                states = self.interest_evolution.run(keys * scores[:, :, None], keys_length)
            else:
                states = self.interest_evolution.run(keys, scores, keys_length)
            outputs = states[:, -1]  # frozen: each row's last valid state
        return outputs * valid_row


class DIENModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``,
    ``interest_extractor``, ``interest_evolution``, ``dnn``, ``linear``
    (no bias), ``out``."""

    def __init__(
        self,
        dnn_cols: tuple,
        schema: FeatureSchema,
        history_feature_list: Sequence[str],
        interest_dim: int,
        gru_type: str = "GRU",
        use_negsampling: bool = False,
        alpha: float = 1.0,
        use_bn: bool = False,
        dnn_hidden_units: Sequence[int] = (256, 128),
        dnn_activation: str = "relu",
        att_hidden_units: Sequence[int] = (64, 16),
        att_activation: str = "relu",
        att_weight_normalization: bool = True,
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
        self.use_negsampling, self.alpha = use_negsampling, alpha
        self.embedding_dict = EmbeddingCollection(self.dnn_cols, schema, init_std=init_std,
                                                  generator=gen)
        sp, de, vl = split_columns(self.dnn_cols)
        hist_names = ["hist_" + x for x in self.history_feature_list]
        neg_names = ["neg_" + x for x in hist_names]
        self._sparse_cols, self._dense_cols = tuple(sp), tuple(de)
        self._history_cols = tuple(f for f in vl if f.name in hist_names)
        self._neg_history_cols = tuple(f for f in vl if f.name in neg_names)
        self._length_name = next((f.length_name for f in vl if f.length_name is not None), None)
        if self._length_name is None:
            raise ValueError(
                "please add max length column for VarLenSparseFeat of DIN/DIEN input"
            )
        self.interest_extractor = InterestExtractor(interest_dim, use_negsampling, init_std,
                                                    generator=gen)
        self.interest_evolution = InterestEvolving(
            interest_dim, gru_type=gru_type, use_neg=use_negsampling, init_std=init_std,
            att_hidden_size=att_hidden_units,
            att_activation=att_activation.lower() if isinstance(att_activation, str)
            else att_activation,
            att_weight_normalization=att_weight_normalization, generator=gen,
        )
        dnn_input_size = (sum(f.embedding_dim for f in sp) + sum(f.dimension for f in de)
                          + interest_dim)
        self.dnn = DNN(dnn_input_size, dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=use_bn, init_std=init_std, generator=gen)
        self.linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
        with torch.no_grad():
            self.linear.weight.normal_(0.0, init_std, generator=gen)
        self.out = PredictionLayer(task=task)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors (``sparse``, ``dense``, ``vl_*``,
        ``len_*``).  Returns ``{"pred": [B, 1], "aux_loss": scalar}``.
        ``generator`` draws the DNN's dropout masks when ``training``."""
        negs = self._neg_history_cols if self.use_negsampling else ()
        n_sp, n_h = len(self._sparse_cols), len(self._history_cols)
        embs = self.embedding_dict.lookup_fields(
            batch, self._sparse_cols + self._history_cols + negs)
        sparse_embs = [e[:, 0] for e in embs[:n_sp]]  # [B, dim] per sparse field
        query = torch.cat([e for f, e in zip(self._sparse_cols, sparse_embs)
                           if f.name in self.history_feature_list], dim=-1)
        keys = torch.cat(embs[n_sp : n_sp + n_h], dim=-1)  # [B, T, H]
        neg_keys = torch.cat(embs[n_sp + n_h :], dim=-1) if negs else None
        keys_length = batch["len_" + self._length_name].reshape(-1)
        interests, aux_loss = self.interest_extractor(keys, keys_length, neg_keys, training)
        hist = self.interest_evolution(query, interests, keys_length, training=training)
        deep_input_emb = torch.cat([hist] + sparse_embs, dim=-1)
        dense_list = [batch["dense"][:, slice(*self.schema.dense_slice(f.name))]
                      for f in self._dense_cols]
        dnn_input = combined_dnn_input([deep_input_emb[:, None, :]], dense_list)
        output = self.linear(self.dnn(dnn_input, training=training, generator=generator))
        return {"pred": self.out(output), "aux_loss": aux_loss * self.alpha}


class DIEN(BaseModel):
    """Drop-in equivalent of the reference DIEN class
    (``deepctr/models/dien.py:16-178``).  ``device=None`` means "cuda"."""

    def __init__(
        self, dnn_feature_columns, history_feature_list, gru_type="GRU",
        use_negsampling=False, alpha=1.0, use_bn=False, dnn_hidden_units=(256, 128),
        dnn_activation="relu", att_hidden_units=(64, 16), att_activation="relu",
        att_weight_normalization=True, l2_reg_dnn=0, l2_reg_embedding=1e-6, dnn_dropout=0,
        init_std=0.0001, seed=1024, task="binary", device=None, gpus=None,
    ):
        super().__init__(
            [], dnn_feature_columns, l2_reg_linear=0, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.history_feature_list = tuple(history_feature_list)
        self.gru_type = gru_type
        self.use_negsampling = use_negsampling
        self.alpha = alpha
        self.use_bn = use_bn
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.dnn_activation = dnn_activation
        self.att_hidden_units = tuple(att_hidden_units)
        self.att_activation = att_activation
        self.att_weight_normalization = att_weight_normalization
        self.dnn_dropout = dnn_dropout
        self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
        self._finalize()

    def _build_module(self):
        interest_dim = sum(
            f.embedding_dim for f in self.dnn_feature_columns
            if isinstance(f, SparseFeat) and f.name in self.history_feature_list
        )
        return DIENModule(
            dnn_cols=self.dnn_feature_columns, schema=self.schema,
            history_feature_list=self.history_feature_list, interest_dim=interest_dim,
            gru_type=self.gru_type, use_negsampling=self.use_negsampling, alpha=self.alpha,
            use_bn=self.use_bn, dnn_hidden_units=self.dnn_hidden_units,
            dnn_activation=self.dnn_activation, att_hidden_units=self.att_hidden_units,
            att_activation=self.att_activation,
            att_weight_normalization=self.att_weight_normalization,
            dnn_dropout=self.dnn_dropout, init_std=self.init_std, seed=self.seed, task=self.task,
        )
