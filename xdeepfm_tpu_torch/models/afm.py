"""AFM (port of ``xdeepfm_tpu/models/afm.py``; reference
``deepctr/models/afm.py:15-66``).

The linear term plus attention-weighted pairwise products (``AFMLayer``), or
plain FM with ``use_attention=False``, over sparse-only DNN columns.
"""

from __future__ import annotations

import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, can_fuse_lookup, lookup_inputs
from ..features import FeatureSchema, split_columns
from ..nn.core import PredictionLayer
from ..nn.interaction import FM, AFMLayer


class AFMModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``fm`` (``AFMLayer``'s ``attention_W`` ...; plain FM has none),
    ``out``."""

    def __init__(
        self,
        linear_cols: tuple,
        dnn_cols: tuple,
        schema: FeatureSchema,
        embedding_size: int,
        use_attention: bool = True,
        attention_factor: int = 8,
        l2_reg_att: float = 1e-5,
        afm_dropout: float = 0.0,
        init_std: float = 1e-4,
        seed: int = 1024,
        task: str = "binary",
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        sp, de, _ = split_columns(self.dnn_cols)
        if de:  # the JAX model's first forward, at its construction
            raise ValueError("DenseFeat is not supported in dnn_feature_columns")
        self.embedding_dict = EmbeddingCollection(
            self.dnn_cols, schema, init_std=init_std, generator=gen
        )
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        self.use_attention = use_attention
        if use_attention:
            self.fm = AFMLayer(embedding_size, attention_factor=attention_factor,
                               l2_reg_w=l2_reg_att, dropout_rate=afm_dropout, generator=gen)
        else:
            self.fm = FM()
        self.out = PredictionLayer(task=task)
        self._fused = can_fuse_lookup(self.embedding_dict, self.linear_model, sp)

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors.  Returns ``{"pred": [B, 1]}``;
        ``generator`` draws the attention output's dropout mask when
        ``training``."""
        sparse_stack, _, lin_rows = lookup_inputs(
            self.embedding_dict, self.linear_model, batch, self.dnn_cols, self._fused,
            support_dense=False,
        )
        logit = self.linear_model(batch, sparse_rows=lin_rows)
        if sparse_stack is not None:
            if self.use_attention:
                logit = logit + self.fm(sparse_stack, training=training, generator=generator)
            else:
                logit = logit + self.fm(sparse_stack)
        return {"pred": self.out(logit)}


class AFM(BaseModel):
    """Drop-in equivalent of the reference AFM class
    (``deepctr/models/afm.py:15-66``).  ``device=None`` means "cuda"."""

    def __init__(
        self, linear_feature_columns, dnn_feature_columns, use_attention=True,
        attention_factor=8, l2_reg_linear=1e-5, l2_reg_embedding=1e-5,
        l2_reg_att=1e-5, afm_dropout=0, init_std=0.0001, seed=1024,
        task="binary", device=None, gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.use_attention = use_attention
        self.attention_factor = attention_factor
        self.l2_reg_att = l2_reg_att
        self.afm_dropout = afm_dropout
        if use_attention:
            # the reference registers attention_W only (afm.py:46)
            self.add_regularization_weight(("fm/attention_W",), l2=l2_reg_att)
        self._finalize()

    def _build_module(self):
        return AFMModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self.embedding_size,
            use_attention=self.use_attention,
            attention_factor=self.attention_factor,
            l2_reg_att=self.l2_reg_att,
            afm_dropout=self.afm_dropout,
            init_std=self.init_std,
            seed=self.seed,
            task=self.task,
        )
