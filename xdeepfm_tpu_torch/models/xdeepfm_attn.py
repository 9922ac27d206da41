"""xDeepFM with the attention-pooled CIN (port of
``xdeepfm_tpu/models/xdeepfm_attn.py``; reference
``deepctr/models/xdeepfm_attn.py``).

The xDeepFM skeleton (linear + CIN + DNN towers, one fused gather) with the
CIN tower replaced: :class:`xDeepFMAttention` runs ``CINAttention`` (pooled
output projected back to featuremap_num), :class:`xDeepFMAttentionV2` runs
``CINAttentionV2`` (stacked MHSA blocks, output [B, E]).
"""

from __future__ import annotations

from ..basemodel import BaseModel
from ..features import SparseFeat, VarLenSparseFeat
from ..nn.cin_attention import CINAttention, CINAttentionV2
from .xdeepfm import XDeepFMModule


class XDeepFMAttnModule(XDeepFMModule):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``cin`` (``conv_w_i``, ``mhsa`` or ``mhsa_{i}``, ``layer_norm`` or
    ``ln_{i}``, ``attn_pooling``, V1's ``output_proj``), ``cin_linear``,
    ``dnn``, ``dnn_linear``, ``out``."""

    def __init__(self, linear_cols, dnn_cols, schema, embedding_size, version=1,
                 dnn_hidden_units=(256, 256), cin_layer_size=(256, 128), cin_split_half=True,
                 cin_activation="relu", cin_num_heads=4, cin_attn_dropout=0.0,
                 cin_use_layer_norm=True, cin_use_residual=True, cin_num_attn_layers=1,
                 init_std=1e-4, seed=1024, dnn_dropout=0.0, dnn_activation="relu",
                 dnn_use_bn=False, task="binary"):
        def cin_factory(field_num, gen):
            common = dict(
                field_size=field_num, embedding_size=embedding_size,
                layer_size=cin_layer_size, activation=cin_activation,
                split_half=cin_split_half, num_heads=cin_num_heads,
                attn_dropout=cin_attn_dropout, use_layer_norm=cin_use_layer_norm,
                use_residual=cin_use_residual, seed=seed, generator=gen,
            )
            if version == 1:
                cin = CINAttention(**common)
                return cin, cin.featuremap_num
            return CINAttentionV2(num_attn_layers=cin_num_attn_layers, **common), embedding_size

        super().__init__(
            linear_cols, dnn_cols, schema, dnn_hidden_units=dnn_hidden_units,
            cin_layer_size=cin_layer_size, cin_split_half=cin_split_half,
            cin_activation=cin_activation, init_std=init_std, seed=seed,
            dnn_dropout=dnn_dropout, dnn_activation=dnn_activation, dnn_use_bn=dnn_use_bn,
            task=task, cin_factory=cin_factory,
        )


class _XDeepFMAttnBase(BaseModel):
    _version = 1

    def __init__(
        self, linear_feature_columns, dnn_feature_columns,
        dnn_hidden_units=(256, 256), cin_layer_size=(256, 128),
        cin_split_half=True, cin_activation="relu", cin_num_heads=4,
        cin_attn_dropout=0.0, cin_use_layer_norm=True, cin_use_residual=True,
        cin_num_attn_layers=1, l2_reg_linear=0.00001, l2_reg_embedding=0.00001,
        l2_reg_dnn=0, l2_reg_cin=0, init_std=0.0001, seed=1024, dnn_dropout=0,
        dnn_activation="relu", dnn_use_bn=False, task="binary", device=None,
        gpus=None,
    ):
        super().__init__(
            linear_feature_columns, dnn_feature_columns,
            l2_reg_linear=l2_reg_linear, l2_reg_embedding=l2_reg_embedding,
            init_std=init_std, seed=seed, task=task, device=device, gpus=gpus,
        )
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.cin_layer_size = tuple(cin_layer_size)
        self.cin_split_half = cin_split_half
        self.cin_activation = cin_activation
        self.cin_num_heads = cin_num_heads
        self.cin_attn_dropout = cin_attn_dropout
        self.cin_use_layer_norm = cin_use_layer_norm
        self.cin_use_residual = cin_use_residual
        self.cin_num_attn_layers = cin_num_attn_layers
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        if len(dnn_feature_columns) > 0 and len(self.dnn_hidden_units) > 0:
            self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
            self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        if len(self.cin_layer_size) > 0 and len(dnn_feature_columns) > 0:
            # every 'weight' of the reference's cin.named_parameters()
            # (xdeepfm_attn.py:126-129): the conv kernels and every
            # cin/.../kernel (projections, pooling, output_proj)
            self.add_regularization_weight(("cin/", "conv_w"), l2=l2_reg_cin)
            self.add_regularization_weight(("cin/", "/kernel"), l2=l2_reg_cin)
        self._finalize()

    def _get_embedding_size(self, feature_columns):
        """The first sparse feature's dim, default 4 (``xdeepfm_attn.py:151``)."""
        for feat in feature_columns:
            if isinstance(feat, (SparseFeat, VarLenSparseFeat)):
                return feat.embedding_dim
        return 4

    def _build_module(self):
        return XDeepFMAttnModule(
            linear_cols=self.linear_feature_columns,
            dnn_cols=self.dnn_feature_columns,
            schema=self.schema,
            embedding_size=self._get_embedding_size(self.dnn_feature_columns),
            version=self._version,
            dnn_hidden_units=self.dnn_hidden_units,
            cin_layer_size=self.cin_layer_size,
            cin_split_half=self.cin_split_half,
            cin_activation=self.cin_activation,
            cin_num_heads=self.cin_num_heads,
            cin_attn_dropout=self.cin_attn_dropout,
            cin_use_layer_norm=self.cin_use_layer_norm,
            cin_use_residual=self.cin_use_residual,
            cin_num_attn_layers=self.cin_num_attn_layers,
            init_std=self.init_std,
            seed=self.seed,
            dnn_dropout=self.dnn_dropout,
            dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn,
            task=self.task,
        )


class xDeepFMAttention(_XDeepFMAttnBase):
    """V1: attention-pooled CIN projected back to featuremap_num
    (``xdeepfm_attn.py:185``).  ``device=None`` means "cuda"."""

    _version = 1


class xDeepFMAttentionV2(_XDeepFMAttnBase):
    """V2: stacked MHSA blocks, CIN output width = embedding size
    (``xdeepfm_attn.py:192``).  ``device=None`` means "cuda"."""

    _version = 2
