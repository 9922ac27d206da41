"""xDeepFM-Pro: xDeepFM + SFG + optional AutoDis (port of
``xdeepfm_tpu/pro/xdeepfm_pro.py``; reference
``deepctr/xdeepfm_pro/xdeepfm_pro.py:31-393``, ``basemodel_sfg.py:96-677``).

The engine passes ``labels`` and ``sample_mask`` in the training batch and
publishes a module's ``logs``, so xDeepFMPro is a module and its weights:
the SFG loss is an ``aux_loss`` added to the step's loss (only when
training), and ``sfg_loss`` reaches the epoch logs and ``History``.
Evaluation, prediction and ``Scorer`` pass no labels, so the decoder does not
run there.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..basemodel import BaseModel
from ..embeddings import EmbeddingCollection, LinearModel, fused_gather
from ..features import SparseFeat, compute_input_dim, split_columns
from ..models.xdeepfm import _id_layout
from ..nn.core import DNN, PredictionLayer, torch_linear_init
from ..nn.interaction import CIN, cin_featuremap_num
from .autodis import DenseFeatureEncoder
from .sfg import SFGDecoder, sfg_loss, sfg_loss_rows

# sfg_fused_ce="auto" off the card: the materialised heads unless their
# per-step logits (B * sum(vocab) fp32) exceed this, then the remat path
# (the JAX package's rule off the TPU, xdeepfm_pro.py:196-213)
_MATERIALIZED_LOGITS_MAX_BYTES = 8 * 1024**3


class XDeepFMProModule(nn.Module):
    """Parameters follow the JAX paths: ``embedding_dict``, ``linear_model``,
    ``cin``, ``cin_linear``, ``dnn``, ``dnn_linear``, ``autodis_encoder``,
    ``sfg_decoder``, ``out``."""

    def __init__(self, linear_cols, dnn_cols, schema, embedding_dim,
                 dnn_hidden_units=(256, 256), cin_layer_size=(256, 128), cin_split_half=True,
                 cin_activation="relu", l2_reg_cin=0.0, init_std=1e-4, seed=1024,
                 dnn_dropout=0.0, dnn_activation="relu", dnn_use_bn=False, task="binary",
                 use_sfg=True, sfg_weight=0.1, sfg_hidden_units=(128, 64), sfg_dropout=0.1,
                 sfg_positive_only=True, sfg_use_label_attention=True, sfg_fused_ce="auto",
                 use_autodis=False, autodis_buckets=16, autodis_temperature=1.0):
        super().__init__()
        if sfg_fused_ce not in ("auto", "pallas", True, False):
            raise ValueError(f"sfg_fused_ce must be 'auto', 'pallas', True or False, "
                             f"got {sfg_fused_ce!r}")
        gen = torch.Generator().manual_seed(seed)
        self.dnn_cols = tuple(dnn_cols)
        self.schema = schema
        self.embedding_dict = EmbeddingCollection(self.dnn_cols, schema, init_std=init_std,
                                                  generator=gen)
        self.linear_model = LinearModel(linear_cols, schema, init_std=init_std, generator=gen)
        sp, de, vl = split_columns(self.dnn_cols)
        self._sparse, self._dense = sp, de
        self.use_dnn = len(self.dnn_cols) > 0 and len(dnn_hidden_units) > 0
        self.use_cin = len(cin_layer_size) > 0 and len(self.dnn_cols) > 0
        self.use_sfg = use_sfg
        self.use_autodis = use_autodis
        self.sfg_weight = sfg_weight
        self.sfg_positive_only = sfg_positive_only
        self.sfg_fused_ce = sfg_fused_ce

        if (self.use_cin or use_sfg) and len(sp) + len(vl) == 0:
            raise ValueError(
                "xDeepFMPro needs at least one sparse/varlen feature in dnn_feature_columns: "
                "CIN and the SFG decoder operate on the embedding stack"
            )
        dense_dim = sum(f.dimension for f in de)
        if use_autodis and any(f.dimension != 1 for f in de):
            raise ValueError(
                "AutoDis bucketizes SCALAR dense features; DenseFeat with dimension > 1 is "
                "not supported with use_autodis=True (reference autodis.py has the same "
                "per-value assumption)"
            )
        autodis_dim = 0
        if use_autodis and de:
            self.autodis_encoder = DenseFeatureEncoder(
                len(de), embedding_dim, use_autodis=True, num_buckets=autodis_buckets,
                temperature=autodis_temperature, generator=gen,
            )
            autodis_dim = self.autodis_encoder.get_output_dim()
        if self.use_dnn:
            dnn_input_dim = compute_input_dim(self.dnn_cols) - (dense_dim if autodis_dim else 0)
            self.dnn = DNN(dnn_input_dim + autodis_dim, dnn_hidden_units,
                           activation=dnn_activation, dropout_rate=dnn_dropout,
                           use_bn=dnn_use_bn, init_std=init_std, generator=gen)
            self.dnn_linear = nn.Linear(dnn_hidden_units[-1], 1, bias=False)
            torch_linear_init(self.dnn_linear.weight, gen)
        if self.use_cin:
            self.cin = CIN(len(sp) + len(vl), cin_layer_size, activation=cin_activation,
                           split_half=cin_split_half, l2_reg=l2_reg_cin, generator=gen)
            self.cin_linear = nn.Linear(cin_featuremap_num(cin_layer_size, cin_split_half), 1,
                                        bias=False)
            torch_linear_init(self.cin_linear.weight, gen)
        if use_sfg:
            self.sfg_decoder = SFGDecoder(
                embedding_dim, tuple((f.name, f.vocabulary_size) for f in sp),
                num_dense=dense_dim, hidden_units=sfg_hidden_units, dropout_rate=sfg_dropout,
                use_label_aware_attention=sfg_use_label_attention,
                num_fields=len(sp) + len(vl), generator=gen,
            )
        self.out = PredictionLayer(task=task)
        # one gather through the main and linear tables where their id
        # layouts agree (as models/xdeepfm.py)
        lin_sp = split_columns(self.linear_model.feature_columns)[0]
        layout = _id_layout(self.embedding_dict, sp) if sp else None
        self._fused = layout is not None and layout == _id_layout(
            self.linear_model.embedding_dict, lin_sp
        )

    def _sfg_impl(self, B, device):
        """"pallas" (the kernel route), "remat" or "materialized"."""
        fused = self.sfg_fused_ce
        if fused == "auto":
            if device.type == "cuda":
                return "pallas"
            vocab = sum(v for _, v in self.sfg_decoder.sparse_vocab_sizes)
            fused = 4 * B * vocab > _MATERIALIZED_LOGITS_MAX_BYTES
        if fused == "pallas":
            return "pallas"
        return "remat" if fused else "materialized"

    def forward(self, batch, training: bool = False, generator=None):
        """``batch``: typed tensors (``sparse`` int [B, F], ``dense`` f32, and
        in training ``labels`` [B, 1] and ``sample_mask`` [B]).  Returns
        ``{"pred": [B, 1]}``, plus ``aux_loss`` and ``logs`` when training
        with labels."""
        main_rows = lin_rows = None
        if self._fused:
            dim, ids = self.embedding_dict.sparse_ids(batch, self._sparse)
            rows = fused_gather(
                (self.embedding_dict.table(dim), self.linear_model.embedding_dict.table_d1),
                ids.reshape(-1),
            )
            main_rows, lin_rows = rows[:, :dim], rows[:, dim:]
        sparse_stack, dense_vals = self.embedding_dict.stacked_inputs(
            batch, self.dnn_cols, rows=main_rows
        )
        final_logit = self.linear_model(batch, sparse_rows=lin_rows)
        if self.use_cin:
            final_logit = final_logit + self.cin_linear(self.cin(sparse_stack, training=training))
        if self.use_dnn:
            parts = [sparse_stack.reshape(sparse_stack.shape[0], -1)]
            if dense_vals is not None:
                if self.use_autodis and self._dense:
                    parts.append(self.autodis_encoder(dense_vals)[0])
                else:
                    parts.append(dense_vals)
            dnn_out = self.dnn(torch.cat(parts, dim=-1), training=training, generator=generator)
            final_logit = final_logit + self.dnn_linear(dnn_out)
        out = {"pred": self.out(final_logit)}

        labels = batch.get("labels")
        if self.use_sfg and labels is not None:
            B = sparse_stack.shape[0]
            sparse_targets = {
                f.name: batch["sparse"][:, self.schema.sparse_index(f.name)] for f in self._sparse
            }
            dv = dense_vals if dense_vals is not None else sparse_stack.new_zeros((B, 0))
            sample_mask = batch.get("sample_mask")
            impl = self._sfg_impl(B, sparse_stack.device)
            if impl == "materialized":
                sparse_logits, dense_preds = self.sfg_decoder(
                    sparse_stack, dv, labels, training=training, generator=generator
                )
                loss = sfg_loss(sparse_logits, dense_preds, sparse_targets, dv, labels,
                                sample_mask=sample_mask, positive_only=self.sfg_positive_only)
            else:
                # the loss's per-row weights (positive mask x the padded
                # tail's sample mask): on the kernel route the rows they zero
                # are sorted out and skipped; only worth it under positive_only
                row_mask = None
                if impl == "pallas" and self.sfg_positive_only:
                    row_mask = (labels.reshape(-1) == 1).float()
                    if sample_mask is not None:
                        row_mask = row_mask * sample_mask.reshape(-1)
                ll_rows, dense_preds = self.sfg_decoder.ce_rows(
                    sparse_stack, dv, sparse_targets, labels, training=training, impl=impl,
                    row_mask=row_mask, generator=generator,
                )
                loss = sfg_loss_rows(ll_rows, dense_preds, dv, labels, sample_mask=sample_mask,
                                     positive_only=self.sfg_positive_only)
            if training:
                out["aux_loss"] = self.sfg_weight * loss
                out["logs"] = {"sfg_loss": loss}
        return out


class xDeepFMPro(BaseModel):
    """Drop-in equivalent of the reference xDeepFMPro
    (``xdeepfm_pro.py:31-393``).  ``device=None`` means "cuda"."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 dnn_hidden_units=(256, 256), cin_layer_size=(256, 128), cin_split_half=True,
                 cin_activation="relu", l2_reg_linear=0.00001, l2_reg_embedding=0.00001,
                 l2_reg_dnn=0, l2_reg_cin=0, init_std=0.0001, seed=1024, dnn_dropout=0,
                 dnn_activation="relu", dnn_use_bn=False, task="binary", device=None, gpus=None,
                 use_sfg=True, sfg_weight=0.1, sfg_hidden_units=(128, 64), sfg_dropout=0.1,
                 sfg_positive_only=True, sfg_use_label_attention=True, sfg_fused_ce="auto",
                 use_autodis=False, autodis_buckets=16, autodis_temperature=1.0):
        super().__init__(
            linear_feature_columns, dnn_feature_columns, l2_reg_linear=l2_reg_linear,
            l2_reg_embedding=l2_reg_embedding, init_std=init_std, seed=seed, task=task,
            device=device, gpus=gpus,
        )
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.cin_layer_size = tuple(cin_layer_size)
        self.cin_split_half = cin_split_half
        self.cin_activation = cin_activation
        self.dnn_dropout = dnn_dropout
        self.dnn_activation = dnn_activation
        self.dnn_use_bn = dnn_use_bn
        self.use_sfg = use_sfg
        self.sfg_weight = sfg_weight
        self.sfg_hidden_units = tuple(sfg_hidden_units)
        self.sfg_dropout = sfg_dropout
        self.sfg_positive_only = sfg_positive_only
        self.sfg_use_label_attention = sfg_use_label_attention
        self.sfg_fused_ce = sfg_fused_ce
        self.use_autodis = use_autodis
        self.autodis_buckets = autodis_buckets
        self.autodis_temperature = autodis_temperature
        self._l2_reg_cin = l2_reg_cin
        # reg registrations mirror xdeepfm_tpu/pro/xdeepfm_pro.py:298-302
        if len(dnn_feature_columns) > 0 and len(self.dnn_hidden_units) > 0:
            self.add_regularization_weight(("dnn/", "/kernel"), l2=l2_reg_dnn)
            self.add_regularization_weight(("dnn_linear/",), l2=l2_reg_dnn)
        if len(self.cin_layer_size) > 0 and len(dnn_feature_columns) > 0:
            self.add_regularization_weight(("cin/", "conv_w"), l2=l2_reg_cin)
        self._finalize()

    @property
    def embedding_dim(self):
        sp = [f for f in self.dnn_feature_columns if isinstance(f, SparseFeat)]
        return sp[0].embedding_dim if sp else 8

    def _build_module(self):
        return XDeepFMProModule(
            linear_cols=self.linear_feature_columns, dnn_cols=self.dnn_feature_columns,
            schema=self.schema, embedding_dim=self.embedding_dim,
            dnn_hidden_units=self.dnn_hidden_units, cin_layer_size=self.cin_layer_size,
            cin_split_half=self.cin_split_half, cin_activation=self.cin_activation,
            l2_reg_cin=self._l2_reg_cin, init_std=self.init_std, seed=self.seed,
            dnn_dropout=self.dnn_dropout, dnn_activation=self.dnn_activation,
            dnn_use_bn=self.dnn_use_bn, task=self.task, use_sfg=self.use_sfg,
            sfg_weight=self.sfg_weight, sfg_hidden_units=self.sfg_hidden_units,
            sfg_dropout=self.sfg_dropout, sfg_positive_only=self.sfg_positive_only,
            sfg_use_label_attention=self.sfg_use_label_attention,
            sfg_fused_ce=self.sfg_fused_ce, use_autodis=self.use_autodis,
            autodis_buckets=self.autodis_buckets, autodis_temperature=self.autodis_temperature,
        )

    def get_embedding_analysis(self, x):
        """Embedding collapse diagnostics (reference ``xdeepfm_pro.py:281-322``)."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in self._pack_x(x).items()}
        with torch.inference_mode():
            stack, _ = self.module.embedding_dict.stacked_inputs(batch, self.module.dnn_cols)
        all_embeddings = stack.cpu().numpy()
        flat = all_embeddings.reshape(all_embeddings.shape[0], -1)
        normalized = flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-8)
        sim = normalized @ normalized.T
        n = sim.shape[0]
        return {
            "mean_embedding": all_embeddings.mean(axis=0),
            "std_embedding": all_embeddings.std(axis=0, ddof=1),
            "embedding_variance": float(all_embeddings.var(axis=0, ddof=1).mean()),
            "avg_sample_cosine_similarity": float((sim.sum() - np.trace(sim)) / (sim.size - n)),
            "num_fields": all_embeddings.shape[1],
            "embedding_dim": all_embeddings.shape[2],
        }


class xDeepFMProLight(xDeepFMPro):
    """Smaller defaults (reference ``xdeepfm_pro.py:325-393``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 dnn_hidden_units=(128, 64), cin_layer_size=(128, 64), **kwargs):
        kwargs.setdefault("sfg_weight", 0.05)
        kwargs.setdefault("sfg_hidden_units", (64, 32))
        kwargs.setdefault("autodis_buckets", 8)
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         dnn_hidden_units=dnn_hidden_units, cin_layer_size=cin_layer_size,
                         **kwargs)
