"""Supervised Feature Generation (port of ``xdeepfm_tpu/pro/sfg.py``;
reference ``deepctr/xdeepfm_pro/sfg_decoder.py``).

A decoder reconstructs the input features from their embeddings under a
label-aware, positive-masked reconstruction loss (SURVEY.md §0).  Parameter
paths follow the JAX package: ``label_attention/{label_embedding, att1,
att2}``, ``shared_{i}``, ``head_{name}``, ``dense_head``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.core import dropout, torch_bias_init, torch_linear_init
from ..ops import ce
from ..parallel.mesh import batch_ranks, batch_sum


def _linear(n_in, n_out, generator):
    """``nn.Linear`` with torch's default init drawn from ``generator``."""
    lin = nn.Linear(n_in, n_out)
    torch_linear_init(lin.weight, generator)
    torch_bias_init(lin.bias, n_in, generator)
    return lin


class LabelAwareAttention(nn.Module):
    """Sigmoid gate over the decoder input conditioned on the binary label
    (reference ``sfg_decoder.py:160-206``)."""

    def __init__(self, input_dim: int, hidden_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.label_embedding = nn.Parameter(
            torch.empty(2, hidden_dim).normal_(0.0, 1.0, generator=gen)
        )
        self.att1 = _linear(input_dim + hidden_dim, hidden_dim, gen)
        self.att2 = _linear(hidden_dim, input_dim, gen)

    def forward(self, x, labels):
        # a [B, 2] one-hot product, as the JAX package selects the label row
        # (jax.nn.one_hot: an id outside {0, 1} selects no row)
        ids = labels.reshape(-1, 1).long()
        onehot = (ids == torch.arange(2, device=ids.device)).to(self.label_embedding.dtype)
        combined = torch.cat([x, onehot @ self.label_embedding], dim=-1)
        return torch.sigmoid(self.att2(torch.relu(self.att1(combined))))


def _ce_of_logits(logits, targets):
    picked = logits.gather(1, targets.long().reshape(-1, 1)).reshape(-1)
    return torch.logsumexp(logits, dim=-1) - picked


def _head_ce_rows(head, h, targets):
    """Per-row cross-entropy of one vocabulary-sized softmax head from the
    shared hidden state (materialises the head's [B, V] logits)."""
    return _ce_of_logits(head(h), targets)


class SFGDecoder(nn.Module):
    """Shared MLP -> one softmax head per sparse feature + one dense regression
    head (reference ``sfg_decoder.py:19-157``).

    Input: sparse embeddings [B, F, E], dense values [B, D], labels [B, 1].
    ``forward`` returns (sparse logits by name, dense predictions [B, D]);
    the training path uses :meth:`ce_rows`.  ``ce_backend`` (None: by device,
    or "torch") goes to the fused CE of the kernel route.
    """

    def __init__(self, embedding_dim: int, sparse_vocab_sizes: Sequence[Tuple[str, int]],
                 num_dense: int, hidden_units: Sequence[int] = (128, 64),
                 dropout_rate: float = 0.1, use_label_aware_attention: bool = True,
                 num_fields: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.sparse_vocab_sizes = tuple(sparse_vocab_sizes)
        self.num_dense = num_dense  # dense WIDTH (sum of DenseFeat dimensions)
        self.hidden_units = tuple(hidden_units)
        self.dropout_rate = dropout_rate
        self.use_label_aware_attention = use_label_aware_attention
        self.ce_backend = None
        fields = num_fields if num_fields is not None else len(self.sparse_vocab_sizes)
        input_dim = fields * embedding_dim + num_dense
        if use_label_aware_attention:
            self.label_attention = LabelAwareAttention(
                input_dim, self.hidden_units[0] if self.hidden_units else 64, gen
            )
        prev = input_dim
        for i, units in enumerate(self.hidden_units):
            self.add_module(f"shared_{i}", _linear(prev, units, gen))
            prev = units
        for name, vocab in self.sparse_vocab_sizes:
            self.add_module(f"head_{name}", _linear(prev, vocab, gen))
        if num_dense > 0:
            self.dense_head = _linear(prev, num_dense, gen)

    def head(self, name: str) -> nn.Linear:
        return getattr(self, f"head_{name}")

    def hidden(self, sparse_embeddings, dense_values, labels=None, training: bool = False,
               generator=None):
        """Shared trunk: concat -> optional label-aware gate -> MLP; dropout
        masks from ``generator`` when ``training``."""
        B = sparse_embeddings.shape[0]
        h = torch.cat([sparse_embeddings.reshape(B, -1), dense_values], dim=-1)
        if self.use_label_aware_attention and labels is not None:
            h = h * self.label_attention(h, labels)
        for i in range(len(self.hidden_units)):
            h = torch.relu(getattr(self, f"shared_{i}")(h))
            if training:
                h = dropout(h, self.dropout_rate, generator)
        return h

    def _dense_preds(self, h):
        if self.num_dense > 0:
            return self.dense_head(h)
        return h.new_zeros((h.shape[0], 0))

    def forward(self, sparse_embeddings, dense_values, labels=None, training: bool = False,
                generator=None):
        h = self.hidden(sparse_embeddings, dense_values, labels, training, generator)
        logits = {name: self.head(name)(h) for name, _ in self.sparse_vocab_sizes}
        return logits, self._dense_preds(h)

    def ce_rows(self, sparse_embeddings, dense_values, sparse_targets, labels=None,
                training: bool = False, impl: str = "remat", row_mask=None, generator=None):
        """Heads fused with their cross-entropy: ({name: per-row -log p(target)},
        dense predictions).

        ``impl``: "materialized" keeps each head's [B, V] logits for the
        backward; "remat" recomputes them there (``torch.utils.checkpoint``);
        "pallas" (the JAX package's name) is the kernel route, the fused CE of
        ``ops/ce.py``, taken when its shape gate ``ce.fits_kernel`` passes and
        "remat" otherwise.  On the kernel route heads are bucketed by
        128-padded vocabulary: a bucket of several heads runs stacked in one
        launch (zero W rows and ``_NEG`` bias pad), a bucket of one head, and
        every head under ``ce.set_stack_heads(False)``, alone.

        ``row_mask`` (kernel route only): the loss's per-row weights.  Rows
        it zeroes are sorted behind the others and skipped by the kernels;
        their returned values are 0.
        """
        B = sparse_embeddings.shape[0]
        h = self.hidden(sparse_embeddings, dense_values, labels, training, generator)
        if impl == "pallas" and not ce.fits_kernel(B, h.shape[-1]):
            impl = "remat"
        perm = inv = nv = None
        h_k = h
        if impl == "pallas" and row_mask is not None:
            perm, inv, nv = ce.sort_rows_by_mask(row_mask)
            h_k = ce.permute_rows(h, perm, inv)

        def pick_targets(t):
            t = t.reshape(-1)
            return t if perm is None else t.index_select(0, perm)

        def unsort_rows(ll):
            return ll if perm is None else ce.permute_rows(ll, inv, perm)

        ll_rows = {}
        if impl == "pallas" and ce.stack_heads_enabled():
            buckets = {}
            for name, vocab in self.sparse_vocab_sizes:
                buckets.setdefault(-(-vocab // 128) * 128, []).append((name, vocab))
            for vp, items in buckets.items():
                if len(items) == 1:
                    name = items[0][0]
                    head = self.head(name)
                    ll_rows[name] = unsort_rows(ce.fused_ce_rows(
                        h_k, head.weight, head.bias, pick_targets(sparse_targets[name]),
                        num_valid=nv, backend=self.ce_backend,
                    ))
                    continue
                Ws = torch.stack([
                    F.pad(self.head(name).weight, (0, 0, 0, vp - vocab)) for name, vocab in items
                ])
                bs = torch.stack([
                    F.pad(self.head(name).bias, (0, vp - vocab), value=ce._NEG)
                    for name, vocab in items
                ])
                ts = torch.stack([pick_targets(sparse_targets[name]) for name, _ in items])
                ll = ce.fused_ce_rows_stacked(h_k, Ws, bs, ts, num_valid=nv,
                                              backend=self.ce_backend)
                if perm is not None:
                    ll = ce.unpermute_cols(ll, perm, inv)
                for r, (name, _) in enumerate(items):
                    ll_rows[name] = ll[r]
        elif impl == "pallas":
            for name, _ in self.sparse_vocab_sizes:
                head = self.head(name)
                ll_rows[name] = unsort_rows(ce.fused_ce_rows(
                    h_k, head.weight, head.bias, pick_targets(sparse_targets[name]),
                    num_valid=nv, backend=self.ce_backend,
                ))
        else:
            for name, _ in self.sparse_vocab_sizes:
                head, targets = self.head(name), sparse_targets[name].reshape(-1)
                if impl == "materialized":
                    ll_rows[name] = _head_ce_rows(head, h, targets)
                else:
                    ll_rows[name] = checkpoint(_head_ce_rows, head, h, targets,
                                               use_reentrant=False)
        return ll_rows, self._dense_preds(h)


def _positive_mask(labels, sample_mask, positive_only):
    """(per-row loss weights, normaliser) of ``sfg_decoder.py:240-311``."""
    labels = labels.reshape(-1)
    if positive_only:
        pos_mask = (labels == 1).float()
    else:
        pos_mask = torch.ones_like(labels, dtype=torch.float32)
    if sample_mask is not None:
        pos_mask = pos_mask * sample_mask.reshape(-1)
    # on a rank grid the normaliser is the global batch's (mesh.batch_sum)
    if positive_only:
        return pos_mask, batch_sum(pos_mask.sum()) + 1e-8
    if sample_mask is not None:
        return pos_mask, batch_sum(sample_mask.sum())
    return pos_mask, labels.shape[0] * batch_ranks()


def _dense_term(dense_preds, dense_targets, pos_mask, num_positive):
    if dense_preds.shape[-1] == 0:
        return torch.zeros((), device=dense_preds.device)
    mse = ((dense_preds - dense_targets) ** 2).mean(-1)
    return (mse * pos_mask).sum() / num_positive


def sfg_loss(sparse_logits: Dict[str, torch.Tensor], dense_preds, sparse_targets,
             dense_targets, labels, sample_mask=None, positive_only: bool = True,
             sparse_weight: float = 1.0, dense_weight: float = 1.0):
    """Per-feature CE + dense MSE, masked to positive samples and normalised
    by the positive count (reference ``sfg_decoder.py:209-311``);
    ``sample_mask`` also zeroes the engine's padded tail rows."""
    pos_mask, num_positive = _positive_mask(labels, sample_mask, positive_only)
    total_sparse = torch.zeros((), device=dense_preds.device)
    for name, logits in sparse_logits.items():
        ll = _ce_of_logits(logits, sparse_targets[name].reshape(-1))
        total_sparse = total_sparse + (ll * pos_mask).sum() / num_positive
    total_dense = _dense_term(dense_preds, dense_targets, pos_mask, num_positive)
    return sparse_weight * total_sparse + dense_weight * total_dense


def sfg_loss_rows(ll_rows: Dict[str, torch.Tensor], dense_preds, dense_targets, labels,
                  sample_mask=None, positive_only: bool = True, sparse_weight: float = 1.0,
                  dense_weight: float = 1.0):
    """:func:`sfg_loss` with the per-feature CE already reduced to per-row
    values (the :meth:`SFGDecoder.ce_rows` path); the same masking and
    normalisation."""
    pos_mask, num_positive = _positive_mask(labels, sample_mask, positive_only)
    if ll_rows:
        ll_sum = torch.stack(list(ll_rows.values())).sum(0)
        total_sparse = torch.dot(ll_sum, pos_mask) / num_positive
    else:  # dense-only model: no sparse CE heads
        total_sparse = torch.zeros((), device=dense_preds.device)
    total_dense = _dense_term(dense_preds, dense_targets, pos_mask, num_positive)
    return sparse_weight * total_sparse + dense_weight * total_dense


# the reference's class name (``sfg_decoder.py:209-311``); here the loss is a
# function of the decoder's outputs and the targets
SFGLoss = sfg_loss
