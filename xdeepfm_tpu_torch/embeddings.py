"""Embedding tables + input plumbing (port of ``xdeepfm_tpu/embeddings.py``).

Tables that share an embedding dim are stacked into one ``table_d{dim}``
[sum_vocab, dim] parameter, so a batch's sparse lookup is one gather of
``ids + row_offsets`` (the reference instead keeps one ``nn.Embedding`` per
feature, ``deepctr/inputs.py:158-180``).

Semantics preserved: shared tables via ``embedding_name`` (features with the
same name index the same rows), init normal(std=init_std)
(``inputs.py:177-178``), the linear variant forces dim=1 (``inputs.py:168``).
Varlen (sequence) lookups arrive with the sequence models.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .features import FeatureSchema, SparseFeat, split_columns


def _table_layout(feature_columns, linear: bool):
    """Static layout: embedding_name -> (table_dim, row_offset); plus per-dim
    table total rows.  Offsets follow each embedding_name's first
    appearance."""
    sp, _, vl = split_columns(feature_columns)
    name_specs = {}  # embedding_name -> (vocab, dim), first occurrence wins
    order = []
    for f in list(sp) + list(vl):
        dim = 1 if linear else f.embedding_dim
        if f.embedding_name not in name_specs:
            name_specs[f.embedding_name] = (f.vocabulary_size, dim)
            order.append(f.embedding_name)
    table_rows: Dict[int, int] = {}
    offsets: Dict[str, Tuple[int, int]] = {}  # emb_name -> (dim, offset)
    for name in order:
        vocab, dim = name_specs[name]
        off = table_rows.get(dim, 0)
        offsets[name] = (dim, off)
        table_rows[dim] = off + vocab
    return offsets, table_rows


def _require_no_varlen(feature_columns):
    if split_columns(feature_columns)[2]:
        raise NotImplementedError(
            "VarLenSparseFeat lookups arrive with the sequence-model port"
        )


def fused_gather(tables: Sequence[torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """One gather serving several same-layout stacked tables (identical row
    count and id pattern, e.g. the main ``table_d10`` and the linear
    ``table_d1``): rows of their column concat, [N, sum(dims)].  Counterpart
    of ``embeddings.fused_gather`` (``embeddings.py:394-427``); its backward
    is autograd's, one dense scatter-add (``index_select``'s) into the concat,
    split per table, as the JAX ``custom_vjp`` does."""
    return torch.cat(tuple(tables), dim=1).index_select(0, ids)


class EmbeddingCollection(nn.Module):
    """Stacked embedding tables over a feature-column list; parameters are
    ``table_d{dim}`` as in the JAX parameter paths."""

    def __init__(
        self,
        feature_columns,
        schema: FeatureSchema,
        linear: bool = False,
        init_std: float = 1e-4,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _require_no_varlen(feature_columns)
        self.feature_columns = tuple(feature_columns)
        self.schema = schema
        self._offsets, table_rows = _table_layout(feature_columns, linear)
        for dim, rows in sorted(table_rows.items()):
            t = torch.empty(rows, dim).normal_(0.0, init_std, generator=generator)
            self.register_parameter(f"table_d{dim}", nn.Parameter(t))

    def table(self, dim: int) -> torch.Tensor:
        return getattr(self, f"table_d{dim}")

    def sparse_ids(self, batch, feats: Sequence[SparseFeat]):
        """(dim, ids [B, F]) for a set of equal-dim SparseFeats: each
        feature's batch column plus its table's row offset."""
        dims = {self._offsets[f.embedding_name][0] for f in feats}
        if len(dims) != 1:
            raise ValueError("stacked lookups require a uniform embedding dim")
        cols = [self.schema.sparse_index(f.name) for f in feats]
        offs = torch.tensor(
            [self._offsets[f.embedding_name][1] for f in feats],
            dtype=torch.int64, device=batch["sparse"].device,
        )
        return dims.pop(), batch["sparse"][:, cols].long() + offs[None, :]

    def stacked_sparse(self, batch, feats: Sequence[SparseFeat], rows=None):
        """One gather for a set of equal-dim SparseFeats -> [B, F, dim].
        ``rows``: this lookup's [B*F, dim] rows when a fused gather over
        several tables already fetched them."""
        dim, ids = self.sparse_ids(batch, feats)
        B, F = ids.shape
        if rows is None:
            rows = self.table(dim).index_select(0, ids.reshape(-1))
        return rows.reshape(B, F, dim)

    def stacked_inputs(self, batch, feature_columns=None, support_dense=True,
                       rows=None):
        """(sparse_stack [B, F, D] | None, dense [B, Dd] | None) with ONE
        gather for all sparse features (``stacked_sparse``'s ``rows`` may
        carry it in)."""
        cols = self.feature_columns if feature_columns is None else feature_columns
        _require_no_varlen(cols)
        sp, de, _ = split_columns(cols)
        if not support_dense and len(de) > 0:
            raise ValueError("DenseFeat is not supported in dnn_feature_columns")
        sparse_stack = self.stacked_sparse(batch, sp, rows) if sp else None
        dense = None
        if de:
            dense = torch.cat(
                [batch["dense"][:, slice(*self.schema.dense_slice(f.name))] for f in de],
                dim=-1,
            )
        return sparse_stack, dense


def _id_layout(collection: EmbeddingCollection, feats):
    """((batch column, row offset) per feature, table rows) for a uniform-dim
    lookup, else None: two collections with equal layouts gather equal ids."""
    dims = {collection._offsets[f.embedding_name][0] for f in feats}
    if len(dims) != 1:
        return None
    cols = tuple(
        (collection.schema.sparse_index(f.name), collection._offsets[f.embedding_name][1])
        for f in feats
    )
    return cols, collection.table(dims.pop()).shape[0]


def can_fuse_lookup(main: EmbeddingCollection, linear: "LinearModel", feats) -> bool:
    """Whether the main and linear tables index ``feats`` with identical row
    offsets, as when both column lists hold the same sparse features: then
    one gather through their column concat serves both (the JAX engine's
    fused lookup, ``basemodel.py:634-660``)."""
    lin_sp = split_columns(linear.feature_columns)[0]
    layout = _id_layout(main, feats) if feats else None
    return layout is not None and layout == _id_layout(linear.embedding_dict, lin_sp)


def lookup_inputs(main: EmbeddingCollection, linear: "LinearModel", batch, feature_columns,
                  fused: bool):
    """(sparse_stack [B, F, D] | None, dense [B, Dd] | None, the linear
    table's [B*F, 1] rows | None): with ``fused`` (see
    :func:`can_fuse_lookup`) one :func:`fused_gather` fetches the main and
    linear rows, else the main lookup gathers alone and the linear model
    gathers its own."""
    main_rows = lin_rows = None
    if fused:
        dim, ids = main.sparse_ids(batch, split_columns(feature_columns)[0])
        rows = fused_gather((main.table(dim), linear.embedding_dict.table_d1), ids.reshape(-1))
        main_rows, lin_rows = rows[:, :dim], rows[:, dim:]
    sparse_stack, dense = main.stacked_inputs(batch, feature_columns, rows=main_rows)
    return sparse_stack, dense, lin_rows


def combined_dnn_input(sparse_embedding_list, dense_value_list):
    """Flatten + concat (reference ``inputs.py:126-138``): the sparse part in
    (field, dim) order, then the dense values."""
    if len(sparse_embedding_list) > 0 and len(dense_value_list) > 0:
        sp = torch.cat(sparse_embedding_list, dim=-1)
        sp = sp.reshape(sp.shape[0], -1)
        de = torch.cat(dense_value_list, dim=-1)
        return torch.cat([sp, de], dim=-1)
    elif len(sparse_embedding_list) > 0:
        sp = torch.cat(sparse_embedding_list, dim=-1)
        return sp.reshape(sp.shape[0], -1)
    elif len(dense_value_list) > 0:
        return torch.cat(dense_value_list, dim=-1)
    raise NotImplementedError


class LinearModel(nn.Module):
    """First-order term (reference ``basemodel.py:34-92``): 1-dim embeddings
    summed + a dense matmul.  Parameters: ``embedding_dict.table_d1`` and
    ``weight`` [dense_dim, 1]."""

    def __init__(
        self,
        feature_columns,
        schema: FeatureSchema,
        init_std: float = 1e-4,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.feature_columns = tuple(feature_columns)
        self.schema = schema
        self.embedding_dict = EmbeddingCollection(
            feature_columns, schema, linear=True, init_std=init_std,
            generator=generator,
        )
        _, de, _ = split_columns(self.feature_columns)
        dense_dim = sum(f.dimension for f in de)
        if dense_dim > 0:
            w = torch.empty(dense_dim, 1).normal_(0.0, init_std, generator=generator)
            self.weight = nn.Parameter(w)

    def forward(self, batch, sparse_rows=None, sparse_feat_refine_weight=None):
        """[B, 1] logits.  ``sparse_rows``: the sparse features' [B*F, 1]
        table rows when a fused gather already fetched them.
        ``sparse_feat_refine_weight`` [B, F] (IFM / DIFM) multiplies the
        per-field logits before their sum."""
        sp, de, _ = split_columns(self.feature_columns)
        out = None
        if sp:
            logits = self.embedding_dict.stacked_sparse(batch, sp, sparse_rows)[:, :, 0]
            if sparse_feat_refine_weight is not None:
                logits = logits * sparse_feat_refine_weight
            out = logits.sum(dim=-1, keepdim=True)
        if de:
            dense_vals = torch.cat(
                [batch["dense"][:, slice(*self.schema.dense_slice(f.name))] for f in de],
                dim=-1,
            )
            d = dense_vals @ self.weight
            out = d if out is None else out + d
        if out is None:
            v = next(iter(batch.values()))
            return torch.zeros((v.shape[0], 1), device=v.device)
        return out
