"""Embedding tables + input plumbing (port of ``xdeepfm_tpu/embeddings.py``).

Tables that share an embedding dim are stacked into one ``table_d{dim}``
[sum_vocab, dim] parameter, so a batch's sparse lookup is one gather of
``ids + row_offsets`` (the reference instead keeps one ``nn.Embedding`` per
feature, ``deepctr/inputs.py:158-180``).

Semantics preserved: shared tables via ``embedding_name`` (features with the
same name index the same rows), init normal(std=init_std)
(``inputs.py:177-178``), the linear variant forces dim=1 (``inputs.py:168``),
varlen (sequence) fields looked up per position and pooled by their combiner
(``inputs.py:141-155, 213-227``).

Every gather from a table goes through :func:`fused_gather` (or, for a
rank's row shard, the collective lookup of ``parallel.sharded_embedding``),
whose backward is
a fixed-order segment sum over the sorted ids (:func:`sorted_segment_sum`),
not ``index_select``'s atomic scatter-add: two identical steps give
bit-equal table gradients on the card, as the JAX ``.at[].add`` does on its
chip.  Under the lazy optimizer's split gradient no lookup reads a table:
each reads its slice of the step's per-occurrence block (see
:class:`EmbeddingCollection`, :func:`touched_ids`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from .features import FeatureSchema, SparseFeat, VarLenSparseFeat, split_columns
from .nn.sequence import sequence_pool


class MixedEmbeddingDims(ValueError):
    """Raised by the stacked lookups when the feature set spans more than one
    table dim (``embeddings.py:38``); :meth:`EmbeddingCollection.fast_inputs`
    catches exactly this to fall back to the per-feature lists."""


def _table_layout(feature_columns, linear: bool, force_dim: Optional[int] = None):
    """Static layout: embedding_name -> (table_dim, row_offset); plus per-dim
    table total rows.  Offsets follow each embedding_name's first
    appearance.  ``force_dim`` overrides every table's dim
    (``embeddings.py:57-66``)."""
    sp, _, vl = split_columns(feature_columns)
    name_specs = {}  # embedding_name -> (vocab, dim), first occurrence wins
    order = []
    for f in list(sp) + list(vl):
        dim = force_dim if force_dim else (1 if linear else f.embedding_dim)
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


# ---------------------------------------------------------------------------
# Run sums over sorted ids, in an order fixed by the ids alone (no atomics):
# the gather's backward and the lazy optimizer's step give bit-equal sums
# between identical calls on the card.
# ---------------------------------------------------------------------------


def run_prefix_sums(sorted_vals: torch.Tensor, run: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums within runs: ``run`` [N] is nondecreasing and
    equal exactly along a run (the sorted ids themselves, or a count of run
    starts).  A segmented Hillis-Steele scan: step k adds the row k places
    back where it lies in the same run (k = 1, 2, 4, ...), so a run of any
    length (a padding id's ~10^5 rows) takes log2 N whole-tensor steps,
    never a walk by one thread.  A run's last row holds its total, summed
    exactly in fp32 along a fixed tree."""
    x, n, k = sorted_vals, sorted_vals.shape[0], 1
    run = run.reshape(-1, *([1] * (sorted_vals.dim() - 1)))
    while k < n:
        y = x.clone()
        y[k:].addcmul_(x[:-k], run[k:] == run[:-k])
        x, k = y, 2 * k
    return x


def run_first(sorted_ids: torch.Tensor) -> torch.Tensor:
    """[N] bool: the first row of each run of equal sorted ids."""
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    return first


def run_last(sorted_ids: torch.Tensor) -> torch.Tensor:
    """[N] bool: the last row of each run of equal sorted ids."""
    last = torch.ones_like(sorted_ids, dtype=torch.bool)
    last[:-1] = sorted_ids[1:] != sorted_ids[:-1]
    return last


def sorted_segment_sum(values: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """[num_rows, D] zeros with each ``values[k]`` added at row ``ids[k]``,
    summed in an order fixed by the ids alone.  The ids are sorted (stable),
    the rows of each id's run summed by a segmented scan
    (:func:`run_prefix_sums`), and each run's
    last row written once.  No atomics, so the result is bit-equal between
    calls on the card."""
    n, D = values.shape
    out = values.new_zeros(num_rows + 1, D)
    if n == 0:
        return out[:num_rows]
    sorted_ids, order = torch.sort(ids, stable=True)
    x = run_prefix_sums(values.index_select(0, order), sorted_ids)
    # each run's total lands on its id once; every other row on the spare
    # row num_rows, which is dropped
    out.index_put_((torch.where(run_last(sorted_ids), sorted_ids, num_rows),), x)
    return out[:num_rows]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, *tables):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dims = tables[0].shape[0], [t.shape[1] for t in tables]
        # each table's rows, then their concat: never a copy of whole tables
        rows = [t.index_select(0, ids) for t in tables]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = sorted_segment_sum(g.contiguous(), ids, ctx.rows)
        return (None, *grad.split(ctx.dims, dim=1))


def fused_gather(tables: Sequence[torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` [N] of the column concat of one or more same-row-count
    stacked tables (e.g. the main ``table_d10`` and the linear ``table_d1``,
    same id pattern), [N, sum(dims)].  Counterpart of
    ``embeddings.fused_gather`` (``embeddings.py:394-427``); its backward is
    one segment sum into the concat (:func:`sorted_segment_sum`), split per
    table, as the JAX ``custom_vjp``'s one scatter-add."""
    return _GatherRows.apply(ids.reshape(-1).long(), *tables)


def _take(tables: Sequence[torch.Tensor], ids: torch.Tensor, rows: int) -> torch.Tensor:
    """:func:`fused_gather` of ``tables``, whose full row count is
    ``rows``; where they hold fewer, they are a rank's row shards
    (``parallel.shard_model_state``) and the lookup is the collective
    ``parallel.sharded_embedding.maybe_sharded_take`` (the JAX
    ``lookup_ids`` dispatch, ``embeddings.py:143-148``)."""
    if tables[0].shape[0] != rows:
        from .parallel.sharded_embedding import maybe_sharded_take

        return maybe_sharded_take(tuple(tables), ids.reshape(-1))
    return fused_gather(tables, ids)


def table_touched_spec(feature_columns, schema: FeatureSchema, linear: bool,
                       force_dim: Optional[int] = None):
    """Which batch entries index which stacked table:
    ``{dim: [(kind, key, row offset)]}``, kind "sparse" (key: the column of
    ``batch["sparse"]``) or "varlen" (key: the batch key ``vl_<name>``).  The
    lazy optimizer enumerates a step's touched rows from it without running
    the model.  A feature listed twice maps to one batch column (the schema
    dedups names) and so yields one entry: :func:`touched_ids` and the
    occurrence layout both follow this list."""
    offsets, _ = _table_layout(feature_columns, linear, force_dim)
    sp, _, vl = split_columns(feature_columns)
    spec: Dict[int, list] = {}
    seen = set()
    for f in sp:
        dim, off = offsets[f.embedding_name]
        key = ("sparse", schema.sparse_index(f.name))
        if (dim,) + key not in seen:
            seen.add((dim,) + key)
            spec.setdefault(dim, []).append(key + (off,))
    for f in vl:
        dim, off = offsets[f.embedding_name]
        key = ("varlen", "vl_" + f.name)
        if (dim,) + key not in seen:
            seen.add((dim,) + key)
            spec.setdefault(dim, []).append(key + (off,))
    return spec


_DEVICE_LISTS: Dict[Tuple[tuple, str], torch.Tensor] = {}


def _device_list(values, device) -> torch.Tensor:
    """An int64 tensor of ``values`` on ``device``, made once: a tensor
    built from a list each step is a host-to-device copy and a sync."""
    key = (tuple(values), str(device))
    t = _DEVICE_LISTS.get(key)
    if t is None:
        t = _DEVICE_LISTS[key] = torch.tensor(values, dtype=torch.int64, device=device)
    return t


def touched_ids(batch, entries) -> torch.Tensor:
    """The [N] int64 table rows one stacked table's lookups touch in
    ``batch``, for the entry list of :func:`table_touched_spec`.  Batch-major:
    first the plain sparse entries as one [B, F_t] block flattened row by
    row, then each varlen entry's [B, maxlen] block, so the occurrence block
    of a lazy gradient-split step is a reshape away from the [B, F, D] the
    towers read (the layout of ``_occ_layout``)."""
    sp_cols, sp_offs, parts = [], [], []
    for kind, key, off in entries:
        if kind == "sparse":
            sp_cols.append(key)
            sp_offs.append(off)
        else:
            parts.append(batch[key].reshape(-1).long() + off)
    if sp_cols:
        dev = batch["sparse"].device
        ids = batch["sparse"].index_select(1, _device_list(sp_cols, dev)).long()
        parts.insert(0, (ids + _device_list(sp_offs, dev)[None, :]).reshape(-1))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _occ_layout(feature_columns, schema: FeatureSchema, linear: bool,
                force_dim: Optional[int] = None):
    """Per table dim, where each lookup's rows lie in the occurrence block
    that :func:`touched_ids` lays out: ``sparse`` maps a batch column to its
    place on the F_t axis, ``varlen`` a batch key to its offset in units of B
    rows past the block's start, ``n_sparse`` is F_t."""
    vl_maxlen = {"vl_" + f.name: f.maxlen for f in schema.varlen}
    layout = {}
    for dim, entries in table_touched_spec(feature_columns, schema, linear, force_dim).items():
        sparse = {key: i for i, key in enumerate(k for kind, k, _ in entries if kind == "sparse")}
        units, varlen = len(sparse), {}
        for kind, key, _ in entries:
            if kind == "varlen":
                varlen[key] = units
                units += vl_maxlen[key]
        layout[dim] = {"sparse": sparse, "varlen": varlen, "n_sparse": len(sparse)}
    return layout


class _TakeFields(torch.autograd.Function):
    """``x[:, pos]`` over the field axis of [B, F, D], whose backward adds
    a repeated field's gradients in the order of ``pos`` (an index's own
    backward would be an atomic scatter-add, whose order varies on the
    card)."""

    @staticmethod
    def forward(ctx, x, pos_t, pos):
        ctx.n, ctx.pos_t, ctx.pos = x.shape[1], pos_t, pos
        return x.index_select(1, pos_t)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gx = g.new_zeros(g.shape[0], ctx.n, g.shape[2])
        if len(set(ctx.pos)) == len(ctx.pos):
            gx.index_copy_(1, ctx.pos_t, g)  # each field taken once: a copy
        else:
            for f, p in enumerate(ctx.pos):
                gx[:, p] += g[:, f]
        return gx, None, None


class EmbeddingCollection(nn.Module):
    """Stacked embedding tables over a feature-column list; parameters are
    ``table_d{dim}`` as in the JAX parameter paths.

    Every lookup honours a per-occurrence block: where ``batch["_compact"]``
    holds ``f"{self.path}/table_d{dim}"`` (the lazy optimizer's
    gradient-split step), that [N, dim] block, laid out by
    :func:`touched_ids`, stands in for the table, and each lookup is a slice
    of it (the JAX engine's ``_compact`` contract).  ``path`` is the
    collection's parameter path (``embedding_dict``,
    ``linear_model/embedding_dict``), set by the model that owns it.
    ``fused_lookup``: whether the models' lookups may fetch this table's rows
    and the linear table's in one gather (:func:`lookup_inputs`), set by
    ``compile``.  ``force_dim`` overrides every table's dim
    (:class:`MultiLinearModel`)."""

    def __init__(
        self,
        feature_columns,
        schema: FeatureSchema,
        linear: bool = False,
        init_std: float = 1e-4,
        generator: Optional[torch.Generator] = None,
        force_dim: Optional[int] = None,
    ):
        super().__init__()
        self.feature_columns = tuple(feature_columns)
        self.schema = schema
        self.linear = linear
        self.force_dim = force_dim
        self.path = None
        # one gather for this main table and the linear one where they allow
        # it (:func:`can_fuse_lookup`); ``compile(fused_lookup=False)`` clears it
        self.fused_lookup = True
        self._offsets, table_rows = _table_layout(feature_columns, linear, force_dim)
        self._rows = dict(table_rows)  # each table's full row count (a shard holds fewer)
        self._occ_layout = _occ_layout(feature_columns, schema, linear, force_dim)
        for dim, rows in sorted(table_rows.items()):
            t = torch.empty(rows, dim).normal_(0.0, init_std, generator=generator)
            self.register_parameter(f"table_d{dim}", nn.Parameter(t))

    def table(self, dim: int) -> torch.Tensor:
        return getattr(self, f"table_d{dim}")

    def _block(self, batch, dim: int):
        """This table's per-occurrence block in ``batch``, else None."""
        compact = batch.get("_compact")
        if not compact or self.path is None:
            return None
        return compact.get(f"{self.path}/table_d{dim}")

    def _block_sparse(self, batch, occ, dim):
        """The block's plain sparse part as [B, F_t, dim]."""
        n = self._occ_layout[dim]["n_sparse"]
        return occ[: batch["sparse"].shape[0] * n].reshape(-1, n, dim)

    def uniform_dim(self, feature_columns=None):
        """The one table dim of the sparse and varlen features among
        ``feature_columns`` (all of the collection's by default; None if there
        are none).  Raises :class:`MixedEmbeddingDims` where they span more
        than one: the stacked lookups need one."""
        cols = self.feature_columns if feature_columns is None else feature_columns
        sp, _, vl = split_columns(cols)
        dims = {self._offsets[f.embedding_name][0] for f in list(sp) + list(vl)}
        if len(dims) > 1:
            raise MixedEmbeddingDims("stacked lookups require a uniform embedding dim; use "
                                     "embed_inputs for mixed-dim feature sets")
        return dims.pop() if dims else None

    def sparse_ids(self, batch, feats: Sequence[SparseFeat]):
        """(dim, ids [B, F]) for a set of equal-dim SparseFeats: each
        feature's batch column plus its table's row offset."""
        dim = self.uniform_dim(feats)
        cols = [self.schema.sparse_index(f.name) for f in feats]
        offs = torch.tensor(
            [self._offsets[f.embedding_name][1] for f in feats],
            dtype=torch.int64, device=batch["sparse"].device,
        )
        return dim, batch["sparse"][:, cols].long() + offs[None, :]

    def stacked_sparse(self, batch, feats: Sequence[SparseFeat], rows=None):
        """One gather for a set of equal-dim SparseFeats -> [B, F, dim].
        ``rows``: this lookup's [B*F, dim] rows when a fused gather over
        several tables already fetched them."""
        dim = self.uniform_dim(feats)
        occ = self._block(batch, dim)
        if occ is not None:
            occ_sp = self._block_sparse(batch, occ, dim)
            where = self._occ_layout[dim]["sparse"]
            pos = [where[self.schema.sparse_index(f.name)] for f in feats]
            if pos == list(range(occ_sp.shape[1])):
                return occ_sp  # every sparse column in order: a reshape
            return _TakeFields.apply(occ_sp, _device_list(pos, occ.device), tuple(pos))
        dim, ids = self.sparse_ids(batch, feats)
        B, F = ids.shape
        if rows is None:
            rows = _take((self.table(dim),), ids, self._rows[dim])
        return rows.reshape(B, F, dim)

    def field_ids(self, batch, feat) -> torch.Tensor:
        """[B, width] table rows of one field: a SparseFeat's column (width
        1) or a VarLenSparseFeat's positions (width maxlen)."""
        off = self._offsets[feat.embedding_name][1]
        if isinstance(feat, VarLenSparseFeat):
            ids = batch["vl_" + feat.name]
        else:
            i = self.schema.sparse_index(feat.name)
            ids = batch["sparse"][:, i : i + 1]
        return ids.long() + off

    def _block_field(self, batch, occ, dim, feat):
        """One field's [B, width, dim] slice of the occurrence block."""
        lay = self._occ_layout[dim]
        if isinstance(feat, VarLenSparseFeat):
            ids = batch["vl_" + feat.name]
            B, maxlen = ids.shape
            u = lay["varlen"]["vl_" + feat.name]
            return occ[u * B : (u + maxlen) * B].reshape(B, maxlen, dim)
        p = lay["sparse"][self.schema.sparse_index(feat.name)]
        return self._block_sparse(batch, occ, dim)[:, p : p + 1]

    def lookup_fields(self, batch, feats):
        """[B, width, dim] per field of ``feats`` (SparseFeat width 1,
        VarLenSparseFeat width maxlen), in order, with one gather per table."""
        by_dim = {}
        for f in feats:
            by_dim.setdefault(self._offsets[f.embedding_name][0], []).append(f)
        found = {}
        for dim, fs in by_dim.items():
            occ = self._block(batch, dim)
            if occ is not None:
                found.update((f.name, self._block_field(batch, occ, dim, f)) for f in fs)
                continue
            ids = [self.field_ids(batch, f) for f in fs]
            widths = [t.shape[1] for t in ids]
            rows = _take((self.table(dim),), torch.cat(ids, dim=1), self._rows[dim])
            for f, part in zip(fs, rows.reshape(ids[0].shape[0], sum(widths), dim).split(widths, 1)):
                found[f.name] = part
        return [found[f.name] for f in feats]

    def lookup_sparse(self, batch, feat: SparseFeat) -> torch.Tensor:
        """[B, 1, dim] for one SparseFeat (reference ``inputs.py:183-210``)."""
        return self.lookup_fields(batch, [feat])[0]

    def grouped_sparse(self, batch, feats, return_feat_list=()):
        """{group_name: [[B, 1, dim] per feature]} over ``feats`` (those named
        in ``return_feat_list``, when it is not empty), the reference's
        group-keyed lookup (``inputs.py:183-210``), one gather per table."""
        feats = [f for f in feats if len(return_feat_list) == 0 or f.name in return_feat_list]
        groups: Dict[str, list] = {}
        for f, emb in zip(feats, self.lookup_fields(batch, feats)):
            groups.setdefault(f.group_name, []).append(emb)
        return groups

    def lookup_varlen_seq(self, batch, feat: VarLenSparseFeat) -> torch.Tensor:
        """[B, maxlen, dim] sequence embeddings (``inputs.py:213-227``)."""
        return self.lookup_fields(batch, [feat])[0]

    def lookup_varlen_pooled(self, batch, feat: VarLenSparseFeat) -> torch.Tensor:
        """[B, 1, dim] pooled by the feature's combiner (``inputs.py:141-155``)."""
        return self._pool(batch, feat, self.lookup_varlen_seq(batch, feat))

    def _pool(self, batch, feat: VarLenSparseFeat, seq_emb) -> torch.Tensor:
        """``seq_emb`` [B, maxlen, dim] pooled over the positions below
        ``len_<length_name>``, or over the nonzero ids when the feature has
        no length column."""
        if feat.length_name is None:
            mask = batch["vl_" + feat.name] != 0
            return sequence_pool((seq_emb, mask), mode=feat.combiner, supports_masking=True)
        length = batch["len_" + feat.length_name]
        return sequence_pool((seq_emb, length), mode=feat.combiner, supports_masking=False)

    def _dense_values(self, batch, dense_feats):
        return [batch["dense"][:, slice(*self.schema.dense_slice(f.name))] for f in dense_feats]

    def embed_inputs(self, batch, feature_columns=None, support_dense=True):
        """(sparse_embedding_list, dense_value_list), the reference's
        ``input_from_feature_columns`` (``embeddings.py:226-249``): each
        sparse feature's [B, 1, dim] in column order, then each varlen
        feature pooled to [B, 1, dim], and each dense feature's [B, dimension].
        Any mix of dims; one gather per table (:meth:`lookup_fields`)."""
        cols = self.feature_columns if feature_columns is None else feature_columns
        sp, de, vl = split_columns(cols)
        if not support_dense and len(de) > 0:
            raise ValueError("DenseFeat is not supported in dnn_feature_columns")
        fields = self.lookup_fields(batch, list(sp) + list(vl))
        pooled = [self._pool(batch, f, seq) for f, seq in zip(vl, fields[len(sp):])]
        return fields[: len(sp)] + pooled, self._dense_values(batch, de)

    def stacked_inputs(self, batch, feature_columns=None, support_dense=True,
                       rows=None):
        """(sparse_stack [B, F, D] | None, dense [B, Dd] | None) with ONE
        gather for all sparse features (``stacked_sparse``'s ``rows`` may
        carry it in), then each varlen feature pooled, as one more field.
        Raises :class:`MixedEmbeddingDims` unless the sparse and varlen
        features share one table dim (``embeddings.py:267-275``)."""
        cols = self.feature_columns if feature_columns is None else feature_columns
        sp, de, vl = split_columns(cols)
        if not support_dense and len(de) > 0:
            raise ValueError("DenseFeat is not supported in dnn_feature_columns")
        self.uniform_dim(cols)
        parts = [self.stacked_sparse(batch, sp, rows)] if sp else []
        # each varlen field pooled to [B, 1, dim] after the sparse fields
        # (``embeddings.py:280-281``)
        parts += [self.lookup_varlen_pooled(batch, f) for f in vl]
        sparse_stack = torch.cat(parts, dim=1) if parts else None
        dense = torch.cat(self._dense_values(batch, de), dim=-1) if de else None
        return sparse_stack, dense

    def fast_inputs(self, batch, feature_columns=None, support_dense=True, rows=None):
        """(sparse_embedding_list, dense_value_list) as :meth:`embed_inputs`
        gives them, through :meth:`stacked_inputs` (one list entry each)
        when every dim is equal, else :meth:`embed_inputs`
        (``embeddings.py:294-318``).  Only :class:`MixedEmbeddingDims` routes
        to the per-feature lists."""
        try:
            sparse_stack, dense = self.stacked_inputs(batch, feature_columns, support_dense,
                                                      rows)
        except MixedEmbeddingDims:
            return self.embed_inputs(batch, feature_columns, support_dense)
        return ([] if sparse_stack is None else [sparse_stack],
                [] if dense is None else [dense])


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


def _fused_rows(main: EmbeddingCollection, linear: "LinearModel", batch, feature_columns,
                fused: bool):
    """(the main table's [B*F, dim] rows, the linear table's [B*F, 1] rows)
    of the sparse features from one :func:`fused_gather`, or (None, None):
    without ``fused`` (see :func:`can_fuse_lookup`), under
    ``compile(fused_lookup=False)`` (``main.fused_lookup``), and in a lazy
    split step, whose occurrence blocks serve both tables."""
    if not (fused and main.fused_lookup) or "_compact" in batch:
        return None, None
    dim, ids = main.sparse_ids(batch, split_columns(feature_columns)[0])
    rows = _take((main.table(dim), linear.embedding_dict.table_d1), ids.reshape(-1),
                 main._rows[dim])
    return rows[:, :dim], rows[:, dim:]


def lookup_inputs(main: EmbeddingCollection, linear: "LinearModel", batch, feature_columns,
                  fused: bool, support_dense: bool = True):
    """(sparse_stack [B, F, D] | None, dense [B, Dd] | None, the linear
    table's [B*F, 1] rows | None): one gather for the main and linear rows
    where :func:`_fused_rows` gives them, else the main lookup gathers alone
    and the linear model gathers its own."""
    main_rows, lin_rows = _fused_rows(main, linear, batch, feature_columns, fused)
    sparse_stack, dense = main.stacked_inputs(batch, feature_columns, support_dense,
                                              rows=main_rows)
    return sparse_stack, dense, lin_rows


def lookup_fast_inputs(main: EmbeddingCollection, linear: "LinearModel", batch,
                       feature_columns, fused: bool):
    """(sparse_embedding_list, dense_value_list, the linear table's rows |
    None): :meth:`EmbeddingCollection.fast_inputs` with the rows of
    :func:`_fused_rows` (a mixed-dim set never fuses)."""
    main_rows, lin_rows = _fused_rows(main, linear, batch, feature_columns, fused)
    sparse_list, dense_list = main.fast_inputs(batch, feature_columns, rows=main_rows)
    return sparse_list, dense_list, lin_rows


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
        per-field logits (the sparse fields', then each varlen field's pooled
        one) before their sum."""
        sp, de, vl = split_columns(self.feature_columns)
        out = None
        per_field = []
        if sp:
            per_field.append(self.embedding_dict.stacked_sparse(batch, sp, sparse_rows)[:, :, 0])
        per_field += [self.embedding_dict.lookup_varlen_pooled(batch, f)[:, :, 0] for f in vl]
        if per_field:
            logits = torch.cat(per_field, dim=1)
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
            v = next(v for v in batch.values() if torch.is_tensor(v))
            return torch.zeros((v.shape[0], 1), device=v.device)
        return out


class MultiLinearModel(nn.Module):
    """N first-order models over one column-stacked table
    (``embeddings.py:502-560``): the [B, N] logits that N independent
    :class:`LinearModel` instances would give, from one gather of [B, F, N]
    rows, the varlen features' pooled rows and ``dense @ weight``.  Used by
    MLR, whose
    reference builds N ``Linear`` modules (``deepctr/models/mlr.py:60-75``).
    Parameters ``embedding_dict.table_d{N}`` (every table at dim N) and
    ``weight`` [dense_dim, N], normal(init_std).  Returns [B, N]."""

    def __init__(
        self,
        feature_columns,
        schema: FeatureSchema,
        n_outputs: int,
        init_std: float = 1e-4,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.feature_columns = tuple(feature_columns)
        self.schema = schema
        self.n_outputs = n_outputs
        self.embedding_dict = EmbeddingCollection(
            feature_columns, schema, init_std=init_std, generator=generator,
            force_dim=n_outputs,
        )
        _, de, _ = split_columns(self.feature_columns)
        dense_dim = sum(f.dimension for f in de)
        if dense_dim > 0:
            w = torch.empty(dense_dim, n_outputs).normal_(0.0, init_std, generator=generator)
            self.weight = nn.Parameter(w)

    def forward(self, batch):
        sp, de, vl = split_columns(self.feature_columns)
        parts = [self.embedding_dict.stacked_sparse(batch, sp)] if sp else []
        parts += [self.embedding_dict.lookup_varlen_pooled(batch, f) for f in vl]
        out = torch.cat(parts, dim=1).sum(dim=1) if parts else None  # [B, N]
        if de:
            dense_vals = torch.cat(self.embedding_dict._dense_values(batch, de), dim=-1)
            d = dense_vals @ self.weight
            out = d if out is None else out + d
        if out is None:
            v = next(v for v in batch.values() if torch.is_tensor(v))
            return torch.zeros((v.shape[0], self.n_outputs), device=v.device)
        return out


# ---------------------------------------------------------------------------
# The reference's functional helpers (``deepctr/inputs.py``) under its names
# and signatures, for code carried over from it (``xdeepfm_tpu/embeddings.py:
# 570-626``).  The port's own code calls the EmbeddingCollection methods;
# ``batch`` is the typed batch of tensors, not the reference's flat matrix.
# ---------------------------------------------------------------------------


def create_embedding_matrix(feature_columns, init_std=1e-4, linear=False, sparse=False,
                            device=None):
    """Reference ``inputs.py:158-180``: the embedding tables of a column list,
    here one :class:`EmbeddingCollection` of stacked per-dim tables
    (``linear=True`` makes every dim 1), built on ``device`` (None means
    "cuda").  ``sparse`` is taken for the signature and ignored, as in the
    JAX package: the stacked tables are no ``nn.Embedding``."""
    from .basemodel import resolve_device  # basemodel imports this module

    del sparse
    return EmbeddingCollection(
        tuple(feature_columns), FeatureSchema.build(list(feature_columns)), linear=linear,
        init_std=init_std,
    ).to(resolve_device(device))


def embedding_lookup(batch, embedding_collection, sparse_feature_columns, return_feat_list=(),
                     to_list=False):
    """Reference ``inputs.py:183-210``: {group_name: [[B, 1, dim] ...]}, or
    the flat list of the groups' embeddings with ``to_list``."""
    groups = embedding_collection.grouped_sparse(batch, sparse_feature_columns,
                                                 return_feat_list)
    if to_list:
        return [e for group in groups.values() for e in group]
    return groups


def varlen_embedding_lookup(batch, embedding_collection, varlen_sparse_feature_columns):
    """Reference ``inputs.py:213-227``: {name: [B, maxlen, dim]}."""
    return {f.name: embedding_collection.lookup_varlen_seq(batch, f)
            for f in varlen_sparse_feature_columns}


def get_varlen_pooling_list(batch, embedding_collection, varlen_sparse_feature_columns):
    """Reference ``inputs.py:141-155``: each varlen feature pooled to
    [B, 1, dim] by its combiner."""
    return [embedding_collection.lookup_varlen_pooled(batch, f)
            for f in varlen_sparse_feature_columns]


def get_dense_input(batch, schema: FeatureSchema, feature_columns):
    """Reference ``inputs.py:230-238``: each dense feature's [B, dimension]
    slice of ``batch["dense"]``."""
    return [batch["dense"][:, slice(*schema.dense_slice(f.name))]
            for f in split_columns(feature_columns)[1]]


def maxlen_lookup(batch, maxlen_column):
    """Reference ``inputs.py:241-245``: the [B, 1] lengths of the first
    column of ``maxlen_column``."""
    if maxlen_column is None or len(maxlen_column) == 0:
        raise ValueError("please add max length column for VarLenSparseFeat of DIN/DIEN input")
    return batch["len_" + maxlen_column[0]]
