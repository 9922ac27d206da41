"""Row-sharded embedding lookups over the ``embed`` axis (port of
``xdeepfm_tpu/parallel/sharded_embedding.py``).

A stacked table [rows, dim] row-shards contiguously across the ``embed``
ranks (``mesh.param_sharding_rule``); each rank holds its [S, dim] shard
and every lookup of it is collective over its embed group.

Modes (:func:`set_embedding_mode`):

* ``gspmd`` (default) and ``shard_map``: the psum lookup
  (:func:`sharded_lookup`).  The ids stay put; each shard takes the ids it
  owns (a masked local take) and one sum over ``embed`` combines the
  partial rows, so a lookup returns exactly the table's rows.  Backward:
  each shard adds the cotangents of its own rows, summed over ``data`` (the
  shard is replicated there).  PyTorch has no GSPMD, so ``gspmd`` runs the
  psum lookup too: the values XLA's partitioned take gives.  The batch is
  split over ``data`` only.
* ``all_to_all``: ids are deduplicated and routed to their owners, the owner
  takes its rows, and each unique row travels back once
  (:func:`sharded_lookup_a2a`); backward segment-sums duplicate cotangents
  and reverses the route.  The batch is split over both axes.  The
  exchanges are ``all_to_all_single`` with split sizes, ragged already, so
  the JAX package's dense emulation of ``ragged_all_to_all``
  (``ragged_emu.py``, ``set_ragged_a2a_impl``) has no counterpart.
  ``comm_dtype`` (bf16) narrows the rows on the wire; ids stay int64 and the
  table and its math fp32.

Every sum here is in an order fixed by the ids (``embeddings.
sorted_segment_sum``, ``optimizers.segment_run_sums``), so two identical
steps give bit-equal results, and all data replicas of a shard stay
bit-equal.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from ..embeddings import fused_gather, run_first, sorted_segment_sum
from ..optimizers import _row_set, decode_state, encode_state, segment_run_sums
from .mesh import all_gather_rows, all_reduce_, all_to_all_rows, get_active_mesh

_MODE = "gspmd"
_MESH = None
_COMM_DTYPE = None  # None = full precision; torch.bfloat16 halves row bytes


def set_embedding_mode(mode: str, mesh=None, ragged: Optional[bool] = None, comm_dtype=None):
    """``mode`` in {'gspmd', 'shard_map', 'all_to_all'}.  ``comm_dtype``
    (``all_to_all`` only): rows and row cotangents cross between ranks in
    this dtype (``torch.bfloat16`` or ``"bfloat16"``: half the bytes).
    ``ragged`` is taken for the JAX signature: every exchange here is
    ragged."""
    global _MODE, _MESH, _COMM_DTYPE
    assert mode in ("gspmd", "shard_map", "all_to_all")
    del ragged
    if comm_dtype == "bfloat16":
        comm_dtype = torch.bfloat16
    if comm_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"comm_dtype must be None or bfloat16, not {comm_dtype!r}")
    _MODE, _MESH, _COMM_DTYPE = mode, mesh, comm_dtype


def get_embedding_mode():
    return _MODE, _MESH


def _tables(table) -> tuple:
    return tuple(table) if isinstance(table, (list, tuple)) else (table,)


def _columns(shards: Sequence[torch.Tensor], width: Optional[int]) -> torch.Tensor:
    """The shards side by side, cut to the first ``width`` columns (a view
    for one shard)."""
    t = shards[0] if len(shards) == 1 else torch.cat(shards, 1)
    return t if width is None else t[:, :width]


def _shard_grad(g_rows, local_idx, rows, S, dims, mesh, data_axis):
    """Cotangent rows added into the shard's gradient in id order (indices
    past S land in spare rows, dropped), the columns past the looked-up
    width zero, summed over ``data_axis`` (the shard is replicated there),
    split per table."""
    grad = sorted_segment_sum(g_rows.contiguous(), local_idx, rows)[:S]
    full = sum(dims)
    if grad.shape[1] < full:
        grad = torch.nn.functional.pad(grad, (0, full - grad.shape[1]))
    all_reduce_(grad, mesh, data_axis)
    return tuple(grad.split(list(dims), 1))


class _PsumLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, mesh, data_axis, embed_axis, width, *shards):
        S = shards[0].shape[0]
        local = ids - mesh.axis(embed_axis).index * S
        own = (local >= 0) & (local < S)
        safe = torch.where(own, local, torch.zeros_like(local))
        vals = _columns(shards, width).index_select(0, safe)
        vals = torch.where(own[:, None], vals, vals.new_zeros(()))
        all_reduce_(vals, mesh, embed_axis)
        # the rows this shard does not own add into a spare row S, dropped
        ctx.save_for_backward(torch.where(own, local, S))
        ctx.mesh, ctx.data_axis = mesh, data_axis
        ctx.S, ctx.dims = S, [s.shape[1] for s in shards]
        return vals

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return (None,) * 5 + _shard_grad(g, idx, ctx.S + 1, ctx.S, ctx.dims, ctx.mesh,
                                         ctx.data_axis)


def sharded_lookup(table, ids, mesh, data_axis="data", embed_axis="embed", width=None):
    """``table``: this rank's row shard [S, dim] (or a tuple of same-row
    shards, whose rows are fetched side by side); ``ids``: int [...] global
    row ids of this rank's batch rows -> values [..., dim].

    rows must divide evenly by the embed-axis size.  ``width`` (a lazy
    group's [rows, dims + state] array): only the first ``width`` columns,
    cut before the sum so only parameter columns cross between ranks."""
    shards = _tables(table)
    flat = ids.reshape(-1).long()
    out = _PsumLookup.apply(flat, mesh, data_axis, embed_axis, width, *shards)
    return out.reshape(tuple(ids.shape) + (out.shape[-1],))


# --------------------------------------------------------------------------
# all_to_all mode: dedup + route ids to owners, rows travel back once.
# --------------------------------------------------------------------------


def _sizes_exchange(sizes: torch.Tensor, mesh, axis):
    """An [E] vector, element j to rank j: the host list of what each rank
    sent this one (the split sizes of the exchange that follows)."""
    ax = mesh.axis(axis)
    sizes = sizes.to(torch.int64)
    return all_to_all_rows(sizes, [1] * ax.size, [1] * ax.size, mesh, axis).tolist()


def _dedup_route_layout(ids, E, S):
    """Sort + dedup a flat id vector and derive its per-owner contiguous
    send layout (owner = id // S is monotone in id, so sorting by id also
    groups by owner).  Shared by the a2a lookup and the sharded lazy row
    update, with the JAX layout's conventions: the padding owner ``E`` past
    the unique prefix and the compact unique prefix of ``uids``.

    Returns (order, uniq_pos, uids, valid, send_sizes, in_off): ``order``
    sorts the occurrence stream, ``uniq_pos`` maps sorted positions to
    unique slots, ``uids`` holds the unique ids in its valid prefix."""
    n = ids.shape[0]
    sids, order = torch.sort(ids, stable=True)
    uniq_pos = torch.cumsum(run_first(sids), 0) - 1
    uids = torch.zeros_like(ids)
    uids.index_put_((uniq_pos,), sids)  # a run writes its one id
    n_uniq = uniq_pos[-1:] + 1 if n else uniq_pos.new_zeros(1)
    valid = torch.arange(n, device=ids.device) < n_uniq
    owner = torch.where(valid, torch.div(uids, S, rounding_mode="floor"), E)
    send_sizes = torch.bincount(owner, minlength=E + 1)[:E]
    in_off = torch.cumsum(send_sizes, 0) - send_sizes
    return order, uniq_pos, uids, valid, send_sizes, in_off


class _A2ALookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, mesh, data_axis, embed_axis, width, comm_dtype, *shards):
        ax = mesh.axis(embed_axis)
        S = shards[0].shape[0]
        # 1-2. sort + dedup + per-owner contiguous send layout
        order, uniq_pos, uids, _, send_sizes, _ = _dedup_route_layout(ids, ax.size, S)
        send = send_sizes.tolist()
        n_uniq = sum(send)
        # 3. unique ids travel to their owners
        recv = _sizes_exchange(send_sizes, mesh, embed_axis)
        local_idx = all_to_all_rows(uids[:n_uniq], send, recv, mesh, embed_axis) - ax.index * S
        # 4. the owner takes its rows (a lazy group: its parameter columns)
        rows = _columns(shards, width).index_select(0, local_idx)
        # 5. rows travel back to the requesters' unique slots
        if comm_dtype is not None:
            rows = rows.to(comm_dtype)
        urows = all_to_all_rows(rows, recv, send, mesh, embed_axis).to(shards[0].dtype)
        # 6. each unique row to every occurrence, unsorted
        out = urows.new_empty((ids.shape[0], urows.shape[1]))
        out.index_copy_(0, order, urows.index_select(0, uniq_pos))
        ctx.save_for_backward(order, uniq_pos, local_idx)
        ctx.mesh, ctx.data_axis, ctx.embed_axis, ctx.comm_dtype = mesh, data_axis, embed_axis, comm_dtype
        ctx.send, ctx.recv = send, recv
        ctx.S, ctx.dims = S, [s.shape[1] for s in shards]
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        order, uniq_pos, local_idx = ctx.saved_tensors
        # duplicate cotangents summed into their unique slot
        g_uniq = sorted_segment_sum(g.index_select(0, order), uniq_pos, sum(ctx.send))
        if ctx.comm_dtype is not None:
            g_uniq = g_uniq.to(ctx.comm_dtype)
        # reverse route: unique cotangents travel to the owning shard
        g_buf = all_to_all_rows(g_uniq, ctx.send, ctx.recv, ctx.mesh, ctx.embed_axis).to(g.dtype)
        return (None,) * 6 + _shard_grad(g_buf, local_idx, ctx.S, ctx.S, ctx.dims, ctx.mesh,
                                         ctx.data_axis)


def sharded_lookup_a2a(table, ids, mesh, data_axis="data", embed_axis="embed", width=None):
    """``table``: this rank's row shard [S, dim] (or a tuple of same-row
    shards); ``ids``: int [B, ...] global row ids of this rank's own
    sub-block of the batch (split over both axes) -> values [B, ..., dim].

    Each unique row crosses between ranks once in each direction, and the
    output stays this rank's (no replication anywhere).  ``width`` as in
    :func:`sharded_lookup`."""
    shards = _tables(table)
    flat = ids.reshape(-1).long()
    out = _A2ALookup.apply(flat, mesh, data_axis, embed_axis, width, _COMM_DTYPE, *shards)
    return out.reshape(tuple(ids.shape) + (out.shape[-1],))


# --------------------------------------------------------------------------
# lazy (row-sparse) optimizer x row-sharded tables
# --------------------------------------------------------------------------


def _reg_on(v) -> bool:
    """l1 / l2: a scalar (one table) or a per-column vector (a group whose
    members carry different coefficients)."""
    return v is not None and (torch.is_tensor(v) and v.ndim > 0 or float(v) > 0)


def _merge_routed(ids, g_rows, mesh, data_axis, embed_axis, S):
    """Steps 1-4 of :func:`sharded_lazy_row_update`: all_gather the
    occurrence stream over ``data``, dedup + route the unique (id,
    gradient-sum) pairs to their owning shard, merge the blocks from every
    peer (re-sort + run sums).  Returns (sl, g_runs): sorted local ids and
    each occurrence's run total."""
    ax = mesh.axis(embed_axis)
    # 1. identical inputs across the data replicas of a shard
    ids_all = all_gather_rows(ids.reshape(-1).long(), mesh, data_axis)
    g_all = all_gather_rows(g_rows, mesh, data_axis)
    # 2. dedup + the per-owner send layout (shared with the a2a lookup)
    order, uniq_pos, uids, _, send_sizes, _ = _dedup_route_layout(ids_all, ax.size, S)
    send = send_sizes.tolist()
    g_uniq = sorted_segment_sum(g_all.index_select(0, order), uniq_pos, sum(send))
    # 3. unique rows to their owners: one size exchange feeds both
    recv = _sizes_exchange(send_sizes, mesh, embed_axis)
    local = all_to_all_rows(uids[: sum(send)], send, recv, mesh, embed_axis) - ax.index * S
    buf_g = all_to_all_rows(g_uniq, send, recv, mesh, embed_axis)
    # 4. merge the peers' blocks: one id may come from several of them
    sl, order2 = torch.sort(local, stable=True)
    return sl, segment_run_sums(buf_g.index_select(0, order2), run_first(sl))


@torch.no_grad()
def sharded_lazy_row_update(table, state, ids, g_rows, step, row_update, mesh, lr, l1=0.0,
                            l2=0.0, data_axis="data", embed_axis="embed", packed_dim=None,
                            row_math=None, state_mult=None, state_dtype=None):
    """A lazy row-sparse optimizer update of a row-sharded table, in place.

    ``table`` / ``state``: this rank's [S, *] shards; ``ids`` [N]:
    occurrence ids of this rank's block of the global occurrence stream (the
    ranks' blocks over both axes partition it; duplicates allowed);
    ``g_rows`` [N, D]: their cotangents.

    1. each embed group's ranks all-gather their data peers' blocks, so every
       data replica of a shard sees identical inputs and writes identical
       bits;
    2. the occurrences are sorted and summed to unique (id, gradient) pairs;
    3. the unique pairs travel to their owning shard over ``embed``, each
       unique row's gradient once;
    4. the owner merges its peers' blocks (re-sort + run sums), adds the
       row-wise L2 / L1 gradient once per unique row and applies the row
       update.

    No table-sized gradient or cross-shard table traffic is made.  Flat
    layout: ``row_update`` (``optimizers.LAZY_OPTIMIZERS[kind][1]``) on
    ``table`` and ``state``; returns (table, state).  Packed layout
    (``packed_dim=D`` + ``row_math``): ``table`` is the [S, D + slots]
    param|state array (``state`` and ``row_update`` unused), one gather and
    one row write; returns the table."""
    S = table.shape[0]
    sl, g_runs = _merge_routed(ids, g_rows, mesh, data_axis, embed_axis, S)
    if packed_dim is not None:
        k_d = (state_mult or 1) * packed_dim
        rows = table.index_select(0, sl)
        p_rows = rows[:, :packed_dim]
        st_rows = decode_state(rows[:, packed_dim:], k_d, state_dtype)
        if _reg_on(l2):
            g_runs = g_runs + 2.0 * l2 * p_rows
        if _reg_on(l1):
            g_runs = g_runs + l1 * torch.sign(p_rows)
        p_new, st_new = row_math(p_rows, st_rows, g_runs, step, lr=lr)
        _row_set(table, sl, torch.cat([p_new, encode_state(st_new, state_dtype)], 1))
        return table
    p_rows = table.index_select(0, sl)
    if _reg_on(l2):
        g_runs = g_runs + 2.0 * l2 * p_rows
    if _reg_on(l1):
        g_runs = g_runs + l1 * torch.sign(p_rows)
    row_update(table, state, sl, g_runs, step, lr=lr, p_rows=p_rows)
    return table, state


def maybe_sharded_take(table, ids, width=None):
    """The lookup dispatch of ``EmbeddingCollection`` (the JAX
    ``lookup_ids``): with an active grid whose embed axis holds more than one
    rank, ``table`` is this rank's row shard (or a tuple of same-row
    shards) and the lookup is collective, the psum kernel under ``gspmd`` /
    ``shard_map`` and the exchange under ``all_to_all``; otherwise a plain
    take (:func:`~xdeepfm_tpu_torch.embeddings.fused_gather`).  ``width``
    returns only the first ``width`` columns."""
    mesh = _MESH if _MESH is not None else get_active_mesh()
    if mesh is not None and mesh.shape["embed"] > 1:
        if _MODE == "all_to_all":
            return sharded_lookup_a2a(table, ids, mesh, width=width)
        return sharded_lookup(table, ids, mesh, width=width)
    out = fused_gather(_tables(table), ids)
    out = out.reshape(tuple(ids.shape) + (out.shape[-1],))
    return out if width is None else out[..., :width]
