"""Rank grid + sharding layout (port of ``xdeepfm_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``Mesh(("data", "embed"))`` and
GSPMD places the arrays.  PyTorch runs one process per device, so the grid
here is ``torch.distributed``'s world viewed as ``[n // E, E]``: rank ``r``
sits at ``(r // E, r % E)``, the order of the JAX
``np.array(devices).reshape(n // E, E)``.  Each data row (the ranks of one
``data`` index) is an ``embed`` group, each embed column a ``data`` group.

* ``data`` axis: the batch.  A replicated parameter's gradient is summed
  over the ranks that split the batch (the loss is a sum over the global
  batch, so a sum, not DDP's mean).
* ``embed`` axis: embedding-table rows.  A ``table_d{dim}`` parameter whose
  rows divide by E is row-sharded: rank ``(d, e)`` keeps rows
  ``[e*S, (e+1)*S)``; its lookups are collective (``sharded_embedding``).

Everything else is replicated on every rank and stays bit-equal across them:
every rank applies the same update to the same summed gradient.

Which ranks split the batch depends on the lookup
(:func:`batch_axis`): under ``gspmd`` and ``shard_map`` the batch is split
over ``data`` only and the members of an embed group hold the same rows;
under ``all_to_all`` it is split over both axes.  Statistics of the global
batch (BatchNorm's moments, a loss's normaliser) are summed over those ranks
by :func:`batch_sum` while a grid model trains.

A single process needs no ``torch.distributed``: ``make_mesh()`` then gives
a 1 x 1 grid and every collective is skipped.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..dispatch import bump

AxisName = Union[str, Tuple[str, ...]]

# param_sharding_rule's two layouts, written as the JAX PartitionSpecs
ROW_SHARDED = ("embed", None)
REPLICATED = ()

_ACTIVE_MESH: Optional["RankGrid"] = None


class _Axis:
    """One axis of the grid as this rank sees it: its process group (None
    for the world), the ranks in it and this rank's index among them."""

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group, self.ranks, self.index, self.size = group, tuple(ranks), index, len(ranks)


class RankGrid:
    """The (data, embed) grid of ``torch.distributed`` ranks.

    ``shape`` is ``{"data": n // E, "embed": E}`` (the JAX ``mesh.shape``);
    ``data_index`` / ``embed_index`` are this rank's coordinates, ``device``
    is where its tensors live.  :meth:`axis` gives the process group of
    ``"data"``, ``"embed"`` or ``("data", "embed")`` (the world)."""

    def __init__(self, n: int, embed: int, device: torch.device):
        if n % embed:
            raise ValueError(f"{n} ranks do not divide into embed groups of {embed}")
        self.size = n
        self.shape = {"data": n // embed, "embed": embed}
        self.device = torch.device(device)
        self.rank = dist.get_rank() if n > 1 else 0
        self.data_index, self.embed_index = divmod(self.rank, embed)
        D = n // embed
        self._axes = {("data", "embed"): _Axis(None, range(n), self.rank)}
        self.checkpoint_group = None
        if n == 1:
            self._axes["embed"] = _Axis(None, [0], 0)
            self._axes["data"] = _Axis(None, [0], 0)
            return
        # every rank creates every group, in the same order
        for d in range(D):
            ranks = [d * embed + e for e in range(embed)]
            group = dist.new_group(ranks)
            if d == self.data_index:
                self._axes["embed"] = _Axis(group, ranks, self.embed_index)
        for e in range(embed):
            ranks = [d * embed + e for d in range(D)]
            group = dist.new_group(ranks)
            if e == self.embed_index:
                self._axes["data"] = _Axis(group, ranks, self.data_index)
        # checkpoint writes in the background coordinate on a group of their
        # own, so that they never interleave with a training collective
        self.checkpoint_group = dist.new_group(list(range(n)), backend="gloo")

    def axis(self, name: AxisName) -> _Axis:
        if isinstance(name, (list, tuple)) and len(name) == 1:
            name = name[0]
        return self._axes[tuple(name) if isinstance(name, (list, tuple)) else name]

    def __repr__(self):
        return (f"RankGrid(data={self.shape['data']}, embed={self.shape['embed']}, "
                f"rank={self.rank}, device={self.device})")


def set_active_mesh(mesh: Optional[RankGrid]):
    """Record the grid the model state was sharded over (the lookups of a
    row-sharded table and ``embedding_gradient="auto"`` consult it)."""
    global _ACTIVE_MESH
    if mesh != _ACTIVE_MESH:
        bump()
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Optional[RankGrid]:
    return _ACTIVE_MESH


def make_mesh(n_devices: Optional[int] = None, embed_axis: Optional[int] = None,
              device=None) -> RankGrid:
    """The (data, embed) grid over the ``torch.distributed`` world (a 1 x 1
    grid when it is not initialised).  ``n_devices`` must be the world size
    (the JAX one takes the first n devices; here each rank is a device).
    ``embed_axis`` defaults to 2 when n is even and above 1, else 1.
    ``device`` is this rank's device, None meaning the current CUDA device;
    with no GPU present None raises, as a model's ``device=None`` does."""
    from ..basemodel import resolve_device

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n}) on a world of {world} ranks: the grid holds "
                         "every rank")
    if embed_axis is None:
        embed_axis = 2 if n % 2 == 0 and n > 1 else 1
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return RankGrid(n, embed_axis, dev)


def param_sharding_rule(path_str: str, leaf, mesh: RankGrid):
    """Embedding tables row-shard over ``embed``; all else replicated.
    Returns ``ROW_SHARDED`` (``("embed", None)``) or ``REPLICATED``
    (``()``), the JAX rule's PartitionSpecs."""
    E = mesh.shape["embed"]
    if "table_d" in path_str and leaf.ndim == 2 and leaf.shape[0] % E == 0:
        return ROW_SHARDED
    return REPLICATED


def shard_rows(t: torch.Tensor, mesh: RankGrid) -> torch.Tensor:
    """This rank's rows ``[e*S, (e+1)*S)`` of a row-sharded array (a view)."""
    S = t.shape[0] // mesh.shape["embed"]
    return t[mesh.embed_index * S : (mesh.embed_index + 1) * S]


def shard_params(params, mesh: RankGrid, prefix: str = ""):
    """A canonical parameter tree (nested dicts of arrays, the
    ``get_weights()["params"]`` layout) with every leaf a tensor on the
    rank's device: a row-sharded leaf holds only the rank's rows."""
    out = {}
    for key, leaf in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(leaf, dict):
            out[key] = shard_params(leaf, mesh, path)
            continue
        t = torch.as_tensor(leaf)
        if param_sharding_rule(path, t, mesh) == ROW_SHARDED:
            t = shard_rows(t, mesh)
        out[key] = t.to(mesh.device).clone()
    return out


def batch_axis() -> AxisName:
    """The axes that split the batch under the active embedding mode:
    ``"data"``, or ``("data", "embed")`` under ``all_to_all``."""
    from .sharded_embedding import get_embedding_mode

    mode, _ = get_embedding_mode()
    return ("data", "embed") if mode == "all_to_all" else "data"


def shard_batch(batch: Dict, mesh: RankGrid):
    """This rank's slice of a global batch (every array split on its leading
    dim over :func:`batch_axis`), as tensors on the rank's device.  The
    leading dim must divide by the number of ranks splitting it."""
    ax = mesh.axis(batch_axis())
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.shape[0] % ax.size:
            raise ValueError(f"batch of {t.shape[0]} rows does not split over {ax.size} ranks")
        b = t.shape[0] // ax.size
        out[k] = t[ax.index * b : (ax.index + 1) * b].to(mesh.device)
    return out


def shard_model_state(model, mesh: RankGrid):
    """Shard a compiled BaseModel's parameters in place and rebuild its
    optimizer state on the shards: the lazy optimizer's [rows, dims + state]
    arrays shard with their tables.  Makes ``mesh`` the active grid."""
    set_active_mesh(mesh)
    model._shard_state(mesh)
    return model


# ---------------------------------------------------------------------------
# collectives over an axis (each skipped where the axis holds one rank)
# ---------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, mesh: RankGrid, axis: AxisName) -> torch.Tensor:
    """Sum ``t`` in place over ``axis``; returns it."""
    ax = mesh.axis(axis)
    if ax.size > 1:
        dist.all_reduce(t, group=ax.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: RankGrid, axis: AxisName) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` stacked along dim 0 in axis order (the
    JAX ``all_gather(..., tiled=True)``)."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    dist.all_gather(parts, t, group=ax.group)
    return torch.cat(parts)


def all_to_all_rows(x: torch.Tensor, send_sizes, recv_sizes, mesh: RankGrid,
                    axis: AxisName) -> torch.Tensor:
    """Rows ``x`` sent to the axis' ranks in blocks of ``send_sizes`` (block
    j to rank j); returns the blocks received, ``recv_sizes[i]`` rows from
    rank i, concatenated in rank order: the ragged all-to-all that
    ``lax.ragged_all_to_all`` is on the TPU."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return x
    out = x.new_empty((sum(recv_sizes),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=list(recv_sizes),
                           input_split_sizes=list(send_sizes), group=ax.group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis whose cotangent is summed over the same axis: the
    gradient of a global-batch statistic with respect to each rank's part."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axis), None, None


# the (grid, axis) whose ranks split the batch while a grid model trains
_BATCH: Optional[Tuple[RankGrid, AxisName]] = None


@contextlib.contextmanager
def batch_statistics(mesh: Optional[RankGrid], axis: AxisName):
    """Within the block, :func:`batch_sum` sums over ``axis`` of ``mesh``
    (nothing when it holds one rank)."""
    global _BATCH
    prev = _BATCH
    _BATCH = (mesh, axis) if mesh is not None and mesh.axis(axis).size > 1 else None
    try:
        yield
    finally:
        _BATCH = prev


def batch_ranks() -> int:
    """How many ranks split the batch in the current step (1 outside a grid
    model's train step)."""
    return 1 if _BATCH is None else _BATCH[0].axis(_BATCH[1]).size


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that split the batch, differentiably; ``x``
    itself outside a grid model's train step.  A module turns a statistic of
    its rows into one of the global batch with it."""
    if _BATCH is None:
        return x
    return _AllReduceSum.apply(x, *_BATCH)
