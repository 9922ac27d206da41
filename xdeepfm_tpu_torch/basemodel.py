"""Keras-style engine (port of ``xdeepfm_tpu/basemodel.py``; reference
``deepctr/models/basemodel.py``).

``compile`` / ``fit`` / ``evaluate`` / ``predict`` and weights I/O.  The model
runs on a CUDA device unless the caller passes ``device="cpu"``; with no GPU
present, ``device=None`` raises instead of carrying on on the CPU.

Training follows the JAX engine: a sum-reduced masked loss plus the L2
registry over canonical parameter paths, the tail batch padded with row 0
under a zero mask, per-batch metrics on the device, one host sync per epoch.
``fit`` copies its data to the device once and gathers each batch there.

On a rank grid (``parallel.shard_model_state``) the model runs as one
process per rank, each given the same data and seed: every rank takes its
slice of each global batch, row-sharded tables are looked up collectively,
the gradient of every replicated parameter is summed over the ranks that
split the batch, and the loss, metrics, predictions and weights are those of
the global batch on every rank (:meth:`BaseModel._train_step_grid`).

Model classes subclass :class:`BaseModel` and implement ``_build_module()``
returning an ``nn.Module`` with signature
``module(batch, training, generator) -> dict`` whose ``pred`` is [B, 1], or
[B, num_tasks] for a multitask model compiled with a list of losses
(optional ``aux_loss``: a scalar added to the loss; optional ``logs``: named
scalars averaged into the epoch logs).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .callbacks import CallbackList, History
from .embeddings import EmbeddingCollection, run_first, table_touched_spec, touched_ids
from .features import FeatureSchema, SparseFeat, VarLenSparseFeat, compute_input_dim
from .metrics import DEVICE_METRICS, HOST_METRICS
from .parallel.mesh import (
    REPLICATED,
    all_gather_rows,
    all_reduce_,
    batch_axis,
    batch_statistics,
    get_active_mesh,
    param_sharding_rule,
    shard_rows,
)
from .optimizers import (
    LAZY_OPTIMIZERS,
    LAZY_ROW_MATH,
    decode_state,
    encode_state,
    _row_set,
    get_optimizer,
    segment_run_sums,
    state_slots,
)
from . import serialization
from .weights import (
    canonical_paths,
    canonical_shapes,
    flatten_tree,
    from_jax_lazy_state,
    from_jax_opt_state,
    from_jax_weights,
    to_jax_weights,
    unflatten_tree,
)

# embedding_optimizer="auto" picks the lazy row-sparse optimizer for stacked
# tables of at least this many rows: the JAX package's crossover
# (xdeepfm_tpu/basemodel.py:39-47), kept until the card's own is measured.
# Module-level so that tests and deployments can tune it.
AUTO_LAZY_MIN_ROWS = 6_000_000


def _loss_fn_single(name):
    """Sum-reduced masked losses (reference ``basemodel.py:463-481`` maps
    strings to torch functionals called with reduction='sum')."""
    if name == "binary_crossentropy":

        def bce(y_pred, y_true, mask):
            p = y_pred.clamp(1e-7, 1 - 1e-7)
            ll = -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))
            return (ll * mask).sum()

        return bce
    if name == "mse":
        return lambda y_pred, y_true, mask: (mask * (y_pred - y_true) ** 2).sum()
    if name == "mae":
        return lambda y_pred, y_true, mask: (mask * (y_pred - y_true).abs()).sum()
    raise NotImplementedError(name)


def sum_loss(loss_names, pred, y, mask, num_tasks=None):
    """The sum-reduced masked loss (``basemodel.py:883-899``): one loss name
    over the flattened prediction, or a list of them, one per task
    (``num_tasks`` of them), each over its column of the [B, T] prediction
    and labels, summed."""
    if not isinstance(loss_names, list):
        return _loss_fn_single(loss_names)(pred.reshape(-1), y.reshape(-1), mask)
    if num_tasks is None or len(loss_names) != num_tasks:
        raise AssertionError("the length of `loss_func` should be equal with `self.num_tasks`")
    return sum(_loss_fn_single(name)(pred[:, i], y[:, i], mask)
               for i, name in enumerate(loss_names))


def _sum_squares(table, chunk=1 << 22) -> torch.Tensor:
    """sum(table^2), a 0-dim fp32 tensor on the table's device, summed a few
    million rows at a time: no table-sized temporary."""
    with torch.no_grad():
        total = torch.zeros((), dtype=torch.float64, device=table.device)
        for i in range(0, table.shape[0], chunk):
            total += table[i : i + chunk].square().sum(dtype=torch.float64)
    return total.float()


def _multi_rank() -> bool:
    """Whether the active rank grid, or else the ``torch.distributed``
    world, holds more than one rank."""
    grid = get_active_mesh()
    if grid is not None:
        return grid.size > 1
    return (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def resolve_device(device=None) -> torch.device:
    """``None`` means "cuda"; a CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class BaseModel:
    def __init__(
        self,
        linear_feature_columns,
        dnn_feature_columns,
        l2_reg_linear=1e-5,
        l2_reg_embedding=1e-5,
        init_std=1e-4,
        seed=1024,
        task="binary",
        device=None,
        gpus=None,
    ):
        # gpus is taken for the reference's signature and ignored, as in the
        # JAX engine: placement comes from the rank grid (parallel/)
        del gpus
        self.device = resolve_device(device)
        self.linear_feature_columns = tuple(linear_feature_columns)
        self.dnn_feature_columns = tuple(dnn_feature_columns)
        self.schema = FeatureSchema.build(
            list(linear_feature_columns) + list(dnn_feature_columns)
        )
        self.init_std = init_std
        self.seed = seed
        self.task = task
        self.num_tasks = None  # set by the multitask models

        # (path-substring pattern, l1, l2) over the canonical parameter paths
        # (``basemodel.py:213-219``); recorded now, applied by training.
        self.regularization_weight: List[Tuple[Tuple[str, ...], float, float]] = []
        self.add_regularization_weight(("embedding_dict/",), l2=l2_reg_embedding)
        self.add_regularization_weight(("linear_model/",), l2=l2_reg_linear)

        self.stop_training = False
        self.history = History()
        self.metrics = {}
        self.metrics_names = ["loss"]
        self.optimizer = None
        self.module = None
        self._reg_terms = []
        self._lazy = None  # the lazy embedding optimizer's groups, see compile
        self._matmul_precision = None
        self._opt_spec = None  # (optimizer, lr) of compile, to rebuild it on shards
        # the rank grid (parallel.shard_model_state), the row-sharded
        # parameters' keys -> their tables' rows, and their ids
        self._grid = None
        self._shards: Dict[str, int] = {}
        self._shard_ids = frozenset()
        self._checkpoints = []  # save_checkpoint_sharded(block=False) in flight

    def _finalize(self):
        """Build the module on the CPU from the seed, then move it to the
        device.  Called at the end of each subclass ``__init__``.  Each
        embedding collection learns its parameter path, under which a lazy
        gradient-split step hands it its occurrence blocks."""
        self.module = self._build_module().to(self.device).eval()
        for name, m in self.module.named_modules():
            if isinstance(m, EmbeddingCollection):
                m.path = name.replace(".", "/")

    def _build_module(self):
        raise NotImplementedError

    @property
    def embedding_size(self):
        """The one embedding dim of the sparse DNN features
        (``basemodel.py:2078-2093``); raises if they differ."""
        sizes = {f.embedding_dim for f in self.dnn_feature_columns
                 if isinstance(f, (SparseFeat, VarLenSparseFeat))}
        if len(sizes) > 1:
            raise ValueError(
                "embedding_dim of SparseFeat and VarlenSparseFeat must be same in this model!"
            )
        return sizes.pop()

    def compute_input_dim(self, feature_columns, include_sparse=True, include_dense=True,
                          feature_group=False):
        """The DNN input width of ``feature_columns``
        (``basemodel.py:2095-2106``): the sparse and varlen fields' embedding
        dims (or their count, ``feature_group``) and the dense dims."""
        return compute_input_dim(feature_columns, include_sparse, include_dense, feature_group)

    def add_regularization_weight(self, pattern, l1=0.0, l2=0.0):
        if isinstance(pattern, str):
            pattern = (pattern,)
        self.regularization_weight.append((tuple(pattern), l1, l2))

    # ------------------------------------------------------ regularization

    def _reg_coeffs(self, path):
        """(l1, l2) of one canonical path: every matching pattern's added
        (``basemodel.py:247-253``)."""
        l1 = l2 = 0.0
        for pattern, a, b in self.regularization_weight:
            if all(s in path for s in pattern):
                l1, l2 = l1 + a, l2 + b
        return l1, l2

    def _regularization_terms(self):
        """(parameter, l1, l2) per parameter that a registered pattern
        matches, by its canonical path: the linear table
        ``linear_model/embedding_dict/table_d1`` matches both
        ``embedding_dict/`` and ``linear_model/``."""
        paths = canonical_paths(self.module)
        terms = []
        for name, param in self.module.named_parameters():
            l1, l2 = self._reg_coeffs(paths[name])
            if l1 > 0 or l2 > 0:
                terms.append((param, l1, l2))
        return terms

    def _regularization_loss(self):
        """sum(l1*|w|) + sum(l2*w^2) over the registered parameters
        (``basemodel.py:221-245``): part of the loss, so its gradient is
        2*l2*w, not the optimizer's weight decay.  A lazy table adds its
        value only (:meth:`_lazy_reg_value`): the lazy step applies its
        gradient row by row."""
        total = torch.zeros((), device=self.device)
        for param, l1, l2 in self._reg_terms:
            if l1 > 0:
                total = total + l1 * param.abs().sum()
            if l2 > 0:
                total = total + l2 * param.square().sum()
        if self._lazy is not None:
            total = total + self._lazy_reg_value()
        return total

    # ------------------------------------------------------------- compile

    def compile(self, optimizer, loss=None, metrics=None, lr=None,
                embedding_optimizer="dense", matmul_precision=None,
                embedding_gradient="auto", fused_lookup="auto",
                embedding_layout="auto", embedding_state_dtype="float32"):
        """Optimizer (a name, or a factory of ``torch.optim.Optimizer`` in
        place of an optax transformation), loss name(s) and host metric names
        (``basemodel.py:257-440``).

        ``embedding_optimizer="lazy"`` trains the stacked embedding tables
        with a row-sparse optimizer: only the rows a batch touched get moment
        and weight updates, their L2 gradient included (``optimizer`` must be
        "adam" or "adagrad"; the other parameters take that optimizer
        densely).  "auto" picks lazy for a stacked table of at least
        ``AUTO_LAZY_MIN_ROWS`` rows and a lazy-capable name, else dense.

        ``embedding_gradient`` (lazy only): "split" gathers the batch's rows
        of each table into a per-occurrence block outside autograd, the model
        reads its lookups from that block, and the step sums each row's
        gradient over its occurrences and writes each touched row once: no
        table-sized tensor is made.  The L2 value of an l2-only table is
        tracked as a running sum(w^2).  "dense" takes the table's full
        gradient from autograd and updates its touched rows.  "auto" is
        "split" on one rank and "dense" where the active rank grid, or the
        ``torch.distributed`` world, holds more than one
        (``basemodel.py:337-340``).

        A lazy table lives in one [rows, dims + state] array with its
        optimizer's row state in the columns past its own, and its parameter
        is a column view of that array.  ``embedding_layout`` (lazy + split
        only): "packed" puts the tables indexed by the same ids (the main
        ``table_d{dim}`` and the linear ``table_d1``) into one such array, so
        one gather and one row write a step serve the whole group; "flat"
        gives each table its own.  "auto" is "packed" under lazy + split.
        ``embedding_state_dtype="bfloat16"`` (packed only) stores the row
        state as bf16 pairs in fp32 columns.  Weights, checkpoints and
        predict speak the canonical tables and state under every layout.

        ``matmul_precision``: None runs every product in fp32, TF32 off.
        "bfloat16" (the JAX package's opt-in one bf16 pass for every XLA
        product of the train step's forward, ``basemodel.py:283-284``,
        :836-862) runs the module's forward in ``_train_step`` under bf16
        autocast; its prediction is cast back to fp32 for the loss, and the
        loss, the regularisation and the optimizer stay fp32.  ``predict``,
        ``evaluate`` and the ``Scorer`` stay fp32, as in the JAX engine, and
        every hand-written kernel takes fp32 inputs with autocast off
        (``ops._build.fp32_forward``), as the Pallas kernels keep their own
        precision.  Autocast returns bf16 products, so elementwise work
        between two products runs in bf16 where XLA's bf16-pass dot returns
        fp32 (``ROADMAP.md`` section 3, deliberate deviations).

        ``fused_lookup`` (``basemodel.py:286-292``, :419-423): "auto" and True
        let a model fetch its main and linear tables' rows in one gather where
        their layouts agree (``embeddings.can_fuse_lookup``); False makes it
        gather them separately.  The same rows either way.  A lazy compile
        ignores it, as the JAX engine does."""
        if matmul_precision not in (None, "bfloat16"):
            raise ValueError(f"matmul_precision must be None or 'bfloat16', not "
                             f"{matmul_precision!r}")
        if fused_lookup not in ("auto", True, False):
            raise ValueError(fused_lookup)
        if embedding_optimizer not in ("dense", "auto", "lazy"):
            raise ValueError(embedding_optimizer)
        if embedding_gradient not in ("auto", "dense", "split"):
            raise ValueError(embedding_gradient)
        if embedding_layout not in ("auto", "packed", "flat"):
            raise ValueError(embedding_layout)
        if embedding_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(embedding_state_dtype)
        if embedding_state_dtype == "bfloat16" and embedding_layout == "flat":
            raise ValueError("embedding_state_dtype='bfloat16' requires the packed "
                             "embedding_layout")
        if self._shards:
            raise RuntimeError("compile() a model before shard_model_state(), not after")
        if embedding_gradient == "auto":
            # the JAX engine's rule: split on one device, dense on more (a
            # global sort over sharded ids would ride collectives)
            embedding_gradient = "dense" if _multi_rank() else "split"
        split = embedding_gradient == "split"
        lazy_capable = isinstance(optimizer, str) and optimizer in LAZY_OPTIMIZERS
        if embedding_optimizer == "auto":
            max_rows = max(
                (p.shape[0] for n, p in self.module.named_parameters() if "table_d" in n),
                default=0,
            )
            lazy = max_rows >= AUTO_LAZY_MIN_ROWS and lazy_capable
            embedding_optimizer = "lazy" if lazy else "dense"
        specs = {}
        if embedding_optimizer == "lazy":
            if not lazy_capable:
                raise ValueError("embedding_optimizer='lazy' requires optimizer in "
                                 f"{sorted(LAZY_OPTIMIZERS)}")
            specs = self._build_lazy_specs()
        packed = bool(specs) and split and embedding_layout in ("auto", "packed")
        if embedding_layout == "packed" and not packed:
            raise ValueError("embedding_layout='packed' requires embedding_optimizer='lazy' "
                             "with embedding_gradient='split'")
        if embedding_state_dtype == "bfloat16" and not packed:
            raise ValueError("embedding_state_dtype='bfloat16' requires lazy+split (packed "
                             "layout): nothing was packed under this config")
        self._matmul_precision = matmul_precision
        self._opt_spec = (optimizer, lr)
        self.loss_names = list(loss) if isinstance(loss, list) else loss
        self.metrics_names = ["loss"]
        self.metrics = self._get_metrics(metrics)
        # drop every reference to the tables before they move
        self.optimizer, self._reg_terms = None, []
        self._unpack_lazy()
        if specs:
            self._lazy = self._pack_lazy(specs, optimizer, lr, split, packed,
                                         embedding_state_dtype)
        lazy_ids = {id(m["param"]) for m in self._lazy_members()}
        self.optimizer = get_optimizer(
            optimizer, [p for p in self.module.parameters() if id(p) not in lazy_ids], lr)
        self._reg_terms = [t for t in self._regularization_terms() if id(t[0]) not in lazy_ids]
        for m in self.module.modules():
            if isinstance(m, EmbeddingCollection):
                m.fused_lookup = bool(specs) or fused_lookup in ("auto", True)

    # ------------------------------------------------- lazy embedding tables

    def _build_lazy_specs(self):
        """{table path: (entries, l1, l2)} for the tables whose touched rows
        the batch enumerates (``basemodel.py:689-713``): the main
        ``embedding_dict`` and the linear ``linear_model/embedding_dict``."""
        specs = {}
        for prefix in ("embedding_dict", "linear_model/embedding_dict"):
            try:
                coll = self.module.get_submodule(prefix.replace("/", "."))
            except AttributeError:
                continue
            if not isinstance(coll, EmbeddingCollection):
                continue
            try:
                spec = table_touched_spec(coll.feature_columns, coll.schema, coll.linear,
                                          coll.force_dim)
            except KeyError:
                continue
            for dim, entries in spec.items():
                path = f"{prefix}/table_d{dim}"
                specs[path] = (tuple(entries), *self._reg_coeffs(path))
        return specs

    def _lazy_members(self):
        return [m for g in self._lazy["groups"] for m in g["members"]] if self._lazy else []

    def _pack_lazy(self, specs, kind, lr, split, packed, state_dtype):
        """Move every lazy table into its group's array.  A group is the
        tables with identical (entries, rows) (``basemodel.py:443-535``)
        when packed, else one table; its [rows, dsum + slots] array holds
        the members' columns side by side (largest first), then the group's
        row state (k blocks of dsum columns, Adam's m | v, bf16 pairs under
        ``state_dtype``).  Each member's parameter becomes a column view of
        the array, so predict, ``get_weights`` and ``set_weights`` see the
        canonical tables with no copy.  Groups are filled one member at a
        time and each old table is freed as it is copied: the peak is the
        old tables plus one new array."""
        row_math, k = LAZY_ROW_MATH[kind]
        owners = {}
        for path in specs:
            mod_path, attr = path.rsplit("/", 1)
            mod = self.module.get_submodule(mod_path.replace("/", "."))
            owners[path] = (mod, attr, tuple(getattr(mod, attr).shape))
        by_key = {}
        for path, (entries, l1, l2) in specs.items():
            key = (entries, owners[path][2][0]) if packed else (path,)
            by_key.setdefault(key, []).append(path)
        groups = []
        for _, paths in sorted(by_key.items(), key=str):
            paths = sorted(paths, key=lambda p: -owners[p][2][0] * owners[p][2][1])
            members, off = [], 0
            for path in paths:
                mod, attr, (rows, dim) = owners[path]
                _, l1, l2 = specs[path]
                members.append(dict(path=path, module=mod, attr=attr, dim=dim, off=off,
                                    l1=l1, l2=l2))
                off += dim
            l1vec, l2vec = torch.zeros(off), torch.zeros(off)
            for m in members:
                l1vec[m["off"] : m["off"] + m["dim"]] = m["l1"]
                l2vec[m["off"] : m["off"] + m["dim"]] = m["l2"]
            groups.append(dict(
                members=members, entries=specs[paths[0]][0], rows=owners[paths[0]][2][0],
                dsum=off, k=k, slots=state_slots(k * off, state_dtype),
                l1vec=l1vec.to(self.device) if l1vec.any() else None,
                l2vec=l2vec.to(self.device) if l2vec.any() else None,
            ))
        del owners
        # the tallest array first: its transient peak is the largest
        for g in sorted(groups, key=lambda g: -g["rows"] * g["dsum"]):
            arr = torch.zeros(g["rows"], g["dsum"] + g["slots"], device=self.device)
            for m in g["members"]:
                view = arr[:, m["off"] : m["off"] + m["dim"]]
                with torch.no_grad():
                    view.copy_(getattr(m["module"], m["attr"]))
                # the old table is freed here: nothing else holds it
                setattr(m["module"], m["attr"], nn.Parameter(view))
                m["param"] = getattr(m["module"], m["attr"])
            g["array"] = arr
        lazy = dict(groups=groups, kind=kind, row_math=row_math, split=split, packed=packed,
                    state_dtype=state_dtype,
                    lr=LAZY_OPTIMIZERS[kind][2]["lr"] if lr is None else lr, t=0, reg={})
        if split:
            # sum(w^2) of each l2-only table, kept up to date by the steps
            # from their touched rows: the L2 value costs no table read
            # (``basemodel.py:734-774``); an l1 table is scanned each step
            for m in (m for g in groups for m in g["members"]):
                if m["l2"] > 0 and m["l1"] == 0:
                    lazy["reg"][m["path"]] = _sum_squares(m["param"])
        return lazy

    def _unpack_lazy(self):
        """Give every lazy table back its own [rows, dim] parameter (a
        recompile; ``basemodel.py:549-570``).  The row states are dropped,
        as a recompile of the JAX engine re-initialises them."""
        if self._lazy is None:
            return
        for g in self._lazy.pop("groups"):
            for m in g["members"]:
                table = m.pop("param").detach().clone(memory_format=torch.contiguous_format)
                setattr(m["module"], m["attr"], nn.Parameter(table))
            g.clear()  # frees the array once its last view is gone
        self._lazy = None

    @torch.no_grad()
    def _lazy_reg_value(self):
        """The lazy tables' regularization value, a constant: the tracked
        l2 * sum(w^2), or a scan of the table (an l1 table, the
        dense-cotangent mode, and a row-sharded table, whose shards' sums
        are added over ``embed``: its shard-local update surfaces no
        before / after rows, ``basemodel.py:747-771``)."""
        total = torch.zeros((), device=self.device)
        reg = self._lazy["reg"]
        for g in self._lazy["groups"]:
            for m in g["members"]:
                if m["path"] in reg:
                    total += m["l2"] * reg[m["path"]]
                    continue
                w = m["param"]
                part = torch.zeros((), device=self.device)
                if m["l1"] > 0:
                    part += m["l1"] * w.abs().sum()
                if m["l2"] > 0:
                    part += m["l2"] * w.square().sum()
                if g.get("sharded"):
                    all_reduce_(part, self._grid, "embed")
                total += part
        return total

    def _lazy_blocks(self, batch):
        """The split step's per-occurrence blocks: per group one gather of
        its touched rows (param and state columns), outside autograd; the
        param columns become a leaf whose gradient the model's lookups fill.
        Returns (``batch["_compact"]``, per group (ids, rows, leaf))."""
        compact, saved = {}, []
        for g in self._lazy["groups"]:
            ids = touched_ids(batch, g["entries"])
            if g.get("sharded"):
                # a row-sharded group: its parameter columns through the
                # collective lookup; the update gathers the rows it writes
                from .parallel.sharded_embedding import maybe_sharded_take

                rows = None
                leaf = maybe_sharded_take(g["array"], ids, width=g["dsum"]).requires_grad_()
            else:
                rows = g["array"].index_select(0, ids)
                leaf = rows[:, : g["dsum"]].clone().requires_grad_()
            for m in g["members"]:
                compact[m["path"]] = (leaf if len(g["members"]) == 1
                                      else leaf[:, m["off"] : m["off"] + m["dim"]])
            saved.append((ids, rows, leaf))
        return compact, saved

    @torch.no_grad()
    def _lazy_update(self, batch, saved, axis=None):
        """The lazy row update of every group (``basemodel.py:1008-1183``),
        :func:`~xdeepfm_tpu_torch.optimizers.lazy_adam_rows` on the group's
        array: sort the touched ids, give every occurrence its id's gradient
        summed over the run (``segment_run_sums``), add the L2 / L1 gradient
        of the rows, run the row math and write the rows, each occurrence of
        an id with the same values (``_row_set``).  Split: the gradient is
        the occurrence leaf's; dense: the table's autograd gradient at the
        touched rows.

        On a rank grid (``axis``: the ranks that split the batch) every
        rank takes the global batch's touched ids (and, split, their
        gradients) by an all_gather over ``axis``, so replicas write the
        same bits; a row-sharded group keeps the ids of its rows, and under
        the split gradient it runs ``sharded_lazy_row_update``."""
        lz = self._lazy
        lz["t"] += 1
        grid = self._grid if axis is not None else None
        for i, g in enumerate(lz["groups"]):
            dsum, k = g["dsum"], g["k"]
            if lz["split"]:
                ids, rows, leaf = saved[i]
                for m in g["members"]:
                    if m["param"].grad is not None:
                        raise RuntimeError(f"a lookup of {m['path']} bypassed the occurrence "
                                           "block of the split step")
                grad = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
                if g.get("sharded"):
                    self._sharded_group_update(g, ids, grad, axis)
                    continue
                if grid is not None:
                    ids = all_gather_rows(ids, grid, axis)
                    grad = all_gather_rows(grad, grid, axis)
                sids, order = torch.sort(ids, stable=True)
                first = run_first(sids)
                g_rows = segment_run_sums(grad.index_select(0, order), first)
                rows = (g["array"].index_select(0, sids) if grid is not None
                        else rows.index_select(0, order))
            else:
                ids = touched_ids(batch, g["entries"])
                if grid is not None:
                    ids = all_gather_rows(ids, grid, axis)
                    if g.get("sharded"):  # this shard's rows, as local ids
                        S = g["array"].shape[0]
                        lo = grid.embed_index * S
                        ids = ids[(ids >= lo) & (ids < lo + S)] - lo
                sids, _ = torch.sort(ids)
                first = run_first(sids)
                parts = []
                for m in g["members"]:
                    table_grad, m["param"].grad = m["param"].grad, None
                    parts.append(table_grad.index_select(0, sids) if table_grad is not None
                                 else g["array"].new_zeros(sids.shape[0], m["dim"]))
                g_rows = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
                rows = g["array"].index_select(0, sids)
            p = rows[:, :dsum]
            st = decode_state(rows[:, dsum:], k * dsum, lz["state_dtype"])
            if g["l2vec"] is not None:
                g_rows = g_rows + 2.0 * g["l2vec"] * p
            if g["l1vec"] is not None:
                g_rows = g_rows + g["l1vec"] * torch.sign(p)
            p_new, st_new = lz["row_math"](p, st, g_rows, lz["t"], lr=lz["lr"])
            _row_set(g["array"], sids,
                     torch.cat([p_new, encode_state(st_new, lz["state_dtype"])], 1))
            for m in g["members"]:
                if m["path"] in lz["reg"]:
                    sl = slice(m["off"], m["off"] + m["dim"])
                    delta = p_new[:, sl].square().sum(1) - p[:, sl].square().sum(1)
                    lz["reg"][m["path"]] += torch.where(first, delta, 0.0).sum()

    def _sharded_group_update(self, g, ids, grad, axis):
        """A row-sharded group's split-gradient update:
        ``sharded_lazy_row_update`` of this rank's block of the global
        occurrence stream.  Under the psum lookup the members of an embed
        group hold the same rows, so each passes its own E-th of them."""
        from .parallel.sharded_embedding import sharded_lazy_row_update

        lz, grid = self._lazy, self._grid
        if axis == "data":
            E, e = grid.shape["embed"], grid.embed_index
            ids, grad = ids.tensor_split(E)[e], grad.tensor_split(E)[e]
        sharded_lazy_row_update(
            g["array"], None, ids, grad, lz["t"], None, grid, lr=lz["lr"],
            l1=0.0 if g["l1vec"] is None else g["l1vec"],
            l2=0.0 if g["l2vec"] is None else g["l2vec"],
            packed_dim=g["dsum"], row_math=lz["row_math"], state_mult=g["k"],
            state_dtype=lz["state_dtype"])

    def _lazy_state(self):
        """{table path: [rows, k * dim] fp32 row state} in the JAX layout
        (``_canonical_opt_state``, ``basemodel.py:1838-1858``): each group's
        state decoded and sliced per member; a row-sharded group's gathered
        over ``embed``."""
        out = {}
        for g in self._lazy["groups"] if self._lazy else ():
            R, k, dsum = g["rows"], g["k"], g["dsum"]
            cols = g["array"][:, dsum:]
            if g.get("sharded"):
                cols = all_gather_rows(cols, self._grid, "embed")
            st = decode_state(cols, k * dsum, self._lazy["state_dtype"])
            st = st.reshape(R, k, dsum)
            for m in g["members"]:
                out[m["path"]] = st[:, :, m["off"] : m["off"] + m["dim"]].reshape(R, k * m["dim"])
        return out

    @torch.no_grad()
    def _set_lazy_state(self, lazy, reg):
        """Load canonical row states ({path: [rows, k * dim]}) and tracked
        sum(w^2) values ({path: scalar}) into this model's layout.  The
        states must name exactly the lazy tables; a tracked value the source
        lacks is recomputed from the table."""
        if set(lazy) != {m["path"] for m in self._lazy_members()}:
            raise ValueError(f"the row states {sorted(lazy)} do not match this model's lazy "
                             f"tables {sorted(m['path'] for m in self._lazy_members())}")
        for g in self._lazy["groups"] if self._lazy else ():
            R, k = g["rows"], g["k"]
            parts = []
            for m in g["members"]:
                st = torch.tensor(np.asarray(lazy[m["path"]], np.float32), device=self.device)
                if tuple(st.shape) != (R, k * m["dim"]):
                    raise ValueError(f"row state of {m['path']}: shape {tuple(st.shape)}, "
                                     f"expected {(R, k * m['dim'])}")
                parts.append(st.reshape(R, k, m["dim"]))
            st = torch.cat(parts, 2).reshape(R, k * g["dsum"])
            if g.get("sharded"):
                st = shard_rows(st, self._grid)
            g["array"][:, g["dsum"] :] = encode_state(st, self._lazy["state_dtype"])
        for path in self._lazy["reg"] if self._lazy else ():
            value = reg.get(path)
            param = next(m["param"] for m in self._lazy_members() if m["path"] == path)
            self._lazy["reg"][path] = (
                torch.tensor(float(value), device=self.device) if value is not None
                else _sum_squares(param))

    # ------------------------------------------------------------ rank grid

    def _shard_state(self, grid):
        """Row-shard the tables in place (``parallel.shard_model_state``).
        A lazy group's [rows, dims + state] array whose rows divide by E keeps
        this rank's rows and its members become column views of them (their
        row state shards with them and their tracked sum(w^2) is dropped);
        every other parameter that ``param_sharding_rule`` row-shards is
        replaced by its rows.  The dense optimizer is rebuilt over the new
        parameters with fresh state, as the JAX engine's
        ``_init_opt_state``."""
        if self.optimizer is None:
            raise RuntimeError("compile() before shard_model_state()")
        if self._shards:
            raise RuntimeError("the model is sharded already")
        if grid.device != self.device:
            raise ValueError(f"the grid's device {grid.device} is not the model's {self.device}")
        E = grid.shape["embed"]
        shards = {}
        with torch.no_grad():
            for g in self._lazy["groups"] if self._lazy else ():
                g["sharded"] = E > 1 and g["rows"] % E == 0
                if not g["sharded"]:
                    continue
                g["array"] = arr = shard_rows(g["array"], grid).clone()
                for m in g["members"]:
                    setattr(m["module"], m["attr"],
                            nn.Parameter(arr[:, m["off"] : m["off"] + m["dim"]]))
                    m["param"] = getattr(m["module"], m["attr"])
                    self._lazy["reg"].pop(m["path"], None)
                    shards[m["path"].replace("/", ".")] = g["rows"]
            lazy_ids = {id(m["param"]) for m in self._lazy_members()}
            paths = canonical_paths(self.module)
            for key, p in list(self.module.named_parameters()):
                if E == 1 or id(p) in lazy_ids or \
                        param_sharding_rule(paths[key], p, grid) == REPLICATED:
                    continue
                owner, _, attr = key.rpartition(".")
                mod = self.module.get_submodule(owner) if owner else self.module
                setattr(mod, attr, nn.Parameter(shard_rows(p.detach(), grid).clone()))
                shards[key] = p.shape[0]
        self._grid, self._shards = grid, shards
        named = dict(self.module.named_parameters())
        self._shard_ids = frozenset(id(named[k]) for k in shards)
        optimizer, lr = self._opt_spec
        self.optimizer = get_optimizer(
            optimizer, [p for p in self.module.parameters() if id(p) not in lazy_ids], lr)
        self._reg_terms = [t for t in self._regularization_terms() if id(t[0]) not in lazy_ids]

    def _batch_part(self):
        """(this rank's index, the rank count) of the ranks that split the
        batch on a grid of more than one rank, else None."""
        if self._grid is None or self._grid.size == 1:
            return None
        ax = self._grid.axis(batch_axis())
        return ax.index, ax.size

    def _reduce_grads(self, axis):
        """The gradient of every replicated parameter summed over ``axis``
        in one flat all_reduce (the loss is a sum over the global batch, so
        a sum, not DDP's mean).  A row shard's gradient was summed by its
        lookup's backward."""
        grads = [p.grad for p in self.module.parameters()
                 if p.grad is not None and id(p) not in self._shard_ids]
        if not grads:
            return
        flat = all_reduce_(torch._utils._flatten_dense_tensors(grads), self._grid, axis)
        for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(r)

    def _train_step_grid(self, xb, y, mask, with_metrics=True):
        """:meth:`_train_step` on a rank grid; ``xb``, ``y``, ``mask`` are
        this rank's slice of the global batch (``basemodel.py:586-629``
        under GSPMD).  The sum-loss (and an aux loss, whose normaliser the
        module sums over the ranks, ``mesh.batch_sum``) is differentiated
        alone; the replicated parameters' gradients are summed over the ranks
        that split the batch (:meth:`_reduce_grads`); the L2 / L1 registry
        is differentiated after that, so it counts once.  Returns the global
        batch's total loss and metrics, the same on every rank.

        Why one flat all_reduce and not DDP: DDP averages (a comm hook would
        undo it), reduces every parameter over one group, and overlaps the
        reduce with a backward whose collective lookups run on the same
        group; here the group depends on the lookup (``data``, or the world
        under ``all_to_all``), row shards are left out, and one reduce after
        the backward keeps every rank's order fixed."""
        grid, axis = self._grid, batch_axis()
        xb = dict(xb, labels=y[:, :1] if y.ndim > 1 else y[:, None], sample_mask=mask.reshape(-1))
        saved = None
        if self._lazy is not None and self._lazy["split"]:
            xb["_compact"], saved = self._lazy_blocks(xb)
        with batch_statistics(grid, axis), torch.autocast(
                self.device.type, dtype=torch.bfloat16,
                enabled=self._matmul_precision == "bfloat16"):
            out = self.module(xb, training=True, generator=self._dropout_gen)
        pred = out["pred"].float()
        aux = out.get("aux_loss")
        loss = sum_loss(self.loss_names, pred, y, mask, self.num_tasks)
        if aux is not None:
            loss = loss + aux.float()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._reduce_grads(axis)
        reg = torch.zeros((), device=self.device)
        shard_reg = torch.zeros((), device=self.device)
        for param, l1, l2 in self._reg_terms:
            term = (l1 * param.abs().sum() if l1 > 0 else 0.0) + (
                l2 * param.square().sum() if l2 > 0 else 0.0)
            if id(param) in self._shard_ids:
                shard_reg = shard_reg + term
            else:
                reg = reg + term
        if (reg + shard_reg).requires_grad:
            (reg + shard_reg).backward()
        self.optimizer.step()
        if self._lazy is not None:
            self._lazy_update(xb, saved, axis)
        with torch.no_grad():
            total = all_reduce_(loss.detach().clone(), grid, axis) + reg.detach()
            total = total + all_reduce_(shard_reg.detach().clone(), grid, "embed")
            if self._lazy is not None:
                total = total + self._lazy_reg_value()
        mvals = {}
        if with_metrics:
            with torch.no_grad():
                y_all = all_gather_rows(y, grid, axis)
                p_all = all_gather_rows(pred.detach(), grid, axis)
                m_all = all_gather_rows(mask, grid, axis)
                if isinstance(self.loss_names, list):
                    yt, pt = y_all.reshape(-1), p_all.reshape(-1)
                    mt = m_all.repeat_interleave(p_all.shape[-1])
                else:
                    yt = y_all.reshape(y_all.shape[0], -1)[:, 0]
                    pt, mt = p_all.reshape(p_all.shape[0], -1)[:, 0], m_all
                mvals = {name: DEVICE_METRICS[name](yt, pt, mt) for name in self.metrics}
        # a module's logs (sfg_loss) are sums of the ranks' parts, as its
        # loss terms are
        for name, value in out.get("logs", {}).items():
            mvals[name] = all_reduce_(value.detach().float().clone(), grid, axis)
        return total, mvals

    def _get_metrics(self, metrics):
        metrics_ = {}
        for m in metrics or ():
            if m not in HOST_METRICS:
                raise NotImplementedError(m)
            metrics_[m] = HOST_METRICS[m]
            self.metrics_names.append(m)
        return metrics_

    # ----------------------------------------------------------------- fit

    def _train_step(self, xb, y, mask, with_metrics=True):
        """One step on device tensors (``basemodel.py:901-1210``): forward,
        the sum-loss (:func:`sum_loss`) + regularisation + aux loss, backward,
        optimizer update.  Returns (total loss, {metric or module log:
        value}) as device scalars.  The batch gains ``labels`` and ``sample_mask``, as the JAX
        engine's does (``basemodel.py:904-905``), for modules whose loss needs
        them (the SFG decoder).  Under the lazy optimizer the tables' rows
        are updated after the dense optimizer's step (:meth:`_lazy_update`).
        The BatchNorm and Dice statistics update in the forward.  Under
        ``matmul_precision="bfloat16"`` the forward runs under bf16 autocast
        and its outputs are cast back to fp32.  On a rank grid of more than
        one rank: :meth:`_train_step_grid`."""
        if self._batch_part() is not None:
            return self._train_step_grid(xb, y, mask, with_metrics)
        xb = dict(xb, labels=y[:, :1] if y.ndim > 1 else y[:, None], sample_mask=mask.reshape(-1))
        saved = None
        if self._lazy is not None and self._lazy["split"]:
            xb["_compact"], saved = self._lazy_blocks(xb)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self._matmul_precision == "bfloat16"):
            out = self.module(xb, training=True, generator=self._dropout_gen)
        pred = out["pred"].float()
        aux = out.get("aux_loss")
        loss = sum_loss(self.loss_names, pred, y, mask, self.num_tasks)
        total = loss + self._regularization_loss() + (0.0 if aux is None else aux.float())
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        if self._lazy is not None:
            self._lazy_update(xb, saved)
        mvals = {}
        if with_metrics:
            with torch.no_grad():
                if isinstance(self.loss_names, list):
                    # multitask: over the flattened [B, T] outputs, each row's
                    # mask repeated T times (``basemodel.py:1199-1205``)
                    yt, pt = y.reshape(-1), pred.detach().reshape(-1)
                    mt = mask.repeat_interleave(pred.shape[-1])
                else:
                    yt = y.reshape(y.shape[0], -1)[:, 0]
                    pt, mt = pred.detach().reshape(pred.shape[0], -1)[:, 0], mask
                mvals = {name: DEVICE_METRICS[name](yt, pt, mt) for name in self.metrics}
        # scalars a module publishes (sfg_loss) reach the epoch logs even at
        # verbose=0 (basemodel_sfg.py:366-367)
        for name, value in out.get("logs", {}).items():
            mvals[name] = value.detach().float()
        return total.detach(), mvals

    def fit(self, x=None, y=None, batch_size=None, epochs=1, verbose=1,
            initial_epoch=0, validation_split=0.0, validation_data=None,
            shuffle=True, callbacks=None, steps_per_dispatch=1):
        """Keras-style training loop (``basemodel.py:1288-1461``).  Returns the
        ``History``.  ``steps_per_dispatch`` is accepted for the JAX engine's
        signature, where it runs K steps as one XLA program; here every step
        is its own Python-loop turn (K steps in one CUDA graph is later
        work), so it changes no result."""
        if self.optimizer is None:
            raise RuntimeError("call compile() before fit()")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        batch = self._pack_x(x)
        y = np.asarray(y, dtype=np.float32)
        if y.ndim == 1:
            y = y[:, None]
        n = len(y)

        do_validation = False
        if validation_data:
            do_validation = True
            if len(validation_data) not in (2, 3):
                raise ValueError(
                    "When passing a `validation_data` argument, it must contain "
                    "either 2 items (x_val, y_val), or 3 items "
                    "(x_val, y_val, val_sample_weights)"
                )
            val_batch = self._pack_x(validation_data[0])
            val_y = np.asarray(validation_data[1], dtype=np.float32)
        elif validation_split and 0.0 < validation_split < 1.0:
            do_validation = True
            split_at = int(n * (1.0 - validation_split))
            val_batch = {k: v[split_at:] for k, v in batch.items()}
            val_y = y[split_at:]
            batch = {k: v[:split_at] for k, v in batch.items()}
            y = y[:split_at]
            n = split_at
        else:
            val_batch, val_y = None, []

        if batch_size is None:
            batch_size = 256
        part = self._batch_part()
        if part is not None and batch_size % part[1]:
            raise ValueError(f"batch_size {batch_size} does not split over the {part[1]} ranks "
                             "that split the batch")
        steps_per_epoch = (n - 1) // batch_size + 1
        # the training data lives on the device; batches are gathered there
        x_dev = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        y_dev = torch.as_tensor(y, device=self.device)

        callbacks = CallbackList((callbacks or []) + [self.history])
        callbacks.set_model(self)
        callbacks.set_params({
            "batch_size": batch_size, "epochs": epochs,
            "steps": steps_per_epoch, "samples": n, "verbose": verbose,
            "do_validation": do_validation, "metrics": self.metrics_names,
        })
        callbacks.on_train_begin()
        self.stop_training = False
        self._dropout_gen = self._dropout_generator()
        self._restart_lazy_steps()

        print(
            "Train on {0} samples, validate on {1} samples, {2} steps per "
            "epoch".format(n, len(val_y), steps_per_epoch)
        )
        rng = np.random.default_rng(self.seed)
        for epoch in range(initial_epoch, epochs):
            callbacks.on_epoch_begin(epoch)
            start_time = time.time()
            perm = rng.permutation(n) if shuffle else np.arange(n)
            # the tail batch is padded with row 0 under a zero mask
            idx = np.zeros(steps_per_epoch * batch_size, np.int64)
            idx[:n] = perm
            mask = np.zeros(steps_per_epoch * batch_size, np.float32)
            mask[:n] = 1.0
            idx = torch.as_tensor(idx, device=self.device)
            mask = torch.as_tensor(mask, device=self.device)
            totals, mvals = [], []
            for i in range(steps_per_epoch):
                lo, hi = i * batch_size, (i + 1) * batch_size
                if part is not None:  # this rank's slice of the global batch
                    b = batch_size // part[1]
                    lo, hi = lo + part[0] * b, lo + (part[0] + 1) * b
                take = idx[lo:hi]
                total, mv = self._train_step(
                    {k: v.index_select(0, take) for k, v in x_dev.items()},
                    y_dev.index_select(0, take),
                    mask[lo:hi],
                    with_metrics=verbose > 0,
                )
                totals.append(total)
                mvals.append(mv)
            epoch_logs = self._epoch_logs(totals, mvals, n, steps_per_epoch)
            if do_validation:
                eval_result = self._evaluate_packed(val_batch, val_y, batch_size)
                for name, result in eval_result.items():
                    epoch_logs["val_" + name] = result

            if verbose > 0:
                epoch_time = int(time.time() - start_time)
                print("Epoch {0}/{1}".format(epoch + 1, epochs))
                eval_str = "{0}s - loss: {1: .4f}".format(epoch_time, epoch_logs["loss"])
                for name in self.metrics:
                    eval_str += " - " + name + ": {0: .4f}".format(epoch_logs[name])
                if do_validation:
                    for name in self.metrics:
                        eval_str += " - val_" + name + ": {0: .4f}".format(
                            epoch_logs["val_" + name]
                        )
                print(eval_str)
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        return self.history

    def _dropout_generator(self):
        """Dropout masks: one stream per fit, as the JAX engine folds the step
        number into a key seeded with seed + 1.  On a grid each slice of the
        batch draws its own stream (the members of an embed group, which hold
        the same rows under the psum lookup, the same one)."""
        part = self._batch_part()
        offset = 0 if part is None else 7919 * part[0]
        return torch.Generator(device=self.device).manual_seed(self.seed + 1 + offset)

    def _restart_lazy_steps(self):
        """The lazy optimizer's step count starts again at 1 with each
        ``fit`` / ``fit_stream`` call, so its bias correction restarts too:
        the JAX engine counts the lazy step from its ``global_step``, which
        each of those calls sets to 0 (``basemodel.py:1353``, :1562), while
        the dense optimizer's count goes on."""
        if self._lazy is not None:
            self._lazy["t"] = 0

    @staticmethod
    def _prefetch_iter(it, depth=3):
        """Pull ``it`` in a background thread (queue depth bounded) so that
        host-side batch production (file parse, preprocessing) overlaps the
        device steps.  The native parser (ctypes) and numpy release the GIL,
        so a plain thread captures most of the overlap.  The thread runs no
        CUDA work: the copies and launches stay with the consumer.  An
        exception raised by ``it`` is raised in the consumer; a consumer that
        stops early stops the thread, which has exited when the generator
        closes."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        end = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return
                put(end)
            except BaseException as e:  # re-raised in the consumer below
                put(e)

        t = threading.Thread(target=worker, name="fit_stream-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def fit_stream(self, generator, epochs=1, verbose=1, initial_epoch=0, validation_data=None,
                   callbacks=None, steps_per_dispatch=1, steps_per_epoch=None, prefetch=3):
        """Out-of-core training from a batch stream (``basemodel.py:1507-1711``).

        ``generator`` yields ``(x, y)`` batches (``x`` a feature dict, ``y``
        labels) of one batch size; the final batch may be shorter, and is
        padded and masked like ``fit``'s tail.  It is a callable
        ``epoch -> iterable`` (a fresh stream each epoch) or a re-iterable; a
        one-shot iterator supports ``epochs=1`` only.  With ``prefetch`` > 0 a
        thread reads up to that many batches ahead (:meth:`_prefetch_iter`).
        Epoch logs, callbacks, the sum-loss normalisation and the train
        metrics follow :meth:`fit`.  ``steps_per_epoch`` caps each epoch, the
        read-ahead included (the source is consumed exactly that many times);
        by default an epoch is one pass of the stream.  ``steps_per_dispatch``
        changes no result, as in :meth:`fit`."""
        if self.optimizer is None:
            raise RuntimeError("call compile() before fit_stream()")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        do_validation = bool(validation_data)
        if do_validation:
            val_batch = self._pack_x(validation_data[0])
            val_y = np.asarray(validation_data[1], dtype=np.float32)

        callbacks = CallbackList((callbacks or []) + [self.history])
        callbacks.set_model(self)
        callbacks.set_params({
            "epochs": epochs, "verbose": verbose,
            # keras convention: steps present but None when the stream's
            # length is unknown up front
            "steps": steps_per_epoch,
            "do_validation": do_validation, "metrics": self.metrics_names,
        })
        callbacks.on_train_begin()
        self.stop_training = False
        self._dropout_gen = self._dropout_generator()
        self._restart_lazy_steps()
        part = self._batch_part()
        if verbose > 0:
            print("Train on stream, validate on {0} samples".format(
                len(val_y) if do_validation else 0))

        batch_size = None
        for epoch in range(initial_epoch, epochs):
            callbacks.on_epoch_begin(epoch)
            start_time = time.time()
            n_seen = 0
            totals, mvals = [], []
            stream = generator(epoch) if callable(generator) else generator
            if prefetch:
                src = iter(stream)
                if steps_per_epoch:
                    src = itertools.islice(src, steps_per_epoch)
                stream = self._prefetch_iter(src, depth=prefetch)
            try:
                for x, yb in stream:
                    xb = self._pack_x(x)
                    yb = np.asarray(yb, dtype=np.float32)
                    if yb.ndim == 1:
                        yb = yb[:, None]
                    bs = len(yb)
                    if batch_size is None:
                        batch_size = bs
                    if bs > batch_size:
                        raise ValueError(f"stream batch of {bs} rows exceeds the stream's "
                                         f"batch size {batch_size}")
                    n_seen += bs
                    mask = np.ones((batch_size,), np.float32)
                    if bs < batch_size:
                        pad = batch_size - bs
                        mask[bs:] = 0.0
                        xb = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                              for k, v in xb.items()}
                        yb = np.concatenate([yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
                    if part is not None:  # this rank's slice of the global batch
                        if batch_size % part[1]:
                            raise ValueError(f"stream batch size {batch_size} does not split "
                                             f"over the {part[1]} ranks that split the batch")
                        b = batch_size // part[1]
                        cut = slice(part[0] * b, (part[0] + 1) * b)
                        xb, yb, mask = {k: v[cut] for k, v in xb.items()}, yb[cut], mask[cut]
                    total, mv = self._train_step(
                        {k: torch.as_tensor(v, device=self.device) for k, v in xb.items()},
                        torch.as_tensor(yb, device=self.device),
                        torch.as_tensor(mask, device=self.device),
                        with_metrics=verbose > 0,
                    )
                    totals.append(total)
                    mvals.append(mv)
                    if steps_per_epoch and len(totals) >= steps_per_epoch:
                        break
            finally:
                if prefetch:
                    stream.close()  # stops the prefetch thread, also on an error
            if totals:
                epoch_logs = self._epoch_logs(totals, mvals, n_seen, len(totals))
            else:
                epoch_logs = {"loss": float("nan")}
            if do_validation:
                eval_result = self._evaluate_packed(val_batch, val_y, batch_size or 256)
                for name, result in eval_result.items():
                    epoch_logs["val_" + name] = result

            if verbose > 0:
                epoch_time = int(time.time() - start_time)
                print("Epoch {0}/{1}".format(epoch + 1, epochs))
                eval_str = "{0}s - {1} samples - loss: {2: .4f}".format(
                    epoch_time, n_seen, epoch_logs["loss"])
                for name in self.metrics:
                    eval_str += " - " + name + ": {0: .4f}".format(epoch_logs[name])
                if do_validation:
                    for name in self.metrics:
                        eval_str += " - val_" + name + ": {0: .4f}".format(
                            epoch_logs["val_" + name])
                print(eval_str)
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        return self.history

    @staticmethod
    def _epoch_logs(totals, mvals, n, steps_per_epoch) -> Dict[str, float]:
        """The epoch's loss (sum of step totals over n) and train metrics and
        module logs (mean over steps), read from the device in one transfer."""
        names = list(mvals[0]) if mvals else []
        values = torch.stack(totals + [mv[k] for mv in mvals for k in names]).cpu().numpy()
        logs = {"loss": float(np.sum(values[: len(totals)].astype(np.float64))) / n}
        per_step = values[len(totals) :].reshape(len(mvals), len(names)).astype(np.float64)
        for j, name in enumerate(names):
            logs[name] = float(np.sum(per_step[:, j]) / steps_per_epoch)
        return logs

    # ------------------------------------------------------ evaluate/predict

    def _pack_x(self, x):
        if isinstance(x, dict):
            return self.schema.pack(x)
        if isinstance(x, (list, tuple)):
            names = self.schema.feature_names()
            return self.schema.pack(dict(zip(names, x)))
        raise TypeError("x must be a dict or list of arrays")

    def _dummy_batch(self, n=2):
        batch = {}
        if self.schema.sparse:
            batch["sparse"] = np.zeros((n, self.schema.n_sparse), np.int32)
        if self.schema.dense:
            batch["dense"] = np.zeros((n, self.schema.dense_dim), np.float32)
        for f in self.schema.varlen:
            batch["vl_" + f.name] = np.zeros((n, f.maxlen), np.int32)
            if f.length_name is not None:
                batch["len_" + f.length_name] = np.ones((n, 1), np.int32)
        return batch

    def _predict_step(self, batch):
        """Typed numpy batch -> predictions [B, 1] ([B, T] for T tasks) on
        the device.  On a rank grid every rank passes the same batch, scores
        its slice (padded by repeating the last row) and returns the whole
        batch's predictions."""
        part = self._batch_part()
        if part is not None:
            n = len(next(iter(batch.values())))
            b = -(-n // part[1])
            if b * part[1] > n:
                batch = {k: np.concatenate([v, np.repeat(v[-1:], b * part[1] - n, axis=0)])
                         for k, v in batch.items()}
            batch = {k: v[part[0] * b : (part[0] + 1) * b] for k, v in batch.items()}
        xb = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        with torch.inference_mode():
            pred = self.module(xb, training=False)["pred"]
            if part is not None:
                pred = all_gather_rows(pred, self._grid, batch_axis())[:n]
            return pred

    def evaluate(self, x, y, batch_size=256):
        return self._evaluate_packed(self._pack_x(x), y, batch_size)

    def _evaluate_packed(self, batch, y, batch_size=256):
        pred = self._predict_packed(batch, batch_size)
        return {
            name: fn(np.asarray(y).reshape(pred.shape), pred)
            for name, fn in self.metrics.items()
        }

    def predict(self, x, batch_size=256):
        return self._predict_packed(self._pack_x(x), batch_size)

    def _predict_packed(self, batch, batch_size=256):
        """Whole batches only: the tail is padded by repeating the last row
        and sliced off again; float64 out (``basemodel.py:1726-1761``)."""
        n = len(next(iter(batch.values())))
        n_batches = (n - 1) // batch_size + 1 if n else 0
        n_pad = n_batches * batch_size - n
        if n_pad:
            batch = {
                k: np.concatenate([v, np.repeat(v[-1:], n_pad, axis=0)])
                for k, v in batch.items()
            }
        preds = [
            self._predict_step(
                {k: v[i * batch_size : (i + 1) * batch_size] for k, v in batch.items()}
            )
            for i in range(n_batches)
        ]
        if not preds:
            return np.zeros((0, 1), dtype="float64")
        return torch.cat(preds)[:n].cpu().numpy().astype("float64")

    # --------------------------------------------------------- weights I/O

    def get_weights(self):
        """The canonical tree of the JAX package's ``get_weights``
        (``basemodel.py:1765-1773``), as numpy: ``params`` and the BatchNorm
        running statistics, ``batch_stats``.  A row-sharded model gathers
        its tables over ``embed`` (every rank gets the whole tree, as the
        JAX ``device_get`` does)."""
        if not self._shards:
            return to_jax_weights(self.module)
        state = self.module.state_dict()
        for key in self._shards:
            state[key] = all_gather_rows(state[key], self._grid, "embed")
        return to_jax_weights(self.module, state)

    def set_weights(self, weights):
        """Load a canonical tree, ``params`` and ``batch_stats``; names and
        shapes must match exactly (a model with BatchNorm needs its
        statistics).  The tables are written in place, so a lazy model's
        group arrays take them and keep their row states.  A tree with
        ``opt_state`` (the JAX package's ``_canonical_opt_state()``) also
        carries its lazy row states and tracked L2 values
        (:func:`from_jax_lazy_state`); without it a lazy model's tracked L2
        values are recomputed from the new tables.  The row states are
        kept.  A row-sharded model keeps each table's rows of this rank."""
        state = from_jax_weights(weights, self.module)
        for key in self._shards:
            if key in state:
                state[key] = shard_rows(state[key], self._grid)
        self.module.load_state_dict(state, strict=True)
        if weights.get("opt_state") is not None:
            self._set_lazy_state(*from_jax_lazy_state(weights["opt_state"]))
        elif self._lazy is not None:
            # the tracked sum(w^2) follows the new tables (the JAX engine's
            # set_weights leaves it as it was)
            for m in self._lazy_members():
                if m["path"] in self._lazy["reg"]:
                    self._lazy["reg"][m["path"]] = _sum_squares(m["param"])

    def _weights_flat(self):
        """{canonical key: array} of ``get_weights``: ``params/<path>`` and
        ``batch_stats/<path>``."""
        tree = self.get_weights()
        return {**dict(flatten_tree(tree["params"], "params")),
                **dict(flatten_tree(tree["batch_stats"], "batch_stats"))}

    @staticmethod
    def _weights_tree(flat):
        """The canonical tree of ``params/...`` and ``batch_stats/...`` keys."""
        tree = unflatten_tree({k: v for k, v in flat.items()
                               if k.startswith(("params/", "batch_stats/"))})
        return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}

    def save_weights(self, path):
        """``.npz`` keyed by canonical path (``params/cin/conv_w_0``...,
        ``batch_stats/dnn/bn_0/mean``...).  The JAX package's format is
        ``serialization.save_file(path, model.get_weights())``."""
        with open(path, "wb") as f:
            np.savez(f, **self._weights_flat())

    @staticmethod
    def _read_file(path):
        """(``"npz"``, {key: array}) of the port's ``.npz`` (a zip), or
        (``"flax"``, tree) of the JAX package's flax msgpack file (a msgpack
        map), told apart by the first bytes."""
        with open(path, "rb") as f:
            head = f.read(4)
        if head.startswith(b"PK\x03\x04"):
            with np.load(path, allow_pickle=False) as data:
                return "npz", {k: data[k] for k in data.files}
        if serialization.is_msgpack_map(head):
            return "flax", serialization.restore_file(path)
        raise ValueError(f"{path} is neither an .npz nor a flax msgpack file (first bytes "
                         f"{head!r})")

    def _check_architecture(self, weights):
        """Raise, naming the first canonical path whose shape differs (or
        that one side lacks), unless ``weights`` has this model's
        ``params`` and ``batch_stats`` tree (the JAX ``load_weights``
        fallback's check, ``basemodel.py:1801-1830``).  A row-sharded
        table counts its full rows."""
        want = canonical_shapes(self.module, self._shards)
        got = {f"{c}/{path}": tuple(np.shape(v)) for c in ("params", "batch_stats")
               for path, v in flatten_tree(weights.get(c) or {})}
        for path in sorted(set(want) | set(got)):
            if want.get(path) != got.get(path):
                raise ValueError(f"the file does not match this architecture at {path}: "
                                 f"expected {want.get(path)}, got {got.get(path)}")

    def load_weights(self, path):
        """Reads ``save_weights``' ``.npz`` or the weights of
        ``save_checkpoint``'s, or a file of the JAX package's: its
        ``save_weights`` (a CLI's ``{model}_best.weights``,
        ``{model}_weights.bin``) or the ``params`` and ``batch_stats`` of its
        ``save_checkpoint`` (flax msgpack, :mod:`~xdeepfm_tpu_torch.serialization`).
        A file of another architecture raises, naming the first path whose
        shape differs.  Any lazy layout and a row-sharded model take either
        format (each rank keeps its rows)."""
        kind, data = self._read_file(path)
        weights = self._weights_tree(data) if kind == "npz" else {
            "params": data["params"], "batch_stats": data.get("batch_stats") or {}}
        self._check_architecture(weights)
        self.set_weights(weights)

    def _parameter_paths(self):
        """(canonical path by parameter id, parameter by canonical path)."""
        paths = canonical_paths(self.module)
        named = dict(self.module.named_parameters())
        return {id(p): paths[n] for n, p in named.items()}, {paths[n]: p for n, p in named.items()}

    def _checkpoint_flat(self, epoch):
        """``save_checkpoint``'s keys and host arrays (collective on a
        row-sharded model: every rank calls it)."""
        if self.optimizer is None:
            raise RuntimeError("compile() before save_checkpoint()")
        flat = self._weights_flat()
        path_of, _ = self._parameter_paths()
        for param, state in self.optimizer.state.items():
            for slot, value in state.items():
                if value is not None:
                    if torch.is_tensor(value) and self._row_state(param, value):
                        value = all_gather_rows(value.detach(), self._grid, "embed")
                    value = value.detach().cpu() if torch.is_tensor(value) else value
                    flat[f"opt_state/{path_of[id(param)]}/{slot}"] = np.asarray(value)
        for where, st in self._lazy_state().items():
            flat[f"opt_state/lazy/{where}"] = st.cpu().numpy()
        for where, value in (self._lazy["reg"] if self._lazy else {}).items():
            flat[f"opt_state/reg/{where}"] = np.asarray(value.item(), np.float32)
        flat["epoch"] = np.asarray(epoch, np.int64)
        return flat

    def save_checkpoint(self, path, epoch=0):
        """The full training checkpoint (``basemodel.py:1860-1877``) in the
        port's own format, one ``.npz``: the canonical params
        (``params/...``, as ``save_weights``), the optimizer state keyed by
        canonical parameter path (``opt_state/<path>/<slot>``, e.g.
        ``opt_state/dnn/linear_0/kernel/exp_avg``; each slot in the
        parameter's own layout) and ``epoch``.  Under the lazy optimizer,
        each table's canonical [rows, k * dim] row state
        (``opt_state/lazy/<path>``, Adam's m then v, fp32 whatever the layout
        and state dtype) and its tracked sum(w^2) (``opt_state/reg/<path>``):
        a checkpoint of any layout loads under any other.  The BatchNorm
        statistics as ``save_weights`` writes them (``batch_stats/...``).
        The JAX package's format is ``serialization.save_file(path,
        weights.to_jax_checkpoint(model, epoch))``.  A row-sharded model
        gathers its tables and their state over ``embed`` and rank 0 writes
        the file; every rank calls it."""
        flat = self._checkpoint_flat(epoch)
        if self._grid is None or self._grid.rank == 0:
            with open(path, "wb") as f:
                np.savez(f, **flat)
        if self._grid is not None and self._grid.size > 1:
            torch.distributed.barrier()  # the file is whole before any rank reads it

    def _row_state(self, param, value) -> bool:
        """Whether an optimizer state tensor of ``param`` is laid out by the
        rows of a row-sharded table (Adam's moments; not its step)."""
        return (id(param) in self._shard_ids and value.ndim == param.ndim
                and value.shape[0] == param.shape[0])

    def load_checkpoint(self, path) -> int:
        """Restore ``save_checkpoint``'s params and optimizer state, or those
        of the JAX package's ``save_checkpoint`` (flax msgpack; its optax
        state mapped by :func:`~xdeepfm_tpu_torch.weights.from_jax_opt_state`,
        whose optimizer must be this model's); returns the epoch, for
        ``fit(initial_epoch=...)``.  The lazy step count restarts, as the
        next ``fit`` restarts it (the JAX engine stores none)."""
        if self.optimizer is None:
            raise RuntimeError("compile() before load_checkpoint()")
        kind, data = self._read_file(path)
        if kind == "npz":
            flat, weights = data, self._weights_tree(data)
        else:
            if "opt_state" not in data or "params" not in data:
                raise ValueError(f"{path} is a flax weights file, not a checkpoint: "
                                 "load_weights reads it")
            name, flat = from_jax_opt_state(data["opt_state"], self.module)
            mine = self._opt_spec[0]
            if isinstance(mine, str) and mine != name:
                raise ValueError(f"the checkpoint holds {name}'s state; this model was "
                                 f"compiled with {mine}")
            flat["epoch"] = np.asarray(data["epoch"])
            weights = {"params": data["params"], "batch_stats": data.get("batch_stats") or {}}
        self._check_architecture(weights)
        self.set_weights(weights)
        _, param_at = self._parameter_paths()
        index = {id(p): i for i, p in enumerate(
            p for group in self.optimizer.param_groups for p in group["params"])}
        state, lazy, reg = {}, {}, {}
        for key, value in flat.items():
            if key.startswith(("opt_state/lazy/", "opt_state/reg/")):
                kind, where = key[len("opt_state/"):].split("/", 1)
                (lazy if kind == "lazy" else reg)[where] = value
            elif key.startswith("opt_state/"):
                where, slot = key[len("opt_state/"):].rsplit("/", 1)
                param = param_at[where]
                if id(param) not in index:
                    raise ValueError(f"the checkpoint holds dense optimizer state for {where}, "
                                     "which this model trains lazily")
                # a flax file's arrays are read-only views of its mapping
                value = torch.from_numpy(value if value.flags.writeable else value.copy())
                if id(param) in self._shard_ids and value.ndim == param.ndim and \
                        value.shape[0] != param.shape[0]:
                    value = shard_rows(value, self._grid)
                state.setdefault(index[id(param)], {})[slot] = value
        sd = self.optimizer.state_dict()
        self.optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
        if lazy or self._lazy is not None:
            self._set_lazy_state(lazy, reg)
        self._restart_lazy_steps()
        return int(flat["epoch"])

    # ------------------------------------------------- sharded checkpoints

    def _shard_key(self, key: str) -> str:
        """``key`` marked with this rank's shard index: ``...@shard{e}``."""
        return f"{key}@shard{self._grid.embed_index}"

    def _checkpoint_tensors(self, epoch):
        """{key: CPU copy} of the live training state, each rank's own:
        ``params/<path>``, ``batch_stats/<path>``,
        ``opt_state/<path>/<slot>``, a lazy group's state columns
        ``lazy/<first member's path>``, tracked sum(w^2) ``lazy_reg/<path>``
        and step ``lazy_t``, ``epoch``; a row shard's path ends in
        ``@shard{e}``.  The copies are taken now, so training may go on
        while they are written."""
        paths = canonical_paths(self.module)
        out = {}

        def put(key, t, sharded):
            out[self._shard_key(key) if sharded else key] = t.detach().to("cpu", copy=True)

        for key, p in self.module.named_parameters():
            put(f"params/{paths[key]}", p, key in self._shards)
        for key, b in self.module.named_buffers():
            put(f"batch_stats/{key.replace('.', '/')}", b, False)
        path_of, _ = self._parameter_paths()
        for param, state in self.optimizer.state.items():
            for slot, value in state.items():
                if torch.is_tensor(value):
                    where = path_of[id(param)]
                    if id(param) in self._shard_ids:
                        where = self._shard_key(where)
                    out[f"opt_state/{where}/{slot}"] = value.detach().to("cpu", copy=True)
        for g in self._lazy["groups"] if self._lazy else ():
            put(f"lazy/{g['members'][0]['path']}", g["array"][:, g["dsum"] :], g.get("sharded"))
        for where, value in (self._lazy["reg"] if self._lazy else {}).items():
            put(f"lazy_reg/{where}", value, False)
        if self._lazy is not None:
            out["lazy_t"] = torch.tensor(self._lazy["t"], dtype=torch.int64)
        out["epoch"] = torch.tensor(epoch, dtype=torch.int64)
        return out

    def _dcp_group(self):
        """(process group, no_dist) for ``torch.distributed.checkpoint``."""
        if self._grid is None or self._grid.size == 1:
            return None, True
        return self._grid.checkpoint_group, False

    def save_checkpoint_sharded(self, path, epoch=0, block=True):
        """A checkpoint written through ``torch.distributed.checkpoint``
        (``basemodel.py:1977-2017``): each rank writes its own shards (a
        replicated array once, from one rank) and no rank gathers a table.
        It holds the live state of :meth:`_checkpoint_tensors`, the lazy
        arrays' state columns as stored, and restores into an identically
        configured and identically sharded model
        (:meth:`load_checkpoint_sharded`).  The format is the port's own and
        does not read orbax's (``ROADMAP.md``, deliberate deviations).

        ``block=False``: the state is copied to the host now and written in
        the background (``async_save``); training may go on, the snapshot
        stays that of this call.  :meth:`wait_for_checkpoints` (or another
        save) joins it.  Every rank calls it."""
        import torch.distributed.checkpoint as dcp

        if self.optimizer is None:
            raise RuntimeError("compile() before save_checkpoint_sharded()")
        self.wait_for_checkpoints()
        state = self._checkpoint_tensors(epoch)
        group, no_dist = self._dcp_group()
        if block:
            dcp.save(state, checkpoint_id=str(path), process_group=group, no_dist=no_dist)
        elif no_dist:
            # one process: async_save would look for a process group
            import concurrent.futures

            pool = concurrent.futures.ThreadPoolExecutor(1)
            self._checkpoints.append(pool.submit(dcp.save, state, checkpoint_id=str(path),
                                                 no_dist=True))
            pool.shutdown(wait=False)
        else:
            self._checkpoints.append(dcp.async_save(state, checkpoint_id=str(path),
                                                    process_group=group))

    def wait_for_checkpoints(self):
        """Join any in-flight ``save_checkpoint_sharded(block=False)``."""
        while self._checkpoints:
            self._checkpoints.pop(0).result()

    def load_checkpoint_sharded(self, path) -> int:
        """Restore a :meth:`save_checkpoint_sharded` checkpoint into the live
        model: each rank reads only its own shards and the replicated
        arrays.  Returns the saved epoch."""
        import torch.distributed.checkpoint as dcp

        if self.optimizer is None:
            raise RuntimeError("compile() before load_checkpoint_sharded()")
        self.wait_for_checkpoints()
        meta = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
        mine = "" if self._grid is None else "@shard%d" % self._grid.embed_index
        state = {}
        for key, md in meta.items():
            if "@shard" in key and not (mine and (key.endswith(mine) or mine + "/" in key)):
                continue
            state[key] = torch.empty(tuple(md.size), dtype=md.properties.dtype)
        group, no_dist = self._dcp_group()
        dcp.load(state, checkpoint_id=str(path), process_group=group, no_dist=no_dist)
        state = {key.replace(mine, "") if mine else key: t for key, t in state.items()}
        paths = canonical_paths(self.module)
        with torch.no_grad():
            for key, p in self.module.named_parameters():
                p.copy_(state[f"params/{paths[key]}"])
            for key, b in self.module.named_buffers():
                b.copy_(state[f"batch_stats/{key.replace('.', '/')}"])
            for g in self._lazy["groups"] if self._lazy else ():
                g["array"][:, g["dsum"] :] = state[f"lazy/{g['members'][0]['path']}"]
            for where in self._lazy["reg"] if self._lazy else ():
                self._lazy["reg"][where] = state[f"lazy_reg/{where}"].to(self.device)
        if self._lazy is not None:
            self._lazy["t"] = int(state["lazy_t"])
        _, param_at = self._parameter_paths()
        index = {id(p): i for i, p in enumerate(
            p for group_ in self.optimizer.param_groups for p in group_["params"])}
        opt = {}
        for key, value in state.items():
            if key.startswith("opt_state/"):
                where, slot = key[len("opt_state/"):].rsplit("/", 1)
                opt.setdefault(index[id(param_at[where])], {})[slot] = value
        sd = self.optimizer.state_dict()
        self.optimizer.load_state_dict({"state": opt, "param_groups": sd["param_groups"]})
        return int(state["epoch"])
