"""Keras-style engine (port of ``xdeepfm_tpu/basemodel.py``; reference
``deepctr/models/basemodel.py``).

``compile`` / ``fit`` / ``evaluate`` / ``predict`` and weights I/O.  The model
runs on a CUDA device unless the caller passes ``device="cpu"``; with no GPU
present, ``device=None`` raises instead of carrying on on the CPU.

Training follows the JAX engine: a sum-reduced masked loss plus the L2
registry over canonical parameter paths, the tail batch padded with row 0
under a zero mask, per-batch metrics on the device, one host sync per epoch.
``fit`` copies its data to the device once and gathers each batch there.

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
from .weights import (
    canonical_paths,
    flatten_tree,
    from_jax_lazy_state,
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
        if gpus is not None and len(gpus) > 1:
            raise NotImplementedError("multi-GPU models arrive with a later port slice")
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
        "split" (one device).

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
        # one device: "auto" is the split gradient (the JAX engine's choice
        # on a single device)
        split = embedding_gradient in ("auto", "split")
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
        l2 * sum(w^2), or a scan of the table (an l1 table, or the
        dense-cotangent mode)."""
        total = torch.zeros((), device=self.device)
        reg = self._lazy["reg"]
        for m in self._lazy_members():
            if m["path"] in reg:
                total += m["l2"] * reg[m["path"]]
                continue
            w = m["param"]
            if m["l1"] > 0:
                total += m["l1"] * w.abs().sum()
            if m["l2"] > 0:
                total += m["l2"] * w.square().sum()
        return total

    def _lazy_blocks(self, batch):
        """The split step's per-occurrence blocks: per group one gather of
        its touched rows (param and state columns), outside autograd; the
        param columns become a leaf whose gradient the model's lookups fill.
        Returns (``batch["_compact"]``, per group (ids, rows, leaf))."""
        compact, saved = {}, []
        for g in self._lazy["groups"]:
            ids = touched_ids(batch, g["entries"])
            rows = g["array"].index_select(0, ids)
            leaf = rows[:, : g["dsum"]].clone().requires_grad_()
            for m in g["members"]:
                compact[m["path"]] = (leaf if len(g["members"]) == 1
                                      else leaf[:, m["off"] : m["off"] + m["dim"]])
            saved.append((ids, rows, leaf))
        return compact, saved

    @torch.no_grad()
    def _lazy_update(self, batch, saved):
        """The lazy row update of every group (``basemodel.py:1008-1183``),
        :func:`~xdeepfm_tpu_torch.optimizers.lazy_adam_rows` on the group's
        array: sort the touched ids, give every occurrence its id's gradient
        summed over the run (``segment_run_sums``), add the L2 / L1 gradient
        of the rows, run the row math and write the rows, each occurrence of
        an id with the same values (``_row_set``).  Split: the gradient is
        the occurrence leaf's; dense: the table's autograd gradient at the
        touched rows."""
        lz = self._lazy
        lz["t"] += 1
        for i, g in enumerate(lz["groups"]):
            dsum, k = g["dsum"], g["k"]
            if lz["split"]:
                ids, rows, leaf = saved[i]
                for m in g["members"]:
                    if m["param"].grad is not None:
                        raise RuntimeError(f"a lookup of {m['path']} bypassed the occurrence "
                                           "block of the split step")
                sids, order = torch.sort(ids, stable=True)
                first = run_first(sids)
                grad = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
                g_rows = segment_run_sums(grad.index_select(0, order), first)
                rows = rows.index_select(0, order)
            else:
                sids, _ = torch.sort(touched_ids(batch, g["entries"]))
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

    def _lazy_state(self):
        """{table path: [rows, k * dim] fp32 row state} in the JAX layout
        (``_canonical_opt_state``, ``basemodel.py:1838-1858``): each group's
        state decoded and sliced per member."""
        out = {}
        for g in self._lazy["groups"] if self._lazy else ():
            R, k, dsum = g["rows"], g["k"], g["dsum"]
            st = decode_state(g["array"][:, dsum:], k * dsum, self._lazy["state_dtype"])
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
            g["array"][:, g["dsum"] :] = encode_state(st, self._lazy["state_dtype"])
        for path in self._lazy["reg"] if self._lazy else ():
            value = reg.get(path)
            param = next(m["param"] for m in self._lazy_members() if m["path"] == path)
            self._lazy["reg"][path] = (
                torch.tensor(float(value), device=self.device) if value is not None
                else _sum_squares(param))

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
        and its outputs are cast back to fp32."""
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
        # dropout masks: one stream per fit, as the JAX engine folds the step
        # number into a key seeded with seed + 1
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
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
                take = idx[i * batch_size : (i + 1) * batch_size]
                total, mv = self._train_step(
                    {k: v.index_select(0, take) for k, v in x_dev.items()},
                    y_dev.index_select(0, take),
                    mask[i * batch_size : (i + 1) * batch_size],
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
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self._restart_lazy_steps()
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
        the device."""
        xb = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        with torch.inference_mode():
            return self.module(xb, training=False)["pred"]

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
        running statistics, ``batch_stats``."""
        return to_jax_weights(self.module)

    def set_weights(self, weights):
        """Load a canonical tree, ``params`` and ``batch_stats``; names and
        shapes must match exactly (a model with BatchNorm needs its
        statistics).  The tables are written in place, so a lazy model's
        group arrays take them and keep their row states.  A tree with
        ``opt_state`` (the JAX package's ``_canonical_opt_state()``) also
        carries its lazy row states and tracked L2 values
        (:func:`from_jax_lazy_state`); without it a lazy model's tracked L2
        values are recomputed from the new tables.  The row states are
        kept."""
        self.module.load_state_dict(from_jax_weights(weights, self.module), strict=True)
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
        ``batch_stats/dnn/bn_0/mean``...)."""
        with open(path, "wb") as f:
            np.savez(f, **self._weights_flat())

    def load_weights(self, path):
        """Reads ``save_weights``' file, or the weights of
        ``save_checkpoint``'s."""
        with np.load(path, allow_pickle=False) as data:
            self.set_weights(self._weights_tree({k: data[k] for k in data.files}))

    def _parameter_paths(self):
        """(canonical path by parameter id, parameter by canonical path)."""
        paths = canonical_paths(self.module)
        named = dict(self.module.named_parameters())
        return {id(p): paths[n] for n, p in named.items()}, {paths[n]: p for n, p in named.items()}

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
        The JAX package's msgpack checkpoints are not read (ROADMAP.md,
        D1)."""
        if self.optimizer is None:
            raise RuntimeError("compile() before save_checkpoint()")
        flat = self._weights_flat()
        path_of, _ = self._parameter_paths()
        for param, state in self.optimizer.state.items():
            for slot, value in state.items():
                if value is not None:
                    value = value.detach().cpu() if torch.is_tensor(value) else value
                    flat[f"opt_state/{path_of[id(param)]}/{slot}"] = np.asarray(value)
        for where, st in self._lazy_state().items():
            flat[f"opt_state/lazy/{where}"] = st.cpu().numpy()
        for where, value in (self._lazy["reg"] if self._lazy else {}).items():
            flat[f"opt_state/reg/{where}"] = np.asarray(value.item(), np.float32)
        flat["epoch"] = np.asarray(epoch, np.int64)
        with open(path, "wb") as f:
            np.savez(f, **flat)

    def load_checkpoint(self, path) -> int:
        """Restore ``save_checkpoint``'s params and optimizer state; returns
        the epoch, for ``fit(initial_epoch=...)``."""
        if self.optimizer is None:
            raise RuntimeError("compile() before load_checkpoint()")
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
        self.set_weights(self._weights_tree(flat))
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
                if id(param_at[where]) not in index:
                    raise ValueError(f"the checkpoint holds dense optimizer state for {where}, "
                                     "which this model trains lazily")
                state.setdefault(index[id(param_at[where])], {})[slot] = torch.from_numpy(value)
        sd = self.optimizer.state_dict()
        self.optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
        if lazy or self._lazy is not None:
            self._set_lazy_state(lazy, reg)
        return int(flat["epoch"])
