"""Carry weights between the JAX package and the port.

The canonical tree is what the JAX ``BaseModel.get_weights()`` returns:
``{"params": {...nested numpy...}, "batch_stats": {...}}``, e.g.
``params/embedding_dict/table_d10`` or ``params/cin/conv_w_0``.  A port
parameter's name is its JAX path with ``.`` for ``/``, except that a flax
``Dense`` ``kernel`` [in, out] is an ``nn.Linear`` ``weight`` [out, in]
(its transpose) and a flax ``Conv`` ``kernel`` [kh, kw, in, out] an
``nn.Conv2d`` ``weight`` [out, in, kh, kw].  ``conv_w_i`` keeps its
[O, H*M] layout, channel h*M + m.  A BatchNorm's running ``mean`` and
``var`` are buffers of the port (``nn.core.BatchNorm``) and leaves of
``batch_stats`` in the tree, under the same path; its ``scale`` and
``bias`` are parameters, untransposed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """("a/b/c", leaf) pairs of a nested dict, depth first in key order."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            yield from flatten_tree(val, path)
        else:
            yield path, val


def unflatten_tree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for seg in parents:
            node = node.setdefault(seg, {})
        node[leaf] = val
    return tree


def from_jax_weights(tree) -> Dict[str, torch.Tensor]:
    """Canonical JAX weight tree -> port ``state_dict`` (CPU fp32 tensors):
    its ``params`` and its ``batch_stats`` (absent or empty: none)."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in flatten_tree(tree.get(collection) or {}):
            segs = path.split("/")
            arr = np.asarray(leaf, dtype=np.float32)
            if collection == "params" and segs[-1] == "kernel":
                segs[-1] = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            state[".".join(segs)] = torch.from_numpy(np.array(arr, order="C"))  # a copy
    return state


def canonical_paths(module: nn.Module) -> Dict[str, str]:
    """Port parameter key -> its JAX parameter path (``cin/conv_w_0``,
    ``dnn/linear_0/kernel``...): ``.`` becomes ``/`` and an ``nn.Linear`` or
    ``nn.Conv2d`` ``weight`` is the flax ``kernel``.  Buffers (the
    ``batch_stats``) are left out."""
    linear_weights = {
        f"{name}.weight" for name, m in module.named_modules()
        if isinstance(m, (nn.Linear, nn.Conv2d))
    }
    stats = {name for name, _ in module.named_buffers()}
    paths = {}
    for key in module.state_dict():
        if key in stats:
            continue
        segs = key.split(".")
        if key in linear_weights:
            segs[-1] = "kernel"
        paths[key] = "/".join(segs)
    return paths


def to_jax_weights(module: nn.Module) -> dict:
    """A port model's module -> the canonical JAX weight tree (numpy): the
    parameters under ``params``, the buffers under ``batch_stats``."""
    paths = canonical_paths(module)
    flat, stats = {}, {}
    for key, t in module.state_dict().items():
        arr = t.detach().cpu().numpy()
        if key not in paths:
            stats[key.replace(".", "/")] = np.ascontiguousarray(arr)
            continue
        if paths[key].endswith("/kernel"):
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        flat[paths[key]] = np.ascontiguousarray(arr)
    return {"params": unflatten_tree(flat), "batch_stats": unflatten_tree(stats)}


def from_jax_lazy_state(opt_state) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """The JAX package's canonical optimizer state
    (``BaseModel._canonical_opt_state()``) -> (lazy row states
    ``{table path: [rows, k * dim] fp32}``, tracked L2 values
    ``{table path: float}``), for ``set_weights``.  Its ``optax`` part, the
    dense optimizer's, is not carried."""
    lazy = {path: np.asarray(st, np.float32)
            for path, st in flatten_tree(opt_state.get("lazy") or {})}
    reg = {path: float(np.asarray(v)) for path, v in flatten_tree(opt_state.get("reg") or {})}
    return lazy, reg
