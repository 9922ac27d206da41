"""Carry weights between the JAX package and the port.

The canonical tree is what the JAX ``BaseModel.get_weights()`` returns:
``{"params": {...nested numpy...}, "batch_stats": {...}}``, e.g.
``params/embedding_dict/table_d10`` or ``params/cin/conv_w_0``.  A port
parameter's name is its JAX path with ``.`` for ``/``, except that a flax
``Dense`` ``kernel`` [in, out] is an ``nn.Linear`` ``weight`` [out, in]
(its transpose) and a flax ``Conv`` ``kernel`` [kh, kw, in, out] an
``nn.Conv2d`` ``weight`` [out, in, kh, kw].  The module decides which
leaves those are (:func:`canonical_paths`): a raw parameter that the JAX
layer names ``kernel`` (PNN's outer-product ``kernel``, a ``ConvSame``
``kernel``) keeps its name and layout.  ``conv_w_i`` keeps its
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


def _dense_weights(module: nn.Module):
    """Keys of the ``nn.Linear`` and ``nn.Conv2d`` weights of ``module``:
    the flax ``Dense`` and ``Conv`` kernels, transposed."""
    return {f"{name}.weight" if name else "weight" for name, m in module.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))}


def _transpose_in(arr: np.ndarray) -> np.ndarray:
    """A flax kernel ([in, out] or [kh, kw, in, out]) in the torch layout."""
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def _transpose_out(arr: np.ndarray) -> np.ndarray:
    """A torch weight ([out, in] or [out, in, kh, kw]) in the flax layout."""
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T


def from_jax_weights(tree, module: nn.Module = None) -> Dict[str, torch.Tensor]:
    """Canonical JAX weight tree -> ``module``'s ``state_dict`` (CPU fp32
    tensors): its ``params`` and its ``batch_stats`` (absent or empty:
    none).  Each leaf goes to the parameter whose :func:`canonical_paths`
    path it is; only an ``nn.Linear`` or ``nn.Conv2d`` weight is renamed
    from ``kernel`` and transposed.  A leaf the module lacks keeps its path
    with ``.`` for ``/``, so ``load_state_dict(strict=True)`` names it.
    Without ``module`` every leaf named ``kernel`` is taken for a flax
    ``Dense`` or ``Conv`` kernel, which holds for layers with no raw
    ``kernel`` parameter."""
    if module is None:
        port_key, dense = {}, None
    else:
        port_key = {path: key for key, path in canonical_paths(module).items()}
        dense = _dense_weights(module)
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in flatten_tree(tree.get(collection) or {}):
            arr = np.asarray(leaf, dtype=np.float32)
            key = port_key.get(path) if collection == "params" else None
            if key is not None:
                flax_kernel = key in dense
            else:
                segs = path.split("/")
                flax_kernel = dense is None and collection == "params" and segs[-1] == "kernel"
                if flax_kernel:
                    segs[-1] = "weight"
                key = ".".join(segs)
            if flax_kernel:
                arr = _transpose_in(arr)
            state[key] = torch.from_numpy(np.array(arr, order="C"))  # a copy
    return state


def canonical_paths(module: nn.Module) -> Dict[str, str]:
    """Port parameter key -> its JAX parameter path (``cin/conv_w_0``,
    ``dnn/linear_0/kernel``...): ``.`` becomes ``/`` and an ``nn.Linear`` or
    ``nn.Conv2d`` ``weight`` is the flax ``kernel``.  Buffers (the
    ``batch_stats``) are left out."""
    dense = _dense_weights(module)
    stats = {name for name, _ in module.named_buffers()}
    paths = {}
    for key in module.state_dict():
        if key in stats:
            continue
        segs = key.split(".")
        if key in dense:
            segs[-1] = "kernel"
        paths[key] = "/".join(segs)
    return paths


def to_jax_weights(module: nn.Module, state: Dict[str, torch.Tensor] = None) -> dict:
    """A port model's module -> the canonical JAX weight tree (numpy): the
    parameters under ``params`` (only the ``nn.Linear`` and ``nn.Conv2d``
    weights transposed), the buffers under ``batch_stats``.  ``state``, if
    given, stands for ``module.state_dict()`` (a row-sharded model's with
    its tables gathered)."""
    paths = canonical_paths(module)
    dense = _dense_weights(module)
    flat, stats = {}, {}
    for key, t in (module.state_dict() if state is None else state).items():
        arr = t.detach().cpu().numpy()
        if key not in paths:
            stats[key.replace(".", "/")] = np.ascontiguousarray(arr)
            continue
        if key in dense:
            arr = _transpose_out(arr)
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
