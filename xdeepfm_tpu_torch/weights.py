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


def sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order, as ``jax.tree.map``
    leaves the JAX package's trees (so ``to_bytes`` of equal weights writes
    the JAX package's bytes)."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


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


def canonical_shapes(module: nn.Module, rows: Dict[str, int] = None) -> Dict[str, tuple]:
    """``params/<path>`` and ``batch_stats/<path>`` -> the shape of that leaf
    of the canonical tree of ``module`` (a flax kernel's layout); ``rows``:
    {port key: full rows} of the row-sharded parameters."""
    kernels = _dense_weights(module)
    paths = canonical_paths(module)
    out = {}
    for key, t in module.state_dict().items():
        shape = tuple(t.shape)
        if key not in paths:
            out[f"batch_stats/{key.replace('.', '/')}"] = shape
            continue
        if rows and key in rows:
            shape = (rows[key], *shape[1:])
        if key in kernels:
            shape = (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape[::-1]
        out[f"params/{paths[key]}"] = shape
    return out


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
    return {"params": sorted_tree(unflatten_tree(flat)),
            "batch_stats": sorted_tree(unflatten_tree(stats))}


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


# The dense optimizers' state as optax lays it out (the state of each link of
# the chain ``optax.<name>`` builds, the stateless links as {}) and the port's
# slot for each of its trees
OPTAX_CHAIN = {"adam": 2, "adagrad": 2, "rmsprop": 3, "sgd": 2}
OPTAX_SLOTS = {"adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
               "adagrad": {"sum_of_squares": "sum"}, "rmsprop": {"nu": "nu"}, "sgd": {}}


def _optax_kind(state: dict) -> str:
    """Which of the port's named optimizers wrote an optax state link."""
    if not state:
        return "sgd"
    for name, slots in OPTAX_SLOTS.items():
        if set(state) - {"count"} == set(slots) and ("count" in state) == (name == "adam"):
            return name
    raise ValueError(f"an optimizer state of {sorted(state)} is none of "
                     f"{sorted(OPTAX_SLOTS)}'s")


def from_jax_opt_state(opt_state, module: nn.Module) -> Tuple[str, Dict[str, np.ndarray]]:
    """A restored JAX checkpoint's ``opt_state`` (``xdeepfm_tpu/basemodel.py:1860-1877``)
    -> (the optimizer's name, the port's checkpoint keys): ``opt_state/<path>/<slot>``
    in the port parameter's layout (an ``nn.Linear`` or ``nn.Conv2d`` weight's
    transposed, as :func:`from_jax_weights` does), ``opt_state/lazy/<table
    path>`` ([rows, k * dim] fp32) and ``opt_state/reg/<table path>``.

    The dense part is optax's chain state: ``{"0": {count, mu, nu}, "1": {}}``
    for Adam (``count`` becomes every parameter's ``step``, ``mu`` and ``nu``
    ``exp_avg`` and ``exp_avg_sq``), ``sum_of_squares`` for Adagrad (the
    port's ``sum``), ``nu`` for RMSprop and nothing for SGD; under the lazy
    optimizer it lies at ``optax/inner_states/dense/inner_state``, beside the
    row states ``lazy`` and the tracked sum(w^2) values ``reg``, and the lazy
    tables' entries in it are empty (masked).  The lazy step count is not in
    the file: the JAX engine counts it from ``fit``'s step, which restarts
    at 0 with every ``fit`` call, and ``load_checkpoint`` restarts the
    port's as well."""
    flat: Dict[str, np.ndarray] = {}
    dense = opt_state
    if "optax" in opt_state:
        dense = opt_state["optax"]["inner_states"]["dense"]["inner_state"]
        for kind in ("lazy", "reg"):
            for path, v in flatten_tree(opt_state.get(kind) or {}):
                flat[f"opt_state/{kind}/{path}"] = np.asarray(v, np.float32)
    links = [dense[k] for k in sorted(dense, key=int) if dense[k]]
    if len(links) > 1:
        raise ValueError(f"an optax chain with {len(links)} stateful links")
    state = links[0] if links else {}
    name = _optax_kind(state)
    port_key = {path: key for key, path in canonical_paths(module).items()}
    kernels = _dense_weights(module)
    for tree_name, slot in OPTAX_SLOTS[name].items():
        for path, v in flatten_tree(state[tree_name]):
            key = port_key.get(path)
            if key is None:
                raise ValueError(f"the checkpoint holds optimizer state for {path}, which "
                                 "this model lacks")
            arr = np.asarray(v, np.float32)
            flat[f"opt_state/{path}/{slot}"] = np.ascontiguousarray(
                _transpose_in(arr) if key in kernels else arr)
            if name == "adam" and slot == "exp_avg":
                flat[f"opt_state/{path}/step"] = np.asarray(state["count"], np.float32)
    return name, flat


def to_jax_checkpoint(model, epoch: int = 0) -> dict:
    """The JAX package's checkpoint tree of a port model (``params``,
    ``batch_stats``, ``opt_state`` as :func:`from_jax_opt_state` reads it,
    ``epoch``), for ``serialization.to_bytes``: a file that the JAX
    ``load_checkpoint`` restores.  The model's optimizer must be one of
    OPTAX_CHAIN's names; a parameter with no state yet gets zeros, as optax
    initialises it.  A row-sharded model gathers its tables (collective:
    every rank calls it)."""
    name = model._opt_spec[0]
    if name not in OPTAX_CHAIN:
        raise ValueError(f"no optax state layout for the optimizer {name!r}")
    flat = model._checkpoint_flat(epoch)
    kernels = _dense_weights(model.module)
    path_key = {path: key for key, path in canonical_paths(model.module).items()}
    path_of, _ = model._parameter_paths()
    trees: Dict[str, Dict[str, np.ndarray]] = {t: {} for t in OPTAX_SLOTS[name]}
    count = 0
    for p in (p for group in model.optimizer.param_groups for p in group["params"]):
        path = path_of[id(p)]
        for tree_name, slot in OPTAX_SLOTS[name].items():
            arr = flat.get(f"opt_state/{path}/{slot}")
            if arr is None:
                arr = np.zeros_like(flat[f"params/{path}"])
            elif path_key[path] in kernels:
                arr = _transpose_out(arr)
            trees[tree_name][path] = np.ascontiguousarray(arr, np.float32)
        count = max(count, int(flat.get(f"opt_state/{path}/step", 0)))
    link = {t: unflatten_tree(v) for t, v in trees.items()}
    if name == "adam":
        link = {"count": np.asarray(count, np.int32), **link}
    chain = {"0": link, **{str(i): {} for i in range(1, OPTAX_CHAIN[name])}}
    opt_state = chain
    if model._lazy is not None:
        def part(kind):  # keyed by the whole table path, as the JAX engine keys them
            n = len(f"opt_state/{kind}/")
            return {k[n:]: v for k, v in flat.items() if k.startswith(f"opt_state/{kind}/")}

        opt_state = {"lazy": part("lazy"),
                     "optax": {"inner_states": {"dense": {"inner_state": chain},
                                                "lazy": {"inner_state": {}}}}}
        if model._lazy["split"]:  # the JAX engine tracks sum(w^2) under split only
            opt_state["reg"] = part("reg")
    tree = unflatten_tree({k: v for k, v in flat.items()
                           if k.startswith(("params/", "batch_stats/"))})
    return {"params": sorted_tree(tree["params"]),
            "batch_stats": sorted_tree(tree.get("batch_stats", {})),
            "opt_state": sorted_tree(opt_state), "epoch": int(epoch)}
