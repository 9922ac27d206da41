"""Optimizers (port of ``xdeepfm_tpu/optimizers.py`` and of the optax half of
``xdeepfm_tpu``'s ``basemodel._get_optimizer``).

Dense: ``sgd`` and ``adam`` are ``torch.optim.SGD`` and ``torch.optim.Adam``:
their update math is optax's (Adam's bias-corrected m/(sqrt(v) + eps) is the
same expression).  ``adagrad`` and ``rmsprop`` are not: optax starts
adagrad's accumulator at 0.1 and adds eps inside the square root of both,
where ``torch.optim`` starts at 0 and adds eps outside.  So they are written
here to optax's math.  PyTorch picks its ``foreach`` implementation on CUDA
tensors by default; nothing here asks for ``fused``.

Lazy (row-sparse): the embedding tables' optimizer of
``compile(embedding_optimizer="lazy")``, which updates only the rows a batch
touched (torch calls the idea SparseAdam): untouched rows' moments do not
decay.  The row math is plain functions on [N, D] row blocks; the engine
(``basemodel.py``) gathers the rows, sorts their ids, gives every
occurrence its id's gradient summed over the run (:func:`segment_run_sums`),
runs the row math and writes the rows (:func:`_row_set`), as
:func:`lazy_adam_rows` does.
Lazy Adagrad is not the dense :class:`Adagrad`: its accumulator starts at 0
and eps is added outside the square root (the JAX package's
``lazy_adagrad_row_math``).
"""

from __future__ import annotations

import numpy as np
import torch

from .embeddings import run_prefix_sums


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``: acc starts at ``initial_accumulator_value``;
    acc += g**2; p -= lr * g * rsqrt(acc + eps) where acc > 0."""

    def __init__(self, params, lr=0.01, eps=1e-7, initial_accumulator_value=0.1):
        super().__init__(
            params, dict(lr=lr, eps=eps, initial_accumulator_value=initial_accumulator_value)
        )

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                acc = state["sum"]
                acc.addcmul_(p.grad, p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.add_(scale * p.grad, alpha=-group["lr"])


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (not centered, no momentum): nu starts at 0;
    nu = decay * nu + (1 - decay) * g**2; p -= lr * g * rsqrt(nu + eps)."""

    def __init__(self, params, lr=0.01, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.add_(torch.rsqrt(nu + group["eps"]) * p.grad, alpha=-group["lr"])


def get_optimizer(optimizer, params, lr=None):
    """A name -> the optimizer over ``params`` with the JAX package's defaults
    (``xdeepfm_tpu/basemodel.py:76-89``, themselves the reference's torch
    defaults).  Any other callable is a factory, called with the parameter
    list (e.g. ``torch.optim.SGD`` or ``lambda ps: torch.optim.Adam(ps, 3e-4)``):
    it takes the place of an optax transformation."""
    params = list(params)
    if not isinstance(optimizer, str):
        if not callable(optimizer):
            raise TypeError("optimizer must be a name or a factory of torch.optim.Optimizer")
        return optimizer(params)
    if optimizer == "sgd":
        return torch.optim.SGD(params, lr=0.01 if lr is None else lr)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=1e-3 if lr is None else lr, eps=1e-8)
    if optimizer == "adagrad":
        return Adagrad(params, lr=0.01 if lr is None else lr, eps=1e-10)
    if optimizer == "rmsprop":
        return RMSprop(params, lr=0.01 if lr is None else lr, decay=0.99, eps=1e-8)
    raise NotImplementedError(optimizer)


# ---------------------------------------------------------------------------
# Lazy row-sparse optimizers.  ``t`` is the 1-based step, a host int: the
# bias corrections are fp32 scalars computed on the host, as the JAX
# package's fp32 ``jnp.power`` computes them, so a step needs no device
# scalar and no sync.
# ---------------------------------------------------------------------------


def lazy_adam_init(table: torch.Tensor) -> torch.Tensor:
    """m and v packed side by side: [rows, 2 * dim] zeros."""
    rows, dim = table.shape
    return table.new_zeros(rows, 2 * dim)


def lazy_adam_row_math(p_rows, mv_rows, g_rows, t, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """Adam on row blocks, no table access: ``p_rows`` [N, D], ``mv_rows``
    [N, 2D] (m | v), ``g_rows`` [N, D] -> ``(p_rows_new, mv_rows_new)``."""
    D = p_rows.shape[1]
    m = b1 * mv_rows[:, :D] + (1 - b1) * g_rows
    v = b2 * mv_rows[:, D:] + (1 - b2) * g_rows.square()
    t = np.float32(t)
    bc1 = float(np.float32(1) - np.power(np.float32(b1), t))
    bc2 = float(np.float32(1) - np.power(np.float32(b2), t))
    p_new = p_rows - lr * (m / bc1) / ((v / bc2).sqrt() + eps)
    return p_new, torch.cat([m, v], dim=1)


def lazy_adagrad_init(table: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(table)


def lazy_adagrad_row_math(p_rows, acc_rows, g_rows, t, lr=0.01, eps=1e-10):
    """Adagrad on row blocks (see :func:`lazy_adam_row_math`): the
    accumulator starts at 0 and eps is added outside the square root."""
    del t
    acc = acc_rows + g_rows.square()
    return p_rows - lr * g_rows / (acc.sqrt() + eps), acc


def _row_set(arr: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> None:
    """``arr[ids] = vals`` in place.  Duplicate ids carry identical values
    here (per-occurrence run totals through the same row math), so whichever
    store lands, the row's bits are the same: the write is reproducible
    without a sort or a mask.  The ids lie in ``[0, rows)``."""
    arr.index_put_((ids,), vals)


def _lazy_rows(row_math, p, state, ids, g_rows, t, p_rows=None, **hyper):
    ids = ids.reshape(-1).long()
    safe = ids.clamp(0, p.shape[0] - 1)  # the JAX gathers' mode="clip"
    st_rows = state.index_select(0, safe)
    if p_rows is None:
        p_rows = p.index_select(0, safe)
    p_rows, st_new = row_math(p_rows, st_rows, g_rows, t, **hyper)
    # padding ids (outside the table) are dropped, as JAX's mode="drop"
    # drops them; the engine's ids always lie in the table
    keep = (ids >= 0) & (ids < p.shape[0])
    with torch.no_grad():
        _row_set(p, ids[keep], p_rows[keep])
        _row_set(state, ids[keep], st_new[keep])
    return p, state, p_rows


def lazy_adam_rows(p, state, ids, g_rows, t, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                   p_rows=None):
    """Row-wise Adam on the rows ``ids`` of ``p`` and its state, IN PLACE.
    ``g_rows`` [N, D] holds, for every occurrence of an id, the SUM over all
    of its occurrences (duplicates carry identical values); ``p_rows``, if
    given, the rows' current values in ``ids`` order.  Returns ``(p, state,
    p_rows_new)``, the last the updated rows in ``ids`` order.  Ids outside
    the table (padding) are not written."""
    return _lazy_rows(lazy_adam_row_math, p, state, ids, g_rows, t, p_rows,
                      lr=lr, b1=b1, b2=b2, eps=eps)


def lazy_adagrad_rows(p, state, ids, g_rows, t, lr=0.01, eps=1e-10, p_rows=None):
    """See :func:`lazy_adam_rows`."""
    return _lazy_rows(lazy_adagrad_row_math, p, state, ids, g_rows, t, p_rows, lr=lr, eps=eps)


LAZY_OPTIMIZERS = {
    "adam": (lazy_adam_init, lazy_adam_rows, {"lr": 1e-3}),
    "adagrad": (lazy_adagrad_init, lazy_adagrad_rows, {"lr": 0.01}),
}

# (row math, state width in multiples of the param dim): a lazy group's row
# state is k blocks of its param width side by side (Adam's m | v)
LAZY_ROW_MATH = {
    "adam": (lazy_adam_row_math, 2),
    "adagrad": (lazy_adagrad_row_math, 1),
}


# ---------------------------------------------------------------------------
# bf16 row state for the packed layout: with
# compile(embedding_state_dtype="bfloat16") the k*D state values of a row are
# stored as bf16 pairs in ceil(k*D / 2) fp32 columns of the packed array (the
# param columns stay fp32): half the state's bytes.  The row math still runs
# in fp32; the moments round to bf16 between steps.  The bytes are the JAX
# package's ``bitcast_convert_type`` of the [N, slots, 2] bf16 pairs.
# ---------------------------------------------------------------------------


def _is_bf16(dtype) -> bool:
    if dtype is None or dtype in (torch.float32, "float32"):
        return False
    if dtype in (torch.bfloat16, "bfloat16"):
        return True
    raise ValueError(f"state dtype must be float32 or bfloat16, not {dtype!r}")


def state_slots(k_d: int, dtype) -> int:
    """fp32 columns needed for ``k_d`` state values in ``dtype``."""
    return -(-k_d // 2) if _is_bf16(dtype) else k_d


def encode_state(st: torch.Tensor, dtype) -> torch.Tensor:
    """[N, k_d] fp32 state -> [N, slots] fp32 storage columns."""
    if not _is_bf16(dtype):
        return st
    b = st.to(torch.bfloat16)
    if st.shape[1] % 2:
        b = torch.nn.functional.pad(b, (0, 1))
    return b.contiguous().view(torch.float32)


def decode_state(cols: torch.Tensor, k_d: int, dtype) -> torch.Tensor:
    """[N, slots] fp32 storage columns -> [N, k_d] fp32 state."""
    if not _is_bf16(dtype):
        return cols
    if cols.stride(-1) != 1:
        cols = cols.contiguous()
    return cols.view(torch.bfloat16)[:, :k_d].float()


def segment_run_sums(sorted_vals: torch.Tensor, is_first: torch.Tensor) -> torch.Tensor:
    """Per-occurrence run totals over sorted segments (the JAX package's
    ``segment_run_sums``): every row k in a run (``is_first`` marks each
    run's first row) receives the SUM of the run's values.  [N, D] -> [N, D].
    The JAX version differences an fp32 prefix sum over the whole array
    (error ~sqrt(N) * eps of the prefix); this one sums each run on its own
    in an order fixed by the ids alone
    (:func:`~xdeepfm_tpu_torch.embeddings.run_prefix_sums`), so two
    identical steps give bit-equal sums on the card."""
    run = torch.cumsum(is_first, 0)  # each row's run, counted from 1
    # each run's last row, for every row of the run (a binary search each:
    # a cummax / cummin on the card is a slow one-block scan)
    end = torch.searchsorted(run, run, right=True) - 1
    return run_prefix_sums(sorted_vals, run).index_select(0, end)
