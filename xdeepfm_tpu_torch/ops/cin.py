"""The CIN layer contraction and its gradient (port of ``xdeepfm_tpu/ops/cin.py``
and of ``cin_pallas_rows``'s ``custom_vjp``).

Reference math (``deepctr/layers/interaction.py:216-224``), per CIN layer on
rows r = (b, d):

    out[r, o] = sum_{h, m} W[o, h*M + m] * h_rows[r, h] * x0_rows[r, m] + b[o]

:func:`cin_rows_contract` is a ``torch.autograd.Function``.  Its forward and
its backward dispatch by device: a CUDA tensor goes to the hand-written
Hopper kernels (``cin_cuda.cin_rows_forward``, ``cin_rows_backward``,
``cin_rows_dw``), a CPU tensor to their plain PyTorch versions.
``backend="torch"`` runs the plain versions on any device, which is how the
kernels are held against them on the card.  db = sum_r g[r] is taken outside
the kernels, as ``cin_pallas.py:392`` does.

On a rank grid (``parallel/``) each rank launches these kernels on the rows
of its own slice of the batch: the JAX kernel wraps itself in ``shard_map``
over the data axis on a mesh (``xdeepfm_tpu/ops/cin.py:36-51``), which one
process per device makes unnecessary.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ._build import fp32_forward
from .cin_cuda import (
    FUSED_MAX_M,
    cin_rows_backward,
    cin_rows_backward_reference,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_reference,
)

# Backward implementation (``cin_pallas.set_backward_impl``): "fused_t" is
# cin_bwd_dx + cin_dw; "legacy" takes dh and dx0 from the forward contraction
# with permuted weights (cin_pallas.py:401-414) and dW from cin_dw.  On the
# TPU "auto" meant fused_t unless its VMEM working set overflowed
# (``_bwd_fused_fits``); a Hopper kernel keeps only a tile in shared memory,
# so that budget has no counterpart and "auto" means fused_t whenever
# cin_bwd_dx takes the shape (M <= FUSED_MAX_M), legacy otherwise.
_BWD_IMPL = "auto"


def set_backward_impl(name: str) -> None:
    global _BWD_IMPL
    if name not in ("auto", "fused_t", "legacy"):
        raise ValueError(f"unknown CIN backward {name!r}")
    _BWD_IMPL = name


def get_backward_impl() -> str:
    return _BWD_IMPL


def _backward(g, h_rows, x0_rows, W, kernel: bool):
    """(dh, dx0, dW) by the selected implementation; ``kernel`` picks the CUDA
    kernels, else their plain versions."""
    O = W.shape[0]
    H = h_rows.shape[1]
    M = x0_rows.shape[1]
    dw = cin_rows_dw if kernel else cin_rows_dw_reference
    if _BWD_IMPL == "fused_t" or (_BWD_IMPL == "auto" and M <= FUSED_MAX_M):
        bwd = cin_rows_backward if kernel else cin_rows_backward_reference
        dh, dx0 = bwd(g, h_rows, x0_rows, W)
        return dh, dx0, dw(g, h_rows, x0_rows)
    fwd = cin_rows_forward if kernel else cin_rows_reference
    W3 = W.reshape(O, H, M)
    # dh[n, h] = sum_{o, m} g[n, o] x0[n, m] W3[o, h, m]: the forward with
    # rows g, x0 and weights [h, o*M + m]; dx0 likewise with h for x0
    w_dh = W3.permute(1, 0, 2).reshape(H, O * M).contiguous()
    w_dx0 = W3.permute(2, 0, 1).reshape(M, O * H).contiguous()
    dh = fwd(g, x0_rows, w_dh, W.new_zeros(H))
    dx0 = fwd(g, h_rows.contiguous(), w_dx0, W.new_zeros(M))
    return dh, dx0, dw(g, h_rows, x0_rows)


class _CinRows(torch.autograd.Function):
    @staticmethod
    @fp32_forward
    def forward(ctx, h_rows, x0_rows, W, b, backend):
        ctx.save_for_backward(h_rows, x0_rows, W)
        ctx.kernel = backend is None and h_rows.device.type == "cuda"
        if ctx.kernel:
            return cin_rows_forward(h_rows, x0_rows, W, b)
        return cin_rows_reference(h_rows, x0_rows, W, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h_rows, x0_rows, W = ctx.saved_tensors
        g = g.contiguous()  # the kernels read g by dense rows
        dh, dx0, dW = _backward(g, h_rows, x0_rows, W, ctx.kernel)
        return dh, dx0, dW, g.sum(0), None


def cin_rows_contract(h_rows, x0_rows, W, b, backend=None):
    """Row-major CIN layer: h_rows [N, H], x0_rows [N, M], W [O, H*M]
    (channel = h*M + m), b [O] -> [N, O], differentiable in all four.
    ``backend``: None (by device) or "torch"."""
    if backend not in (None, "torch"):
        raise ValueError(f"unknown CIN backend {backend!r}")
    return _CinRows.apply(h_rows, x0_rows, W, b, backend)
