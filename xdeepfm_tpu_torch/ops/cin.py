"""The CIN layer contraction and its gradient (port of ``xdeepfm_tpu/ops/cin.py``
and of ``cin_pallas_rows``'s ``custom_vjp``).

Reference math (``deepctr/layers/interaction.py:216-224``), per CIN layer on
rows r = (b, d):

    out[r, o] = sum_{h, m} W[o, h*M + m] * h_rows[r, h] * x0_rows[r, m] + b[o]

:func:`cin_rows_contract` is a ``torch.autograd.Function``.  Its forward and
its backward go to the hand-written Hopper kernels (``cin_cuda.cin_rows_forward``,
``cin_rows_backward``, ``cin_rows_dw``) or to their plain PyTorch versions,
by the backend:

* ``set_cin_backend`` takes the JAX package's names.  ``"auto"`` (the
  default): the kernels on a CUDA tensor, the plain versions on a CPU one.
  ``"pallas"`` and ``"pallas_sm"``: the kernels, and a CPU tensor raises.
  ``"xla"`` and ``"fused"``: the plain fp32 contraction on any device, as
  the JAX package's XLA lowerings compute it.
* A call's ``backend`` argument overrides it; ``"torch"`` runs the kernels'
  plain versions on any device, which is how the kernels are held against
  them on the card.

``set_cin_precision("bf16")`` is ``cin_pallas.set_cin_precision``: the
kernels (and their plain versions) round their operands to bf16 as the TPU
kernel did, with fp32 sums; the ``"xla"`` and ``"fused"`` backends stay
fp32, as the JAX ones do.  db = sum_r g[r] is taken outside the kernels,
as ``cin_pallas.py:392`` does.

On a rank grid (``parallel/``) each rank launches these kernels on the rows
of its own slice of the batch: the JAX kernel wraps itself in ``shard_map``
over the data axis on a mesh (``xdeepfm_tpu/ops/cin.py:36-51``), which one
process per device makes unnecessary, so ``"pallas_sm"`` is ``"pallas"``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..dispatch import bump
from ._build import fp32_forward
from .cin_cuda import (
    FUSED_MAX_M,
    bf16_round,
    cin_rows_backward,
    cin_rows_backward_bf16,
    cin_rows_backward_reference,
    cin_rows_backward_reference_bf16,
    cin_rows_dw,
    cin_rows_dw_reference,
    cin_rows_forward,
    cin_rows_forward_bf16,
    cin_rows_reference,
    cin_rows_reference_bf16,
    cin_rows_round_g_bf16,
)

BACKENDS = ("auto", "xla", "fused", "pallas", "pallas_sm")
_CIN_BACKEND = "auto"
_PRECISION = "f32"


def set_cin_backend(name: str) -> None:
    """The model-wide CIN backend (``xdeepfm_tpu/ops/cin.py:30``): one of
    ``BACKENDS``; see the module's docstring."""
    global _CIN_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown CIN backend {name!r}; expected one of {BACKENDS}")
    if name != _CIN_BACKEND:
        bump()
    _CIN_BACKEND = name


def get_cin_backend() -> str:
    return _CIN_BACKEND


def set_cin_precision(p: str) -> None:
    """``cin_pallas.set_cin_precision``: "f32" (the default) or "bf16" (the
    kernels' operands rounded to bf16, sums in fp32).  A layer's forward
    reads it when it runs; its backward keeps the forward's."""
    global _PRECISION
    if p not in ("f32", "bf16"):
        raise ValueError(f"CIN precision must be 'f32' or 'bf16', got {p!r}")
    if p != _PRECISION:
        bump()
    _PRECISION = p


def get_cin_precision() -> str:
    return _PRECISION

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
    if name != _BWD_IMPL:
        bump()
    _BWD_IMPL = name


def get_backward_impl() -> str:
    return _BWD_IMPL


def _forward_fn(kernel: bool, bf16: bool):
    """The forward: the kernel or its plain version, fp32 or the bf16 mode's
    (looked up when called, so a test can stand in for one)."""
    if bf16:
        return cin_rows_forward_bf16 if kernel else cin_rows_reference_bf16
    return cin_rows_forward if kernel else cin_rows_reference


def _backward_dx_fn(kernel: bool, bf16: bool):
    """The fused backward's dh and dx0, chosen as :func:`_forward_fn`."""
    if bf16:
        return cin_rows_backward_bf16 if kernel else cin_rows_backward_reference_bf16
    return cin_rows_backward if kernel else cin_rows_backward_reference


def _backward(g, h_rows, x0_rows, W, kernel: bool, bf16: bool):
    """(dh, dx0, dW) by the selected implementation; ``kernel`` picks the CUDA
    kernels, else their plain versions, ``bf16`` the bf16 mode's."""
    O = W.shape[0]
    H = h_rows.shape[1]
    M = x0_rows.shape[1]
    dw = cin_rows_dw if kernel else cin_rows_dw_reference
    if _BWD_IMPL == "fused_t" or (_BWD_IMPL == "auto" and M <= FUSED_MAX_M):
        # the fused TPU kernel's dW multiplied the fp32 outer product by its
        # bf16 g^T (cin_pallas.py:226, 260): cin_dw on g rounded to bf16, which
        # on the card the one rounding pass hands to both kernels
        if kernel and bf16:
            gq = cin_rows_round_g_bf16(g)
            dh, dx0 = _backward_dx_fn(kernel, bf16)(gq, h_rows, x0_rows, W)
            return dh, dx0, dw(gq.rounded, h_rows, x0_rows)
        dh, dx0 = _backward_dx_fn(kernel, bf16)(g, h_rows, x0_rows, W)
        return dh, dx0, dw(bf16_round(g) if bf16 else g, h_rows, x0_rows)
    fwd = _forward_fn(kernel, bf16)
    W3 = W.reshape(O, H, M)
    # dh[n, h] = sum_{o, m} g[n, o] x0[n, m] W3[o, h, m]: the forward with
    # rows g, x0 and weights [h, o*M + m]; dx0 likewise with h for x0.  In
    # bf16 the forward rounds g, x0 (or h) and W, as cin_pallas.py:401-414;
    # dW stays fp32 on the raw g (_dw_contract, cin_pallas.py:415-418).
    w_dh = W3.permute(1, 0, 2).reshape(H, O * M).contiguous()
    w_dx0 = W3.permute(2, 0, 1).reshape(M, O * H).contiguous()
    dh = fwd(g, x0_rows, w_dh, W.new_zeros(H))
    dx0 = fwd(g, h_rows.contiguous(), w_dx0, W.new_zeros(M))
    return dh, dx0, dw(g, h_rows, x0_rows)


class _CinRows(torch.autograd.Function):
    @staticmethod
    @fp32_forward
    def forward(ctx, h_rows, x0_rows, W, b, kernel, bf16):
        ctx.save_for_backward(h_rows, x0_rows, W)
        ctx.kernel, ctx.bf16 = kernel, bf16  # the backward keeps the forward's mode
        return _forward_fn(kernel, bf16)(h_rows, x0_rows, W, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h_rows, x0_rows, W = ctx.saved_tensors
        g = g.contiguous()  # the kernels read g by dense rows
        dh, dx0, dW = _backward(g, h_rows, x0_rows, W, ctx.kernel, ctx.bf16)
        return dh, dx0, dW, g.sum(0), None, None


def _route(backend, device):
    """(kernel, bf16 mode) of a call: ``backend`` None reads the global
    switch."""
    be = _CIN_BACKEND if backend is None else backend
    if be in ("xla", "fused"):
        return False, False
    if be == "torch":
        return False, _PRECISION == "bf16"
    if be == "auto":
        return device.type == "cuda", _PRECISION == "bf16"
    if be in ("pallas", "pallas_sm"):
        if device.type != "cuda":
            raise ValueError(f"CIN backend {be!r} runs the CUDA kernels and takes CUDA "
                             f"tensors only, got a tensor on {device}")
        return True, _PRECISION == "bf16"
    raise ValueError(f"unknown CIN backend {be!r}")


def cin_rows_contract(h_rows, x0_rows, W, b, backend=None):
    """Row-major CIN layer: h_rows [N, H], x0_rows [N, M], W [O, H*M]
    (channel = h*M + m), b [O] -> [N, O], differentiable in all four.
    ``backend``: None (the global switch), "torch" or one of ``BACKENDS``."""
    kernel, bf16 = _route(backend, h_rows.device)
    return _CinRows.apply(h_rows, x0_rows, W, b, kernel, bf16)


def cin_layer_contract(h, x0, W, b, backend=None):
    """One CIN layer on feature maps (``xdeepfm_tpu/ops/cin.py:123``):
    h [B, H, D], x0 [B, M, D], W [O, H*M], b [O] -> [B, O, D], through the
    rows path (rows r = (b, d)) under ``backend`` as
    :func:`cin_rows_contract`."""
    B, H, D = h.shape
    M = x0.shape[1]
    out = cin_rows_contract(h.transpose(1, 2).reshape(B * D, H),
                            x0.transpose(1, 2).reshape(B * D, M), W, b, backend)
    return out.reshape(B, D, -1).transpose(1, 2)
